"""Output artifacts and checkpointing (counterpart of tpuvof/io_utils.py).

Reference outputs: PNG frames via matplotlib contourf (2dvof.py:563-571),
per-opt GUI screenshots (diff_vof.py:554), VTK volumes via pyevtk
(3dvof.py:624-627); checkpoints are tpuvof's own superset.

Writers take tensors on any device or numpy arrays (``convert.to_numpy``).
The PNGs are drawn with numpy and PIL (``figures``) at tpuvof's pixel
sizes and in its colours: a frame without arrows decodes to tpuvof's
pixels exactly.
The file formats are tpuvof's key for key: a checkpoint written by either
package loads in the other, and ``write_vtk``'s bytes are tpuvof's for the
same array. Loaders put the arrays on ``device`` in the file's dtype.
"""
from __future__ import annotations

import json
from dataclasses import asdict

import numpy as np
import torch

from . import figures
from .config import SimConfig
from .convert import to_numpy
from .state import State, State3D

__all__ = [
    "save_frame_png",
    "save_contour_png",
    "save_side_by_side_png",
    "save_grad_png",
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_3d",
    "load_checkpoint_3d",
    "frames_to_gif",
    "write_vtk",
]

PANEL_PX = 384  # the side of a side-by-side or gradient panel, at most


def _write_png(path: str, rgba: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgba), "RGBA").save(path, format="png")


def _zoom(shape) -> int:
    return max(1, PANEL_PX // max(shape))


def save_side_by_side_png(path: str, F_current, F_target):
    """The in-optimisation current-vs-target buffer (diff_vof.py:448-454,
    526-554): each field through Blues on [0, 1], side by side under the
    titles tpuvof gives them."""
    panels = [figures.field_panel(to_numpy(f), "Blues", 0.0, 1.0, _zoom(np.shape(f)))
              for f in (F_current, F_target)]
    _write_png(path, figures.labelled_panels(panels, ("current F", "target")))


def save_grad_png(path: str, grad):
    """Gradient-field rendering (test/diff_fct.py:370-375): a diverging
    colormap centred on zero, so the sign structure shows."""
    g = to_numpy(grad)
    lim = np.abs(g).max() or 1.0
    panel = figures.field_panel(g, "coolwarm", -lim, lim, _zoom(g.shape))
    _write_png(path, figures.labelled_panels([panel], ("",)))


def save_frame_png(path: str, rgb, arrows=None):
    """Write an RGB frame (x, y, 3), optionally with the arrow overlay
    (origins, increments in [0, 1]^2), to a PNG of the frame's size."""
    rgb = to_numpy(rgb)
    # frame arrays are (x, y); images are (row=y downward, col=x)
    img = np.transpose(rgb, (1, 0, 2))[::-1]
    rgba = np.empty(img.shape[:2] + (4,), np.uint8)
    rgba[..., :3] = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    rgba[..., 3] = 255
    if arrows is not None:
        begin, incre = arrows
        h, w = img.shape[:2]
        rgba = figures.draw_polygons(rgba, figures.arrow_polygons(begin, incre, w, h))
    _write_png(path, rgba)


def save_contour_png(path: str, F, Lx: float, Ly: float):
    """The reference's -s figure: contourf(F.T, cmap=Blues), figure size
    (5, Ly/Lx*5) inches at 100 dpi, axes off (2dvof.py:563-571)."""
    _write_png(path, figures.contour_image(to_numpy(F), Lx, Ly))


def save_checkpoint(path: str, cfg: SimConfig, state: State, istep: int):
    """npz checkpoint of the state, the step counter and a config echo,
    tpuvof's keys. The echo is ``asdict`` of the port's dataclasses (its
    backend reads 'cuda', 'torch', ...); neither package's loader
    interprets it, and both CLIs check only the grid shape on resume."""
    np.savez_compressed(
        path,
        F=to_numpy(state.F),
        u=to_numpy(state.u),
        v=to_numpy(state.v),
        p=to_numpy(state.p),
        istep=np.int64(istep),
        config=json.dumps(
            {
                "grid": asdict(cfg.grid),
                "fluid": asdict(cfg.fluid),
                "num": asdict(cfg.num),
            }
        ),
    )


def _on(z, key: str, device) -> torch.Tensor:
    return torch.from_numpy(z[key]).to(device)


def load_checkpoint(path: str, device="cuda"):
    """Returns (state, istep, config_dict), the state on ``device`` in the
    file's dtype. The caller decides whether the config matches its own."""
    with np.load(path, allow_pickle=False) as z:
        state = State(*(_on(z, k, device) for k in ("F", "u", "v", "p")))
        return state, int(z["istep"]), json.loads(str(z["config"]))


def save_checkpoint_3d(path: str, g, state, istep: int):
    """3-D twin of save_checkpoint: the five fields, the step counter and
    the grid echo (the reference's 3dvof.py has no restart mechanism)."""
    np.savez_compressed(
        path,
        F=to_numpy(state.F),
        u=to_numpy(state.u),
        v=to_numpy(state.v),
        w=to_numpy(state.w),
        p=to_numpy(state.p),
        istep=np.int64(istep),
        grid=json.dumps(asdict(g)),
    )


def load_checkpoint_3d(path: str, device="cuda"):
    """Returns (State3D, istep, grid_dict), the state on ``device`` in the
    file's dtype; the caller validates the grid against its own."""
    with np.load(path, allow_pickle=False) as z:
        state = State3D(*(_on(z, k, device) for k in ("F", "u", "v", "w", "p")))
        return state, int(z["istep"]), json.loads(str(z["grid"]))


def frames_to_gif(frame_paths, out_path: str, fps: int = 20):
    """Assemble PNG frames, in name order, into a looping GIF (the
    reference README's `ti video`/`ti gif` step, README.md:39-45)."""
    from PIL import Image

    frames = [Image.open(p).convert("P") for p in sorted(frame_paths)]
    if not frames:
        raise ValueError("no frames to assemble")
    frames[0].save(
        out_path,
        save_all=True,
        append_images=frames[1:],
        duration=int(1000 / fps),
        loop=0,
    )
    return out_path


def write_vtk(path: str, point_data: dict, spacing=(1.0, 1.0, 1.0)):
    """Legacy-format VTK STRUCTURED_POINTS volume (binary, big-endian f32),
    byte for byte tpuvof's: ``point_data`` maps field name -> 3-D array
    (tensor or numpy), cast to float32. Equivalent to the reference's
    gridToVTK dump (3dvof.py:624-627)."""
    arrays = {name: np.asarray(to_numpy(a), dtype=np.float32)
              for name, a in point_data.items()}
    nx, ny, nz = next(iter(arrays.values())).shape
    if not path.endswith(".vtk"):
        path = path + ".vtk"
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"tpuvof volume\n")
        f.write(b"BINARY\n")
        f.write(b"DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {nx} {ny} {nz}\n".encode())
        f.write(b"ORIGIN 0 0 0\n")
        f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n".encode())
        f.write(f"POINT_DATA {nx * ny * nz}\n".encode())
        for name, arr in arrays.items():
            if arr.shape != (nx, ny, nz):
                raise ValueError(f"field {name} shape {arr.shape} != {(nx, ny, nz)}")
            f.write(f"SCALARS {name} float 1\n".encode())
            f.write(b"LOOKUP_TABLE default\n")
            # VTK wants x varying fastest; arrays are indexed [x, y, z]
            f.write(arr.transpose(2, 1, 0).astype(">f4").tobytes())
            f.write(b"\n")
    return path
