"""The 2-D frame's picture, as ``python -m tpuvof_torch`` draws it by
default: ``viz.render_frame`` of the vof view on the card (2x upsample and
the Blues table), then ``io_utils.save_frame_png`` (the copy to the host
and the PNG encode) into the run's directory. Judged by decoding the file
and comparing each pixel's colour with the reference's picture."""
from __future__ import annotations

import numpy as np

__all__ = ["Frame", "index_gap"]


def index_gap(image: np.ndarray, want_idx: np.ndarray, table: np.ndarray) -> np.ndarray:
    """For each pixel of an (H, W, 3) uint8 ``image``, how many table
    entries its colour lies from the entry the reference picks: 0 where the
    colour is that entry's, 256 where it is no entry's. Equal colours of
    neighbouring entries count as either."""
    codes_t = (table[:, 0].astype(np.int64) << 16) | (table[:, 1].astype(np.int64) << 8) \
        | table[:, 2].astype(np.int64)
    lo, hi = {}, {}
    for k, c in enumerate(codes_t.tolist()):
        lo.setdefault(c, k)
        hi[c] = k
    codes = (image[..., 0].astype(np.int64) << 16) | (image[..., 1].astype(np.int64) << 8) \
        | image[..., 2].astype(np.int64)
    uniq, inv = np.unique(codes, return_inverse=True)
    klo = np.array([lo.get(c, 10**6) for c in uniq.tolist()])[inv].reshape(codes.shape)
    khi = np.array([hi.get(c, -10**6) for c in uniq.tolist()])[inv].reshape(codes.shape)
    gap = np.maximum(0, np.maximum(klo - want_idx, want_idx - khi))
    return np.minimum(gap, 256)


class Frame:
    name = "vof_png"
    numbers = ("png_index_gap",)

    def __init__(self, route, traffic: dict, outdir):
        from tpuvof_torch.io_utils import save_frame_png
        from tpuvof_torch.viz import render_frame

        self._render, self._save = render_frame, save_frame_png
        self.cfg = route.cfg
        self.outdir = outdir

    def run(self, state, istep: int, index: int) -> str:
        from tpuvof_torch.state import State

        path = str(self.outdir / f"{index:06d}-vof.png")
        self._save(path, self._render(self.cfg, State(*state), "vof"))
        return path

    def judge(self, ref, ref_state, sample, path: str) -> dict:
        """``png_index_gap``: the worst pixel's distance, in table entries,
        from the reference's colour; infinite for a picture of the wrong
        size."""
        from PIL import Image

        from portbench.reference.colours import blues

        with Image.open(path) as im:
            image = np.asarray(im.convert("RGB"))
        want = ref.vof_index(ref_state[0])
        if image.shape[:2] != want.shape:
            return {"png_index_gap": float("inf")}
        table = (np.clip(blues(), 0.0, 1.0) * 255).astype(np.uint8)
        return {"png_index_gap": float(index_gap(image, want, table).max())}
