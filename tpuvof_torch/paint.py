"""Interactive target painting (counterpart of tpuvof/paint.py; the
reference's paint.py and diff_vof.py's set_init_by_paint, :188-198).

The reference opens a Taichi GUI and stamps 1-blocks under the cursor while
the left button is held. Here, as in tpuvof, the same workflow runs on a
matplotlib canvas when an interactive backend is available; the stamping
(``PaintCanvas.stamp_at``) is the headless-testable core, diff.paint_blocks'
4x4 semantics at stamp=2 or paint.py's 20x20 at stamp=10. Headless
machines use ``diff.paint_blocks`` or the CLI's --target-npy instead.
"""
from __future__ import annotations

import numpy as np

from .grid import Grid2D

__all__ = ["PaintCanvas", "paint_interactively", "interactive_pyplot"]


class PaintCanvas:
    """Mutable paint buffer with the reference's stamp semantics."""

    def __init__(self, g: Grid2D, stamp: int = 2):
        self.grid = g
        self.stamp = stamp
        self.F = np.zeros(g.shape, np.float32)

    def stamp_at(self, x: float, y: float):
        """Stamp a block of 1s at cursor position (x, y) in [0,1]^2
        (reference set_pixel, diff_vof.py:180-185: int(x*imax) center,
        [-stamp, +stamp) extent, clipped at the edges)."""
        xc = int(x * self.grid.nx)
        yc = int(y * self.grid.ny)
        s = self.stamp
        i0, i1 = max(0, xc - s), min(self.F.shape[0], xc + s)
        j0, j1 = max(0, yc - s), min(self.F.shape[1], yc + s)
        if i1 > i0 and j1 > j0:
            self.F[i0:i1, j0:j1] = 1.0
        return self.F


def interactive_pyplot(headless_hint: str):
    """matplotlib.pyplot on an interactive backend; RuntimeError("no
    interactive display: ...") where there is none, matplotlib itself
    missing included."""
    try:
        import matplotlib
        from matplotlib.backends import BackendFilter, backend_registry
    except ImportError:
        raise RuntimeError(f"no interactive display (matplotlib is not installed): "
                           f"{headless_hint}") from None
    noninteractive = {b.lower() for b in
                      backend_registry.list_builtin(BackendFilter.NON_INTERACTIVE)}
    if matplotlib.get_backend().lower() in noninteractive:
        raise RuntimeError(f"no interactive display: {headless_hint}")
    import matplotlib.pyplot as plt

    return plt


def paint_interactively(g: Grid2D, stamp: int = 2, title: str = "Paint your initial"):
    """Open a matplotlib window; LMB-drag paints, closing the window (or
    pressing escape) finishes. Returns the painted (nx+2, ny+2) float32
    array. Raises RuntimeError without an interactive display."""
    plt = interactive_pyplot("paint a target programmatically with "
                             "diff.paint_blocks or pass --target-npy to the CLI")
    canvas = PaintCanvas(g, stamp=stamp)
    fig, ax = plt.subplots()
    fig.canvas.manager.set_window_title(title)
    im = ax.imshow(canvas.F.T, origin="lower", cmap="Blues", vmin=0, vmax=1,
                   extent=[0, 1, 0, 1])
    ax.set_title("drag LMB to paint; close window when done")
    state = {"down": False}

    def on_press(ev):
        if ev.button == 1 and ev.inaxes is ax:
            state["down"] = True
            im.set_data(canvas.stamp_at(ev.xdata, ev.ydata).T)
            fig.canvas.draw_idle()

    def on_release(ev):
        state["down"] = False

    def on_move(ev):
        if state["down"] and ev.inaxes is ax and ev.xdata is not None:
            im.set_data(canvas.stamp_at(ev.xdata, ev.ydata).T)
            fig.canvas.draw_idle()

    def on_key(ev):
        if ev.key == "escape":
            plt.close(fig)

    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show(block=True)
    return canvas.F
