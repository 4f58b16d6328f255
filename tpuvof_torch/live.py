"""Live interactive viewer (counterpart of tpuvof/live.py; the reference's
GUI loop, 2dvof.py:502-561).

A matplotlib window shows the running simulation; key events drive the
reference's runtime controls:

  SPACE  cycle view mode (vof -> u -> v -> vnorm -> vectors)
  p      pause / resume
  q      quit (also closing the window)

Frames render on the state's device (viz.render_frame) and the window
blits them. Stepping goes through solver.make_step_fn, called with the
global step index, so any number of steps can be taken between redraws
with the reference's sweep parity. Headless machines get a RuntimeError
pointing at the frame-stream CLI (python -m tpuvof_torch ... --cycle-views).
"""
from __future__ import annotations

import time

import numpy as np

from .config import SimConfig
from .paint import interactive_pyplot
from .solver import make_step_fn
from .state import State
from .viz import MODES, arrow_field, interp_velocity, render_frame

__all__ = ["live_loop"]


def live_loop(cfg: SimConfig, state: State, n_steps: int,
              steps_per_frame: int = 100, view: str = "vof",
              istep0: int = 0):
    """Run the interactive loop; returns (state, istep) at quit/finish."""
    plt = interactive_pyplot("use the headless frame stream instead "
                             "(python -m tpuvof_torch -ic 1 -s, optionally --cycle-views)")
    step_fn = make_step_fn(cfg)
    ctl = {"mode": MODES.index(view), "paused": False, "quit": False,
           "dirty": False}

    fig, ax = plt.subplots(figsize=(6, 6))
    fig.canvas.manager.set_window_title("tpuvof_torch — SPACE view / p pause / q quit")
    ax.set_axis_off()
    im = ax.imshow(np.zeros((2 * cfg.grid.ny, 2 * cfg.grid.nx, 3)),
                   origin="lower")
    quiv = None

    def on_key(ev):
        if ev.key == " ":
            ctl["mode"] = (ctl["mode"] + 1) % len(MODES)
            ctl["dirty"] = True  # re-render even while paused
            print(f">>> view mode: {MODES[ctl['mode']]}")
        elif ev.key == "p":
            ctl["paused"] = not ctl["paused"]
        elif ev.key == "q":
            ctl["quit"] = True

    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("close_event", lambda ev: ctl.update(quit=True))
    plt.show(block=False)

    istep = istep0
    t0 = time.time()
    while istep < istep0 + n_steps and not ctl["quit"]:
        if ctl["paused"] and not ctl["dirty"]:
            plt.pause(0.05)
            continue
        if not ctl["paused"]:
            # the reference pre-increments istep, so step k runs the
            # parity of istep = k (odd first)
            for _ in range(min(steps_per_frame, istep0 + n_steps - istep)):
                istep += 1
                state = step_fn(state, istep)
        ctl["dirty"] = False  # paused + SPACE: fall through to re-render

        mode = MODES[ctl["mode"]]
        rgb = render_frame(cfg, state, "vof" if mode == "vectors" else mode)
        im.set_data(np.transpose(rgb.cpu().numpy(), (1, 0, 2)))
        if quiv is not None:
            quiv.remove()
            quiv = None
        if mode == "vectors":
            begin, incre = arrow_field(interp_velocity(cfg, state), arrow_spacing=4)
            # frame coords [0,1]^2 -> display pixels (the image is
            # transposed, so frame-x maps to display-x already)
            quiv = ax.quiver(
                begin[:, 0] * 2 * cfg.grid.nx, begin[:, 1] * 2 * cfg.grid.ny,
                incre[:, 0], incre[:, 1], color="red", width=2e-3,
                angles="xy", scale_units="xy", scale=5e-3)
        print(f">>> current step: {istep}, sim time: {istep * cfg.num.dt:.6f}"
              f" s, mode: {mode}, wall: {time.time() - t0:.1f}s")
        fig.canvas.draw_idle()
        plt.pause(1e-3)
    plt.close(fig)
    return state, istep
