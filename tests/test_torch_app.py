"""The port's app modules against tpuvof's (tests/test_l4.py's analogs).

Same inputs through both packages: f64 states made by tpuvof (the 24^2
dam break after 10 steps, and a seeded random state whose velocities
sweep the colour tables), carried to the port as numpy arrays. Bars:
- metrics: the banner's lines 2-4 and the frame line character for
  character;
- viz: scalar_view within 1e-15, interp_velocity, arrow_field and
  vector_field_segments exactly, render_frame exactly except at pixels
  whose buf * 255 lies within 1e-9 of an integer (the table index may
  differ by 1 there), which are counted and bounded;
- PNGs: a frame decodes to tpuvof's pixels exactly; the figures tpuvof
  draws with matplotlib (the -s contour, the arrow overlay, the
  optimiser's panels), which the port draws with numpy and PIL, at the
  pixel agreement stated in each test;
- write_vtk byte for byte; checkpoints cross-load both ways, 2-D and 3-D,
  bit for bit in the file's dtype; a port resume of a tpuvof checkpoint
  within 1e-12 of tpuvof's uncut eager run.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

import tpuvof as tv
from tpuvof import io_utils as jio
from tpuvof import metrics as jmetrics
from tpuvof import viz as jviz

import tpuvof_torch as tt
from tpuvof_torch import colormaps, figures, io_utils, metrics, viz
from tpuvof_torch.convert import config_from_tpuvof, grid3d_from_tpuvof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("vof", "u", "v", "vnorm", "vectors")


def f64_init(cfg, ic=1):
    """tpuvof's initial state (float32) in float64."""
    return tv.State(*(a.astype(jax.numpy.float64) for a in tv.init_state(cfg, ic=ic)))


@pytest.fixture(scope="module")
def small_run():
    """tpuvof's test_l4 state (24^2 dam break, 10 steps), in f64, and its
    port counterpart."""
    cfg = tv.SimConfig(grid=tv.Grid2D(24, 24))
    s = tv.simulate(cfg, f64_init(cfg), 10)
    return cfg, s, config_from_tpuvof(cfg), tt.State(*(torch.tensor(np.asarray(a)) for a in s))


@pytest.fixture(scope="module")
def random_run():
    """A seeded f64 state whose scaled velocities cover [-0.2, 1.2]: every
    colour table entry and both clamps."""
    cfg = tv.SimConfig(grid=tv.Grid2D(32, 32))
    rng = np.random.default_rng(12)
    scale = cfg.grid.Lx / 0.2
    F = rng.uniform(-0.1, 1.1, cfg.grid.shape)
    u = rng.uniform(-0.2, 1.2, cfg.grid.shape) * scale
    v = rng.uniform(-0.2, 1.2, cfg.grid.shape) * scale
    p = rng.normal(size=cfg.grid.shape)
    js = tv.State(*(jax.numpy.asarray(a) for a in (F, u, v, p)))
    return cfg, js, config_from_tpuvof(cfg), tt.State(*(torch.tensor(a) for a in (F, u, v, p)))


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


# ---- metrics ----

def test_banner_lines_match_tpuvof(small_run):
    cfg, _, tcfg, _ = small_run
    mine, ref = metrics.banner(tcfg).splitlines(), jmetrics.banner(cfg).splitlines()
    assert mine[1:] == ref[1:]
    assert "tpuvof_torch" in mine[0] and len(mine) == 4


@pytest.mark.parametrize("kind", ["run", "hot", "nan"])
def test_format_frame_matches_tpuvof(small_run, kind):
    """The same state (a CFL warning where hot, [NON-FINITE!] where a NaN
    was put) gives tpuvof's line character for character."""
    cfg, s, tcfg, ts = small_run
    if kind != "run":
        val = 1e4 if kind == "hot" else np.nan
        s = s._replace(u=s.u.at[5, 7].set(val))
        ts = tt.State(*(torch.tensor(np.asarray(a)) for a in s))
    jm = jmetrics.compute_metrics(cfg, s)
    m = tt.compute_metrics(tcfg, ts)
    for name, a, b in zip(m._fields, m, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-12, atol=1e-300, err_msg=name)
    for istep in (10, 12345):
        assert (metrics.format_frame(istep, cfg.num.dt, m, "vof")
                == jmetrics.format_frame(istep, cfg.num.dt, jm, "vof"))
    # the line is a function of the metric values alone
    jm_as = jmetrics.Metrics(*(np.asarray(float(x)) for x in m))
    assert (metrics.format_frame(3, cfg.num.dt, m, "u")
            == jmetrics.format_frame(3, cfg.num.dt, jm_as, "u"))


# ---- viz ----

def test_colour_tables_are_tpuvofs():
    """The baked tables equal matplotlib's sampling, tpuvof's _LUTS."""
    import matplotlib.cm as cm

    for name in colormaps.NAMES:
        want = np.asarray(getattr(cm, name)(np.linspace(0.0, 1.0, 256)))[:, :3]
        assert np.array_equal(colormaps.lut(name), want.astype(np.float32)), name
        assert np.array_equal(colormaps.lut(name), jviz._LUTS[name]), name


@pytest.mark.parametrize("mode", MODES)
def test_scalar_view_matches_tpuvof(small_run, random_run, mode):
    for cfg, s, tcfg, ts in (small_run, random_run):
        got = viz.scalar_view(tcfg, ts, mode).numpy()
        want = np.asarray(jviz.scalar_view(cfg, s, mode))
        assert got.shape == want.shape == (2 * cfg.grid.nx, 2 * cfg.grid.ny)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("mode", MODES)
def test_render_frame_matches_tpuvof(small_run, random_run, mode):
    """Exact RGB, except where buf * 255 lies within 1e-9 of an integer: at
    most 1% of those pixels, each one table entry away."""
    lut = colormaps.lut(viz._MODE_CMAP[mode])
    for cfg, s, tcfg, ts in (small_run, random_run):
        got = viz.render_frame(tcfg, ts, mode)
        assert got.dtype == torch.float32 and got.device == ts.F.device
        got = got.numpy()
        want = np.asarray(jviz.render_frame(cfg, s, mode))
        assert got.shape == want.shape == (2 * cfg.grid.nx, 2 * cfg.grid.ny, 3)
        x = np.clip(np.asarray(jviz.scalar_view(cfg, s, mode)) * 255.0, 0.0, 255.0)
        tie = np.abs(x - np.round(x)) <= 1e-9
        differ = (got != want).any(-1)
        assert not (differ & ~tie).any()
        assert differ.sum() <= max(1, 0.01 * tie.sum())
        for r, c in zip(*np.nonzero(differ)):
            i = [np.nonzero((lut == a[r, c]).all(-1))[0][0] for a in (got, want)]
            assert abs(i[0] - i[1]) <= 1


def test_interp_velocity_and_arrows_exact(small_run, random_run):
    for cfg, s, tcfg, ts in (small_run, random_run):
        V = viz.interp_velocity(tcfg, ts)
        Vj = np.asarray(jviz.interp_velocity(cfg, s))
        assert np.array_equal(V.numpy(), Vj)
        for spacing in (1, 3, 4):
            for a, b in zip(viz.arrow_field(V, spacing), jviz.arrow_field(Vj, spacing)):
                assert np.array_equal(a, b)
            for a, b in zip(viz.vector_field_segments(V, spacing),
                            jviz.vector_field_segments(Vj, spacing)):
                assert np.array_equal(a, b)


# ---- PNG / GIF / VTK ----

@pytest.mark.parametrize("mode", ["vof", "u", "vnorm"])
def test_frame_png_pixels_equal_tpuvof(random_run, tmp_path, mode):
    cfg, s, tcfg, ts = random_run
    rgb = viz.render_frame(tcfg, ts, mode)
    io_utils.save_frame_png(str(tmp_path / "a.png"), rgb)
    jio.save_frame_png(str(tmp_path / "b.png"), np.asarray(jviz.render_frame(cfg, s, mode)))
    a, b = _png(tmp_path / "a.png"), _png(tmp_path / "b.png")
    assert a.shape == b.shape == (64, 64, 4)
    assert np.array_equal(a, b)


def test_arrow_overlay_matches_tpuvof(tmp_path):
    """quiver's arrows at 64^2 (a 128 px frame): pixels 3 or more away
    from any arrow of either image equal tpuvof's, and the arrows' ink
    (pixels darkened by more than 40 of 255) overlaps tpuvof's with an
    intersection over union of at least 0.8 (0.84 measured)."""
    from scipy.ndimage import binary_dilation

    cfg = tv.SimConfig(grid=tv.Grid2D(64, 64))
    s = tv.simulate(cfg, tv.init_state(cfg, ic=1), 100)
    rgb = np.asarray(jviz.render_frame(cfg, s, "vof"))
    arrows = jviz.arrow_field(np.asarray(jviz.interp_velocity(cfg, s)), 4)
    io_utils.save_frame_png(str(tmp_path / "plain.png"), rgb)
    io_utils.save_frame_png(str(tmp_path / "a.png"), rgb, arrows)
    jio.save_frame_png(str(tmp_path / "b.png"), rgb, arrows)
    plain, a, b = (_png(tmp_path / f).astype(int) for f in ("plain.png", "a.png", "b.png"))
    assert a.shape == b.shape == plain.shape
    touched = binary_dilation((a != plain).any(-1) | (b != plain).any(-1), iterations=3)
    assert np.array_equal(a[~touched], b[~touched])
    ink_a, ink_b = (plain - a).max(-1) > 40, (plain - b).max(-1) > 40
    assert (ink_a & ink_b).sum() >= 0.8 * (ink_a | ink_b).sum() > 0


@pytest.mark.parametrize("ic, n, steps", [(1, 24, 10), (3, 32, 40), (2, 64, 200)])
def test_contour_png_matches_tpuvof(tmp_path, ic, n, steps):
    """The -s figure: tpuvof's size, its levels (the locator's), and at
    least 99% of its pixels (99.56-99.66% measured: band edges inside a
    cell, where matplotlib draws a chord and the port reads the field
    bilinearly); every pixel is white or a band colour."""
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n))
    F = np.asarray(tv.simulate(cfg, tv.init_state(cfg, ic=ic), steps).F)
    io_utils.save_contour_png(str(tmp_path / "a.png"), torch.tensor(F), 0.1, 0.1)
    jio.save_contour_png(str(tmp_path / "b.png"), F, 0.1, 0.1)
    a, b = _png(tmp_path / "a.png"), _png(tmp_path / "b.png")
    assert a.shape == b.shape == (500, 500, 4)
    assert (a == b).all(-1).mean() >= 0.99
    assert np.array_equal(np.unique(a.reshape(-1, 4), axis=0),
                          np.unique(b.reshape(-1, 4), axis=0))


def test_contour_levels_match_matplotlib():
    """contour_levels == contourf's default levels on 150 seeded ranges
    (signs, scales 1e-4..1e3, zero ends, near-degenerate spans)."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(3)
    fig = plt.figure()
    try:
        for _ in range(150):
            a, b = rng.uniform(-3, 3, 2) * 10.0 ** rng.integers(-4, 4)
            if rng.random() < 0.2:
                a = 0.0
            if rng.random() < 0.1:
                a = b + 1e-15 * abs(b)
            a, b = sorted((a, b))
            want = fig.gca().contourf(np.array([[a, b], [b, a]])).levels
            fig.clf()
            assert np.array_equal(figures.contour_levels(a, b), want), (a, b)
    finally:
        plt.close(fig)


def test_side_by_side_and_grad_pngs(small_run, tmp_path):
    """Each panel cell shows matplotlib's colour of its value (tpuvof's
    imshow: Blues on [0, 1]; coolwarm on [-max|g|, max|g|]), within one
    8-bit level, under tpuvof's titles."""
    import matplotlib.cm as cm

    cfg, s, _, ts = small_run
    F = ts.F.numpy()
    g = F - 0.5
    io_utils.save_side_by_side_png(str(tmp_path / "sbs.png"), ts.F, ts.F * 0.5)
    io_utils.save_grad_png(str(tmp_path / "grad.png"), torch.tensor(g))
    pad, title, z = figures.PAD, figures.TITLE_PX, io_utils.PANEL_PX // max(F.shape)
    centres = (np.arange(F.shape[0]) * z + z // 2)
    img = _png(tmp_path / "sbs.png")
    for k, field in enumerate((F, F * 0.5)):
        x0 = pad + k * (F.shape[0] * z + pad)
        cells = img[pad + title + centres[::-1]][:, x0 + centres, :3]  # rows: y downward
        want = cm.Blues(np.clip(field.T, 0, 1))[..., :3] * 255
        assert np.abs(cells.astype(float) - want).max() <= 1.0
    img = _png(tmp_path / "grad.png")
    cells = img[pad + centres[::-1]][:, pad + centres, :3]
    lim = np.abs(g).max()
    want = cm.coolwarm((g.T + lim) / (2 * lim))[..., :3] * 255
    assert np.abs(cells.astype(float) - want).max() <= 1.0
    jio.save_side_by_side_png(str(tmp_path / "ref.png"), F, F * 0.5)  # tpuvof's, for the eye
    assert os.path.getsize(tmp_path / "ref.png") > 0


def test_gif_assembly_matches_tpuvof(small_run, tmp_path):
    cfg, s, tcfg, ts = small_run
    paths = []
    for i, mode in enumerate(["vof", "u", "vnorm"]):
        p = str(tmp_path / f"{i:03d}-frame.png")
        io_utils.save_frame_png(p, viz.render_frame(tcfg, ts, mode))
        paths.append(p)
    a = io_utils.frames_to_gif(paths[::-1], str(tmp_path / "a.gif"), fps=10)
    b = jio.frames_to_gif(paths, str(tmp_path / "b.gif"), fps=10)
    assert open(a, "rb").read() == open(b, "rb").read()
    import PIL.Image

    assert PIL.Image.open(a).n_frames == 3
    with pytest.raises(ValueError, match="no frames"):
        io_utils.frames_to_gif([], str(tmp_path / "c.gif"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vtk_bytes_equal_tpuvof(tmp_path, dtype):
    rng = np.random.default_rng(5)
    F = torch.tensor(rng.uniform(0, 1, (6, 5, 4)), dtype=dtype)
    p = torch.tensor(rng.normal(size=(6, 5, 4)), dtype=dtype)
    a = io_utils.write_vtk(str(tmp_path / "a"), {"VOF": F, "p": p}, spacing=(0.5, 1.0, 2.0))
    b = jio.write_vtk(str(tmp_path / "b"), {"VOF": F.numpy(), "p": p.numpy()},
                      spacing=(0.5, 1.0, 2.0))
    assert a.endswith(".vtk") and open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="shape"):
        io_utils.write_vtk(str(tmp_path / "c"), {"VOF": F, "p": p[:2]})


# ---- checkpoints ----

@pytest.mark.parametrize("writer", ["port", "tpuvof"])
def test_checkpoint_cross_load_2d(small_run, tmp_path, writer):
    cfg, s, tcfg, ts = small_run
    path = str(tmp_path / "ckpt.npz")
    if writer == "port":
        io_utils.save_checkpoint(path, tcfg, tt.State(*(a.float() for a in ts)), 10)
        want = [a.float().numpy() for a in ts]
    else:
        jio.save_checkpoint(path, cfg, s, 10)
        want = [np.asarray(a) for a in s]
    got, istep, echo = io_utils.load_checkpoint(path, device="cpu")
    jgot, jistep, jecho = jio.load_checkpoint(path)
    assert istep == jistep == 10 and echo == jecho and echo["grid"]["nx"] == 24
    for a, b, w in zip(got, jgot, want):
        assert a.numpy().dtype == w.dtype and a.device.type == "cpu"
        assert np.array_equal(a.numpy(), w) and np.array_equal(np.asarray(b), w)


@pytest.mark.parametrize("writer", ["port", "tpuvof"])
def test_checkpoint_cross_load_3d(tmp_path, writer):
    g = tv.Grid3D(8, 8, 8)
    rng = np.random.default_rng(7)
    fields = [rng.normal(size=g.shape) for _ in range(5)]
    path = str(tmp_path / "ckpt3.npz")
    if writer == "port":
        io_utils.save_checkpoint_3d(path, grid3d_from_tpuvof(g),
                                    tt.State3D(*(torch.tensor(a) for a in fields)), 6)
    else:
        jio.save_checkpoint_3d(path, g, tv.State3D(*(jax.numpy.asarray(a) for a in fields)), 6)
    got, istep, echo = io_utils.load_checkpoint_3d(path, device="cpu")
    jgot, jistep, jecho = jio.load_checkpoint_3d(path)
    assert istep == jistep == 6 and echo == jecho and echo["nx"] == 8
    for a, b, w in zip(got, jgot, fields):
        assert a.dtype == torch.float64
        assert np.array_equal(a.numpy(), w) and np.array_equal(np.asarray(b), w)


def test_resume_tpuvof_checkpoint_2d(tmp_path):
    """tpuvof writes a checkpoint at 10 steps, the port resumes it for 4 on
    'torch'; within 1e-12 of tpuvof's uncut 14 steps, both eager."""
    cfg = tv.SimConfig(grid=tv.Grid2D(24, 24))
    path = str(tmp_path / "ckpt.npz")
    with jax.disable_jit():
        s10 = tv.simulate(cfg, f64_init(cfg), 10)
        jio.save_checkpoint(path, cfg, s10, 10)
        uncut = tv.simulate(cfg, f64_init(cfg), 14)
    state, istep, _ = io_utils.load_checkpoint(path, device="cpu")
    assert state.F.dtype == torch.float64
    tcfg = config_from_tpuvof(cfg).replace(num=tt.Numerics(backend="torch"))
    cont = tt.simulate(tcfg, state, 4, istep0=istep)
    for a, b in zip(cont, uncut):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_resume_tpuvof_checkpoint_3d(tmp_path):
    """The same at 16^3: tpuvof's checkpoint at 3 steps, the port's 3 more
    against tpuvof's uncut 6 (the istep % 3 rotation carried by istep0)."""
    g = tv.Grid3D(16, 16, 16)
    path = str(tmp_path / "ckpt3.npz")
    s0 = tv.State3D(*(a.astype(jax.numpy.float64) for a in tv.init_state_3d(g, ic=1)))
    with jax.disable_jit():
        jio.save_checkpoint_3d(path, g, tv.simulate_3d(g, s0, 3), 3)
        uncut = tv.simulate_3d(g, s0, 6)
    state, istep, _ = io_utils.load_checkpoint_3d(path, device="cpu")
    assert state.F.dtype == torch.float64
    cont = tt.simulate_3d(grid3d_from_tpuvof(g), state, 3, backend="torch", istep0=istep)
    for a, b in zip(cont, uncut):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12 * scale)


# ---- paint, live, profiling, imports ----

def test_paint_canvas_matches_tpuvof():
    from tpuvof.paint import PaintCanvas as JCanvas

    from tpuvof_torch.paint import PaintCanvas, paint_interactively

    rng = np.random.default_rng(9)
    for stamp in (2, 10):
        a, b = PaintCanvas(tt.Grid2D(20, 20), stamp), JCanvas(tv.Grid2D(20, 20), stamp)
        for x, y in [(0.5, 0.5), (0.0, 0.0), (1.0, 1.0)] + list(rng.uniform(0, 1, (10, 2))):
            a.stamp_at(x, y)
            b.stamp_at(x, y)
            assert np.array_equal(a.F, b.F)
    c = PaintCanvas(tt.Grid2D(20, 20), stamp=2)
    c.stamp_at(0.5, 0.5)
    c.stamp_at(0.0, 0.0)
    assert c.F[10, 10] == 1.0 and c.F[9, 9] == 1.0 and c.F.sum() == 16 + 4
    import matplotlib

    matplotlib.use("Agg", force=True)
    with pytest.raises(RuntimeError, match="no interactive display"):
        paint_interactively(tt.Grid2D(20, 20))


def test_live_loop_headless_raises(small_run):
    import matplotlib

    matplotlib.use("Agg", force=True)
    from tpuvof_torch.live import live_loop

    _, _, tcfg, ts = small_run
    with pytest.raises(RuntimeError, match="frame stream"):
        live_loop(tcfg, ts, 2, steps_per_frame=1)


def test_make_step_fn_matches_simulate(small_run):
    """The live viewer's engine, stepped with int istep, follows
    simulate's trajectory bit for bit on 'torch'."""
    from tpuvof_torch.solver import _with_bc

    _, _, tcfg, ts = small_run
    cfg = tcfg.replace(num=tt.Numerics(backend="torch"))
    fn = tt.make_step_fn(cfg)
    a = _with_bc(ts)
    b = tt.simulate(cfg, a, 5)
    for istep in range(1, 6):
        a = fn(a, istep)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_profiling_trace(small_run, tmp_path):
    from tpuvof_torch.utils import trace

    _, _, tcfg, ts = small_run
    cfg = tcfg.replace(num=tt.Numerics(backend="torch"))
    with trace(str(tmp_path / "prof")):
        tt.simulate(cfg, ts, 2)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "prof" / files[0]) > 0
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "tv.simulate" for e in events)


def test_app_modules_import_no_jax_nor_matplotlib():
    """The app layer imports neither jax nor tpuvof, and its writers need
    no matplotlib (machines with the card may lack it): a CLI run with
    frames, -s, every view, the arrow overlay, a GIF and a checkpoint,
    with matplotlib made unimportable."""
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import tempfile, tpuvof_torch, tpuvof_torch.cli as cli\n"
        "d = tempfile.mkdtemp()\n"
        "rc = cli.main(['--device', 'cpu', '--backend', 'torch', '--nx', '16', '--steps', '10',"
        " '--frame-every', '2', '-s', '--cycle-views', '--gif', '--checkpoint-every', '10',"
        " '--outdir', d])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuvof'))\n"
        "print(rc, bad); sys.exit(rc or (1 if bad else 0))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
