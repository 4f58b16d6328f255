"""python -m tpuvof_torch against python -m tpuvof (tests/test_l4.py's CLI
analogs).

Each run goes through ``cli.main`` in-process on the CPU (``--device cpu
--backend torch``; tpuvof with ``--backend xla``) at tpuvof's own test
sizes, 16^2 and 16^3, each package into its own directory:
- the set of files written equals tpuvof's for the same flags (frames,
  -f.png, checkpoints, resumed numbering, --gif, --view vectors,
  --cycle-views, 3-D VTK and checkpoints, the optimiser's images);
- the final checkpoint equals the port's own ``simulate`` over the same
  steps in one call, bit for bit, with and without --no-cfl-warn (a run
  chunked at frames is one run);
- the options that cannot run exit 2 with a message, and nothing falls
  back to the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

import tpuvof as tv
from tpuvof import cli as jcli
from tpuvof import io_utils as jio

import tpuvof_torch as tt
from tpuvof_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--backend", "torch"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other 3-D port files: torch's threads
    would oversubscribe the cores under the gate's worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_both(tmp_path, flags, sub=""):
    """Run tpuvof's and the port's CLI with ``flags``; return the sets of
    files each wrote into tmp_path/{tpuvof,port}/sub."""
    out = {}
    for name, main, extra in (("tpuvof", jcli.main, ["--backend", "xla"]),
                              ("port", cli.main, CPU)):
        d = os.path.join(str(tmp_path), name, sub)
        assert main(flags + extra + ["--outdir", d]) == 0, name
        out[name] = set(os.listdir(d))
    return out["port"], out["tpuvof"]


@pytest.mark.parametrize("flags", [
    ["-ic", "1", "--nx", "16", "--steps", "6", "--frame-every", "3", "-s",
     "--checkpoint-every", "6"],
    ["-ic", "2", "--nx", "16", "--steps", "9", "--frame-every", "3", "--gif"],
    ["-ic", "3", "--nx", "16", "--steps", "6", "--frame-every", "3", "--view", "vectors",
     "--gif", "-s"],
    ["--nx", "16", "--steps", "16", "--frame-every", "3", "--cycle-views", "--gif"],
    ["--nx", "16", "--steps", "4", "--frame-every", "2", "--no-frames",
     "--checkpoint-every", "2"],
    ["--three-d", "--nx", "16", "--steps", "4", "--frame-every", "2",
     "--checkpoint-every", "2"],
    ["--case", "translation", "--steps", "4", "--frame-every", "2"],
], ids=["frames-s-ckpt", "gif", "vectors", "cycle-views", "no-frames", "three-d", "case"])
def test_cli_writes_tpuvofs_files(tmp_path, flags):
    mine, ref = run_both(tmp_path, flags)
    assert mine == ref and mine


def test_cli_resume_continues_numbering_like_tpuvof(tmp_path):
    """A run of 7 steps (frames at 3, 6, 7; checkpoint at 6), then a
    --resume of 5 more: the frame numbers continue from ceil(6/3), in both
    packages, and every file name matches."""
    first = ["--nx", "16", "--steps", "7", "--frame-every", "3", "-s", "--checkpoint-every", "6"]
    mine, ref = run_both(tmp_path, first)
    assert mine == ref and "ckpt_000006.npz" in mine
    for name, main, extra in (("tpuvof", jcli.main, ["--backend", "xla"]),
                              ("port", cli.main, CPU)):
        d = os.path.join(str(tmp_path), name)
        assert main(["--resume", os.path.join(d, "ckpt_000006.npz"), "--nx", "16",
                     "--steps", "5", "--frame-every", "3", "--outdir", d] + extra) == 0
    mine, ref = (set(os.listdir(tmp_path / k)) for k in ("port", "tpuvof"))
    assert mine == ref
    assert {"000002-vof.png", "000003-vof.png", "000002-f.png"} <= mine


@pytest.mark.parametrize("no_cfl", [False, True], ids=["cfl", "no-cfl-warn"])
def test_cli_final_checkpoint_equals_simulate(tmp_path, no_cfl):
    """Nine steps in frame chunks of 3 (simulate_cfl or simulate, a BC at
    each entry) equal one simulate call over nine, bit for bit."""
    rc = cli.main(CPU + ["-ic", "2", "--nx", "16", "--steps", "9", "--frame-every", "3",
                         "--checkpoint-every", "9", "--outdir", str(tmp_path)]
                  + (["--no-cfl-warn"] if no_cfl else []))
    assert rc == 0
    state, istep, echo = tt.io_utils.load_checkpoint(str(tmp_path / "ckpt_000009.npz"), "cpu")
    assert istep == 9 and echo["num"]["backend"] == "torch"
    cfg = tt.dam_break_2d(16, num=tt.Numerics(backend="torch"))
    want = tt.simulate(cfg, tt.init_state(cfg, 2, device="cpu"), 9)
    for a, b in zip(state, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_cli_resumes_tpuvof_checkpoint_in_its_dtype(tmp_path):
    """A tpuvof f64 checkpoint resumes in f64: the port's final checkpoint
    equals simulate from the loaded state, bit for bit, and loads in
    tpuvof."""
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16))
    s = tv.simulate(cfg, tv.State(*(a.astype(jax.numpy.float64)
                                    for a in tv.init_state(cfg, 1))), 4)
    ck = str(tmp_path / "ckpt_000004.npz")
    jio.save_checkpoint(ck, cfg, s, 4)
    out = tmp_path / "out"
    assert cli.main(CPU + ["--resume", ck, "--nx", "16", "--steps", "4", "--frame-every", "2",
                           "--checkpoint-every", "8", "--outdir", str(out)]) == 0
    got, istep, _ = jio.load_checkpoint(str(out / "ckpt_000008.npz"))
    assert istep == 8 and got.F.dtype == jax.numpy.float64
    state, _, _ = tt.io_utils.load_checkpoint(ck, "cpu")
    want = tt.simulate(tt.dam_break_2d(16, num=tt.Numerics(backend="torch")), state, 4,
                       istep0=4)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_cli_three_d_checkpoint_resume_and_vtk(tmp_path):
    """3-D: a 2+2-step resumed run's final checkpoint equals a straight
    4-step run bit for bit, and each VTK payload is F as float32."""
    rc = cli.main(CPU + ["--three-d", "--nx", "16", "--steps", "4", "--frame-every", "2",
                         "--checkpoint-every", "2", "--outdir", str(tmp_path)])
    assert rc == 0
    out2 = tmp_path / "resumed"
    rc = cli.main(CPU + ["--three-d", "--nx", "16", "--steps", "2", "--frame-every", "2",
                         "--no-frames", "--resume", str(tmp_path / "ckpt_000002.npz"),
                         "--checkpoint-every", "2", "--outdir", str(out2)])
    assert rc == 0
    a = np.load(tmp_path / "ckpt_000004.npz")
    b = np.load(out2 / "ckpt_000004.npz")
    for k in ("F", "u", "v", "w", "p"):
        assert np.array_equal(a[k], b[k]), k
    data = open(tmp_path / "step-00004.vtk", "rb").read()
    payload = data.split(b"LOOKUP_TABLE default\n", 1)[1][:-1]
    F = np.frombuffer(payload, ">f4").reshape(18, 18, 18).transpose(2, 1, 0)
    assert np.array_equal(F, a["F"].astype(np.float32))


def test_cli_cfl_warning_matches_tpuvof(tmp_path, capsys):
    """The calm dam break prints no Courant warning; a hot velocity in a
    resumed f64 state prints tpuvof's warning line."""
    assert cli.main(CPU + ["-ic", "1", "--nx", "24", "--steps", "4", "--no-frames",
                           "--outdir", str(tmp_path)]) == 0
    assert "courant" not in capsys.readouterr().err.lower()
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16))
    s = tv.State(*(a.astype(jax.numpy.float64) for a in tv.init_state(cfg, 1)))
    s = s._replace(u=s.u.at[6, 5].set(1e3))
    ck = str(tmp_path / "hot.npz")
    jio.save_checkpoint(ck, cfg, s, 0)
    errs = []
    for main, extra in ((jcli.main, ["--backend", "xla"]), (cli.main, CPU)):
        assert main(["--resume", ck, "--nx", "16", "--steps", "2", "--frame-every", "2",
                     "--no-frames", "--outdir", str(tmp_path)] + extra) == 0
        errs.append(capsys.readouterr().err)
    assert "courant number > 1" in errs[0] and errs[1] == errs[0]


def _hot_ckpt(tmp_path):
    cfg = tv.SimConfig(grid=tv.Grid2D(24, 24))
    path = str(tmp_path / "ckpt.npz")
    jio.save_checkpoint(path, cfg, tv.init_state(cfg, 1), 10)
    return path


@pytest.mark.parametrize("case", ["resume-grid", "csf-2d", "no-card", "cpu-cuda",
                                  "cpu-mono", "mesh-indivisible", "mesh-three-sizes",
                                  "mesh-3d-cpu"])
def test_cli_errors_exit_2(tmp_path, capsys, monkeypatch, case):
    argv = {
        "resume-grid": CPU + ["--resume", _hot_ckpt(tmp_path), "--nx", "64", "--steps", "2"],
        "csf-2d": CPU + ["--csf", "--nx", "16", "--steps", "2"],
        "no-card": ["--nx", "16", "--steps", "2"],
        "cpu-cuda": ["--device", "cpu", "--backend", "cuda", "--nx", "16", "--steps", "2"],
        "cpu-mono": ["--device", "cpu", "--backend", "cuda_mono", "--three-d", "--nx", "16"],
        "mesh-indivisible": CPU + ["--mesh", "3,2", "--nx", "16", "--steps", "2"],
        "mesh-three-sizes": CPU + ["--mesh", "2,2,2", "--nx", "16", "--steps", "2"],
        "mesh-3d-cpu": CPU + ["--three-d", "--mesh", "3", "--nx", "16", "--steps", "2"],
    }[case]
    said = {"resume-grid": "checkpoint grid", "csf-2d": "--csf applies to --three-d",
            "no-card": "--device cpu --backend torch", "cpu-cuda": "--device cpu --backend torch",
            "cpu-mono": "--device cuda", "mesh-indivisible": "not divisible by mesh 3x2",
            "mesh-three-sizes": "use --mesh PX,PY",
            "mesh-3d-cpu": "backend='torch'"}[case]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv + ["--outdir", str(tmp_path / "out")]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and said in err
    assert not os.path.exists(tmp_path / "out" / "000000-vof.png")


def test_cli_mesh_2d_matches_decomp_and_tpuvof(tmp_path):
    """--mesh 2,2 without --three-d on --device cpu --backend torch, from a
    tpuvof f64 checkpoint: the same files as tpuvof's --mesh 2,2 run, and a
    final checkpoint equal to Decomp.simulate bit for bit and to tpuvof's
    at its parity bars, 1e-12 (p 1e-7: its jitted run contracts FMAs, and
    p's scale is ~200)."""
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16))
    ck = str(tmp_path / "ckpt_000000.npz")
    jio.save_checkpoint(ck, cfg, tv.State(*(a.astype(jax.numpy.float64)
                                            for a in tv.init_state(cfg, 1))), 0)
    flags = ["--resume", ck, "--mesh", "2,2", "--nx", "16", "--steps", "6", "--frame-every",
             "6", "-s", "--checkpoint-every", "6"]
    mine, ref = run_both(tmp_path, flags)
    assert mine == ref == {"ckpt_000006.npz", "000000-vof.png", "000000-f.png"}
    got = np.load(tmp_path / "port" / "ckpt_000006.npz")
    want = np.load(tmp_path / "tpuvof" / "ckpt_000006.npz")
    state, _, _ = tt.io_utils.load_checkpoint(ck, "cpu")
    dec = tt.Decomp(tt.dam_break_2d(16, num=tt.Numerics(backend="torch")),
                    tt.make_mesh(devices=[torch.device("cpu")] * 4))
    ours = dec.simulate(state, 6)
    for k, a in zip("Fuvp", ours):
        assert got[k].dtype == np.float64 and np.array_equal(got[k], a.numpy()), k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7 if k == "p" else 1e-12,
                                   err_msg=k)


def test_cli_plan_mesh_prints_tpuvofs_table_format(capsys):
    """--plan-mesh prints tpuvof's table layout (header, one row a mesh
    shape) with the port's engines, 2-D and --three-d, with no device."""
    for extra in ([], ["--three-d"]):
        argv = ["--plan-mesh", "8", "--nx", "64"] + extra
        assert jcli.main(argv) == 0
        ref = capsys.readouterr().out.splitlines()
        assert cli.main(argv) == 0
        mine = capsys.readouterr().out.splitlines()
        assert mine[0] == ref[0] and len(mine) == len(ref)
        assert sorted(line.split()[0] for line in mine[1:]) == sorted(
            line.split()[0] for line in ref[1:])
        assert all(line.split()[1] in ("cuda-full", "cuda-slab", "cuda-pencil", "torch")
                   for line in mine[1:])


def test_cli_three_d_mesh_torch_mg(tmp_path):
    """--three-d --mesh on --backend torch with mg: the run writes its VTK,
    and its checkpoint equals Decomp3D's with the same sor_tol_rel bit for
    bit (the CLI passes sor_tol and sor_tol_rel through)."""
    rc = cli.main(CPU + ["--three-d", "--mesh", "2,2", "--nx", "16", "--steps", "2",
                         "--frame-every", "2", "--pressure-solver", "mg", "--sor-tol-rel",
                         "1e-2", "--checkpoint-every", "2", "--outdir", str(tmp_path)])
    assert rc == 0
    assert os.path.getsize(tmp_path / "step-00002.vtk") > 18**3 * 4
    g = tt.Grid3D(16, 16, 16)
    mesh = tt.make_mesh(devices=[torch.device("cpu")] * 4)
    dec = tt.Decomp3D(g, mesh, backend="torch", pressure_solver="mg", sor_tol_rel=1e-2)
    want = dec.simulate(tt.init_state_3d(g, 1, "cpu"), 2)
    got = np.load(tmp_path / "ckpt_000002.npz")
    for k, b in zip("Fuvwp", want):
        assert np.array_equal(got[k], b.numpy()), k


def test_cli_interactive_surfaces_headless(tmp_path):
    """--paint errors cleanly (rc 2); --live raises, as in tpuvof."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    assert cli.main(CPU + ["--optimize", "1", "--paint", "--nx", "16", "--epochs", "1",
                           "--opt-steps", "4", "--outdir", str(tmp_path)]) == 2
    with pytest.raises(RuntimeError, match="frame stream"):
        cli.main(CPU + ["--live", "--nx", "16", "--steps", "2", "--outdir", str(tmp_path)])


def test_cli_optimize_matches_tpuvof(tmp_path):
    """--optimize 1 at tpuvof's test size: the same files, and F0 within
    f32 rounding of tpuvof's (both runs are f32)."""
    flags = ["--optimize", "1", "--nx", "12", "--opt-steps", "4", "--epochs", "2",
             "--no-frames"]
    mine, ref = run_both(tmp_path, flags)
    assert mine == ref == {"F0_optimized.npy"}
    a, b = (np.load(tmp_path / k / "F0_optimized.npy") for k in ("port", "tpuvof"))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_cli_optimize_view_every_and_images(tmp_path):
    """--view-every writes tpuvof's mid-epoch frames; epoch 0 writes the
    f0 contour, the side-by-side and the gradient image (the files of
    tpuvof's test_cli_optimize_view_every and
    test_cli_optimize_writes_side_by_side)."""
    rc = cli.main(CPU + ["--optimize", "1", "--nx", "12", "--opt-steps", "4", "--epochs", "1",
                         "--view-every", "2", "--lr", "0.05", "--outdir", str(tmp_path)])
    assert rc == 0
    assert set(os.listdir(tmp_path)) == {
        "F0_optimized.npy", "opt-0000-f0.png", "opt-0000-vs-target.png",
        "opt-0000-grad.png", "opt-0000-step00002-vs-target.png",
        "opt-0000-step00004-vs-target.png"}


def test_cli_target_npy(tmp_path):
    tgt = np.zeros((14, 14), np.float32)
    tgt[4:10, 4:10] = 1.0
    path = os.path.join(str(tmp_path), "target.npy")
    np.save(path, tgt)
    rc = cli.main(CPU + ["--target-npy", path, "--nx", "12", "--opt-steps", "3",
                         "--epochs", "1", "--no-frames", "--outdir", str(tmp_path)])
    assert rc == 0 and os.path.exists(tmp_path / "F0_optimized.npy")
    rc = cli.main(CPU + ["--target-npy", path, "--nx", "20", "--opt-steps", "3",
                         "--epochs", "1", "--no-frames", "--outdir", str(tmp_path)])
    assert rc == 2


def test_cli_optimize_case(tmp_path):
    flags = ["--optimize-case", "translation", "--nx", "16", "--opt-steps", "4",
             "--epochs", "2", "--lr", "0.1"]
    mine, ref = run_both(tmp_path, flags)
    assert mine == ref == {"F0_optimized.npy", "F0_optimized.png"}


def test_cli_profile_dir(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert cli.main(CPU + ["--nx", "16", "--steps", "2", "--frame-every", "2", "--no-frames",
                           "--profile-dir", str(prof), "--outdir", str(tmp_path)]) == 0
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    (trace,) = os.listdir(prof)
    assert trace.endswith(".json") and os.path.getsize(prof / trace) > 0


def test_python_m_tpuvof_torch(tmp_path):
    """The package's __main__: banner, frame lines, the closing rate."""
    res = subprocess.run([sys.executable, "-m", "tpuvof_torch"] + CPU
                         + ["--nx", "16", "--steps", "4", "--frame-every", "2",
                            "--outdir", str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith(">>> The PyTorch + CUDA port of tpuvof")
    assert sum(line.startswith(">>> Number of steps:") for line in lines) == 2
    assert "cell-updates/s incl. frame I/O" in lines[-1]
    assert sorted(os.listdir(tmp_path)) == ["000000-vof.png", "000001-vof.png"]
