"""Build and load the CUDA kernels of tpuvof_torch/csrc.

The sources are compiled with nvcc, one process per source, all at once,
and linked into one shared library with a plain C interface, loaded with
ctypes. The build happens at the first CUDA use,
never at import: a machine without nvcc imports the package and runs the
plain versions. The library's name carries a hash of the sources and the
flags, so an edited source is rebuilt and never served stale.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "build_seconds", "library_built", "build_log"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("predict.cu", "project.cu", "fct_sweep.cu", "fullstep.cu", "fullstep_dma.cu",
            "predict3d.cu", "correct3d.cu", "fct3d.cu", "jacobi3d.cu")
# --fmad=false: no a*b+c is contracted, so the kernels round as their plain
# PyTorch versions do (the f64 bars are 1e-12 and the dam-break flow
# amplifies rounding differences step by step).
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.POINTER(ctypes.c_double)
_PP = ctypes.POINTER(ctypes.c_void_p)
_BLOCK = [_I] * 6  # E0, E1, oi, oj, nx, ny
_VOL = [_I] * 8  # n0, n1, gi_base, gj_base, pencil, nx, ny, nz
_SIGNATURES = {
    "tv_predict": [_P] * 5 + _BLOCK + [_D, _I, _P],
    "tv_project": [_P] * 11 + [_I, _I, _I, _D, _P],
    "tv_fct_sweep": [_P] * 3 + _BLOCK + [_I, _D, _I, _I, _P],
    "tv_fullstep": [_PP, _PP, _P] + _BLOCK + [_I, _I, _D, _D, _D, _D, _I, _I, _P],
    "tv_fullstep_dma": [_PP, _PP, _P] + _BLOCK + [_I, _I, _D, _D, _D, _D, _I, _I, _P],
    "tv_predict3d": [_P] * 9 + _VOL + [_D, _P],
    "tv_correct3d": [_P] * 8 + _VOL + [_D, _P],
    "tv_fct3d": [_P] * 3 + _VOL + [_I, _I, _D, _P],
    "tv_jacobi3d": [_P] * 4 + _VOL + [_I, ctypes.POINTER(_I), _D, _P],
    "tv_predict3d_shape": [_I, _I, ctypes.POINTER(_I)],
    "tv_jacobi3d_shape": [_I, _I, ctypes.POINTER(_I)],
    "tv_jacobi3d_grid": [_I] * 5 + [ctypes.POINTER(_I), _D],
    "tv_fct3d_shape": [_I, _I, ctypes.POINTER(_I)],
    "tv_fullstep_shape": [_I, _I, ctypes.POINTER(_I)],
    "tv_fullstep_dma_shape": [_I, _I, ctypes.POINTER(_I)],
    "tv_project_shape": [_I, _I, ctypes.POINTER(_I)],
    "tv_predict_shape": [_I, _I, ctypes.POINTER(_I)],
    "tv_fct_sweep_shape": [_I, _I, _I, ctypes.POINTER(_I)],
}

_lock = threading.Lock()
_lib = None
_build_seconds = None
_built = None
_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to "
                       "build the tpuvof_torch kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> str:
    """Wait for every (command, process); raise on the first failure."""
    log = ""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        log += out + err
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out + err)
    if failed:
        cmd, rc, text = failed
        raise RuntimeError(f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{text}")
    return log


def _compile(target: Path) -> str:
    """One nvcc per source, all started together, then one link."""
    tag = f"{target.stem}.{os.getpid()}"
    objs = [target.with_name(f"{tag}.{Path(s).stem}.o") for s in _SOURCES]
    tmp = target.with_name(f"{tag}.so.tmp")
    nvcc = _nvcc()
    try:
        compiles = []
        for src, obj in zip(_SOURCES, objs):
            cmd = [nvcc, *_FLAGS, "-c", "-o", str(obj), str(_CSRC / src)]
            compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.PIPE, text=True)))
        log = _run(compiles)
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        log += _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return log


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use into tpuvof_torch/_build/."""
    global _lib, _build_seconds, _built, _build_log
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        _BUILD.mkdir(exist_ok=True)
        target = _BUILD / f"libtpuvof_kernels_{_digest()}.so"
        built = not target.exists()
        if built:
            _build_log = _compile(target)
        lib = ctypes.CDLL(str(target))
        for stem, argtypes in _SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, stem + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.tv_error_string.argtypes = [ctypes.c_int]
        lib.tv_error_string.restype = ctypes.c_char_p
        lib.tv_fullstep_levels.argtypes = [_I, ctypes.POINTER(_I), _I]
        lib.tv_fullstep_levels.restype = ctypes.c_int
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, "tv_fullstep_dma_scratch" + suffix)
            fn.argtypes = [_I, _I]
            fn.restype = ctypes.c_longlong
        _lib = lib
        _built = built
        _build_seconds = time.perf_counter() - t0
        return lib


def build_seconds() -> float | None:
    """Seconds the first successful load_library() call took: the sources'
    digest, the build where this process made the library, its loading
    and binding. None before the library is loaded."""
    return _build_seconds


def library_built() -> bool | None:
    """Whether this process built the library (False: it loaded one
    already built); None before the library is loaded."""
    return _built


def build_log() -> str:
    """nvcc's output of this process's build ('' when the library was
    already built)."""
    return _build_log
