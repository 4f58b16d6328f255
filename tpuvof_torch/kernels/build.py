"""Build and load the CUDA kernels of tpuvof_torch/csrc.

The sources are compiled with nvcc into one shared library with a plain C
interface and loaded with ctypes. The build happens at the first CUDA use,
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

__all__ = ["load_library", "build_seconds", "build_log"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("predict.cu", "project.cu", "fct_sweep.cu")
# --fmad=false: no a*b+c is contracted, so the kernels round as their plain
# PyTorch versions do (the f64 bars are 1e-12 and the dam-break flow
# amplifies rounding differences step by step).
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "tv_predict": [_P, _P, _P, _P, _P, _P, _I, _I, _D, _P],
    "tv_project": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _P],
    "tv_fct_sweep": [_P, _P, _P, _I, _I, _I, _D, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
_build_seconds = None
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


def _compile(target: Path) -> str:
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *(str(_CSRC / s) for s in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return res.stdout + res.stderr


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use into tpuvof_torch/_build/."""
    global _lib, _build_seconds, _build_log
    with _lock:
        if _lib is not None:
            return _lib
        _BUILD.mkdir(exist_ok=True)
        target = _BUILD / f"libtpuvof_kernels_{_digest()}.so"
        t0 = time.perf_counter()
        if not target.exists():
            _build_log = _compile(target)
        _build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for stem, argtypes in _SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, stem + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.tv_error_string.argtypes = [ctypes.c_int]
        lib.tv_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def build_seconds() -> float | None:
    """Seconds the first load_library() call took (compile included)."""
    return _build_seconds


def build_log() -> str:
    """nvcc's output of this process's build ('' when the library was
    already built)."""
    return _build_log
