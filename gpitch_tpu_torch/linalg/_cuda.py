"""Build and load the port's CUDA kernels.

Each source ``gpitch_tpu_torch/csrc/<name>.cu`` has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so``
at the repository root (git-ignored), at first use, then loaded with
ctypes.  Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "load", "check"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# name -> {C function: argtypes}; every function returns a cudaError_t as int
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "chol": {f"gpitch_chol_{t}": [_P, _P, _P, _L, _I, _P]
             for t in ("f32", "f64")},
    "specmix": {f"gpitch_specmix_{t}": [_P, _P, _P, _P, _P, _P, _P,
                                        _L, _I, _I, _I, _I, _I, _I, _P]
                for t in ("f32", "f64")},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so, src = _library(name), CSRC_DIR / f"{name}.cu"
    return not so.exists() or src.stat().st_mtime > so.stat().st_mtime


def build(names=tuple(SIGNATURES)) -> list[str]:
    """Compile the named kernels that are missing or older than their source,
    one ``nvcc`` process each, all started together.  Returns the names
    built; raises with the compiler's output if one fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu ---\n{out}")
            continue
        os.replace(tmp, _library(n))        # atomic: concurrent builders agree
        (BUILD_DIR / f"{n}.ptxas.txt").write_text(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C side returns
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
