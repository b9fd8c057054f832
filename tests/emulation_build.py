"""Builds C++ against the CPU emulation of CUDA (tests/cuda_emulation) with
g++ -std=c++20 -O1, once a worker: the library is kept in the worker's
pytest temp dir under a hash of the source, the emulation header and the
command, so that every module that asks for it after the first loads it
again without a build.  Skips the calling test where no g++ that takes
-std=c++20 is found."""

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import pytest

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"


def emulated_library(tmp_path_factory, source):
    """``source`` (a C++ or CUDA file) built against the emulation header
    into a shared library, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build against the CPU emulation of CUDA")
    source = Path(source)
    flags = ["-std=c++20", "-O1", "-shared", "-fPIC", f"-I{EMULATION}", "-x", "c++"]
    key = hashlib.sha256(source.read_bytes())
    key.update((EMULATION / "cuda_runtime.h").read_bytes())
    key.update(" ".join(flags).encode())
    out = tmp_path_factory.getbasetemp() / f"emulated-{source.stem}-{key.hexdigest()[:16]}.so"
    if not out.exists():
        part = out.with_name(out.name + ".part")
        res = subprocess.run([gxx, *flags, "-o", str(part), str(source)], capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0 and "c++20" in res.stderr:
            pytest.skip(f"g++ does not take -std=c++20: {res.stderr[-300:]}")
        assert res.returncode == 0, res.stderr[-4000:]
        part.rename(out)
    return ctypes.CDLL(str(out))
