"""ctypes bindings of the host C++ audio-DSP library (native/audio_dsp.cc).

A copy of gpitch_tpu/native/__init__.py's binding, so the port needs nothing
of the JAX package.  The library is built on demand with ``make -C native``
(g++) and shared with the JAX package; each entry point has a numpy
fallback, and the dispatch between the two is the JAX package's
(``GPITCH_TPU_NATIVE=0`` disables the library), so both packages pick the
same inducing points.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["available", "wav_read", "frame_windows", "overlap_add_native", "find_extrema",
           "load_library"]

_LIB = {"handle": None, "tried": False}
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")


def load_library():
    """Load (building if necessary) libgpitch_dsp.so; None on failure."""
    if _LIB["tried"]:
        return _LIB["handle"]
    _LIB["tried"] = True
    so = os.path.join(_NATIVE_DIR, "libgpitch_dsp.so")
    src = os.path.join(_NATIVE_DIR, "audio_dsp.cc")
    try:
        if not os.path.exists(so) or (
                os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)):
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError):
        return None

    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int64_p = ctypes.POINTER(ctypes.c_int64)
    lib.wav_info.argtypes = [ctypes.c_char_p, c_int64_p,
                             ctypes.POINTER(ctypes.c_int32)]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read.argtypes = [ctypes.c_char_p, c_double_p, ctypes.c_int64,
                             ctypes.c_int64]
    lib.wav_read.restype = ctypes.c_int64
    lib.frame_windows.argtypes = [c_double_p, ctypes.c_int64, ctypes.c_int64,
                                  c_double_p]
    lib.frame_windows.restype = ctypes.c_int64
    lib.overlap_add.argtypes = [c_double_p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int, c_double_p, ctypes.c_int64]
    lib.overlap_add.restype = None
    lib.find_extrema.argtypes = [c_double_p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_double,
                                 ctypes.c_int64, c_int64_p]
    lib.find_extrema.restype = ctypes.c_int64
    _LIB["handle"] = lib
    return lib


def available() -> bool:
    return load_library() is not None


def enabled() -> bool:
    """Whether the audio/init paths dispatch through the native library
    (available, and not disabled with GPITCH_TPU_NATIVE=0)."""
    if os.environ.get("GPITCH_TPU_NATIVE", "1") == "0":
        return False
    return available()


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def wav_read(path: str, start: int = 0, frames: int = -1):
    """(mono float64 samples, fs) via the C++ decoder; raises if unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    total = ctypes.c_int64()
    fs = ctypes.c_int32()
    rc = lib.wav_info(path.encode(), ctypes.byref(total), ctypes.byref(fs))
    if rc != 0:
        raise IOError(f"wav_info failed ({rc}) for {path}")
    n = total.value - start if frames is None or frames < 0 else min(
        frames, total.value - start)
    out = np.empty(max(n, 0), dtype=np.float64)
    got = lib.wav_read(path.encode(), _dp(out), start, n)
    if got < 0:
        raise IOError(f"wav_read failed ({got}) for {path}")
    return out[:got], fs.value


def frame_windows(y, ws: int):
    """(nw, ws) overlap frames with hop (ws - 1) // 2."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    y = np.ascontiguousarray(np.asarray(y).reshape(-1), dtype=np.float64)
    n = y.shape[0]
    hop = (ws - 1) // 2
    nw = max((n - ws) // hop + 1, 0)
    out = np.empty((nw, ws), dtype=np.float64)
    got = lib.frame_windows(_dp(y), n, ws, _dp(out))
    return out[:got]


def overlap_add_native(windows, n: int, squared: bool = False):
    """Hann overlap-add merge (n,) of (nw, ws) windows with hop (ws - 1) // 2
    and flat boundary windows (squared weights with ``squared``), by the
    library, or by audio.windowing's numpy version when it is unavailable."""
    lib = load_library()
    windows = np.ascontiguousarray(np.asarray(windows, dtype=np.float64))
    if lib is None:
        from ..audio.windowing import ola_weights, overlap_add
        w = ola_weights(windows.shape[0], windows.shape[1], squared=squared)
        return overlap_add(windows, n, w)
    out = np.empty(n, dtype=np.float64)
    lib.overlap_add(_dp(windows), windows.shape[0], windows.shape[1], int(squared),
                    _dp(out), n)
    return out


def find_extrema(y, smooth_win: int = 9, energy_win: int = 1600,
                 thres: float = 0.0025, dec: int = 1):
    """Indices of energy-gated signal extrema (init_liv's selection)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    y = np.ascontiguousarray(np.asarray(y).reshape(-1), dtype=np.float64)
    idx = np.empty(y.shape[0], dtype=np.int64)
    got = lib.find_extrema(_dp(y), y.shape[0], smooth_win, energy_win, thres,
                           dec, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return idx[:got]
