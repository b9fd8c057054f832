"""Numerics policy and device selection of the PyTorch port.

The JAX package reads its jitter levels from a process-wide x64 flag
(gpitch_tpu/config.py:210-251).  Here they follow the dtype of the tensor
being factored, which gives the same values in both of the JAX package's
contexts: float64 (its CPU tests) and float32 (its accelerator runs).
Importing this module changes no global torch state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["default_jitter", "default_jitter_rel", "NumericsConfig",
           "resolve_device", "numpy_dtype", "DEFAULT_DEVICE"]

DEFAULT_DEVICE = "cuda"


def default_jitter(dtype: torch.dtype) -> float:
    """Absolute diagonal jitter added before a Cholesky: 1e-6 in float64,
    1e-4 in float32."""
    return 1e-6 if dtype == torch.float64 else 1e-4


def default_jitter_rel(dtype: torch.dtype) -> float:
    """Relative jitter (fraction of mean(diag(K))): 0 in float64, 1e-5 in
    float32.  ``linalg.ops.add_jitter`` raises the float32 value to
    ``8e-7 * M`` for large M."""
    return 0.0 if dtype == torch.float64 else 1e-5


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """Per-model numerics override (``jitter=None`` keeps the dtype default)."""

    jitter: float | None = None

    def jitter_value(self, dtype: torch.dtype) -> float:
        return self.jitter if self.jitter is not None else default_jitter(dtype)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device without a card
    raises: nothing moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def numpy_dtype(dtype: torch.dtype):
    if dtype == torch.float64:
        return np.float64
    if dtype == torch.float32:
        return np.float32
    raise ValueError(f"unsupported dtype {dtype}")
