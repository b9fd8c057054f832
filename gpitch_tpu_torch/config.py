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

# the JAX package's names, less those that choose its compiler's behaviour
# (tests/test_torch_tooling.py lists them with the reason); resolve_device,
# numpy_dtype and DEFAULT_DEVICE are the port's own
__all__ = ["default_float", "default_jitter", "default_jitter_rel", "set_jitter",
           "set_jitter_rel", "NumericsConfig", "init_settings"]

DEFAULT_DEVICE = "cuda"

# process-wide overrides of the dtype defaults (None: the dtype's default)
_JITTER = {"value": None}
_JITTER_REL = {"value": None}


def default_float() -> torch.dtype:
    """The active float dtype: torch's default dtype (the JAX package reads
    its x64 flag)."""
    return torch.get_default_dtype()


def default_jitter(dtype: torch.dtype) -> float:
    """Absolute diagonal jitter added before a Cholesky: 1e-6 in float64,
    1e-4 in float32, unless ``set_jitter`` overrides it."""
    if _JITTER["value"] is not None:
        return _JITTER["value"]
    return 1e-6 if dtype == torch.float64 else 1e-4


def set_jitter(value: float | None) -> None:
    """Override the absolute jitter of every dtype (``None`` restores the
    dtype defaults)."""
    _JITTER["value"] = value


def default_jitter_rel(dtype: torch.dtype) -> float:
    """Relative jitter (fraction of mean(diag(K))): 0 in float64, 1e-5 in
    float32, unless ``set_jitter_rel`` overrides it.
    ``linalg.ops.add_jitter`` raises the float32 value to ``8e-7 * M`` for
    large M."""
    if _JITTER_REL["value"] is not None:
        return _JITTER_REL["value"]
    return 0.0 if dtype == torch.float64 else 1e-5


def set_jitter_rel(value: float | None) -> None:
    """Override the relative jitter of every dtype (``None`` restores the
    dtype defaults)."""
    _JITTER_REL["value"] = value


def init_settings(visible_device: str | None = None, interactive: bool = False,
                  run_on_server: bool = True, allow_growth: bool = True):
    """The reference's session bootstrap (it set CUDA_VISIBLE_DEVICES and
    built a TF1 session): returns the visible devices (the CUDA cards, or
    the CPU when there is none) and the dataset root the reference derives
    from ``run_on_server`` ('/import/' or '/').  The other arguments are
    accepted for the same signature and ignored, as the JAX package does."""
    del visible_device, interactive, allow_growth
    path = "/import/" if run_on_server else "/"
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())], path
    return [torch.device("cpu")], path


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
