"""Adam training loops.

Counterpart of the Adam part of gpitch_tpu/models/fit.py.  ``Adam`` is
optax.adam's update (b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0), the
same arithmetic as torch.optim.Adam's multi-tensor path.  It is written out
here because constructing the first torch.optim optimizer of a process
imports torch._dynamo and its dependencies (hundreds of modules), a one-time
cost of seconds that dwarfs a short training run.  The loss recorded at
step i is the loss before update i.  Only trainable Params are optimized;
the others hold tensors that need no gradient.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..core.params import trainable_tensors

__all__ = ["Adam", "fit_adam", "fit_adam_segmented"]


class Adam:
    """Adam over a list of leaf tensors, one multi-tensor launch per stage
    of the update:

        m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2
        p <- p - lr / (1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        grads = [p.grad for p in self.params]
        torch._foreach_lerp_(self.m, grads, 1.0 - self.b1)
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(self.v)
        torch._foreach_div_(denom, math.sqrt(1.0 - self.b2 ** self.t))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.m, denom,
                                value=-self.lr / (1.0 - self.b1 ** self.t))


def fit_adam(model, loss_fn: Callable, num_steps: int,
             learning_rate: float = 0.005):
    """``num_steps`` Adam steps on the model's trainable Params, in place.
    Returns (model, losses (num_steps,) numpy)."""
    return fit_adam_segmented(model, loss_fn, num_steps, learning_rate,
                              segment=num_steps)


def fit_adam_segmented(model, loss_fn: Callable, num_steps: int,
                       learning_rate: float = 0.005, segment: int = 100):
    """fit_adam run as ceil(num_steps / segment) segments with one host fence
    (the losses' copy) at the end of each; the optimizer state threads
    through, so the trajectory equals fit_adam's.  Between fences the
    losses stay on the device.  Returns (model, losses numpy)."""
    params = trainable_tensors(model)
    optimizer = Adam(params, lr=learning_rate)
    out = torch.empty(num_steps, dtype=params[0].dtype, device=params[0].device)
    host = np.empty(num_steps)
    segment = max(1, segment)
    for start in range(0, num_steps, segment):
        stop = min(start + segment, num_steps)
        for i in range(start, stop):
            optimizer.zero_grad()
            loss = loss_fn(model)
            loss.backward()
            optimizer.step()
            out[i] = loss.detach()
        host[start:stop] = out[start:stop].cpu().numpy()
    return model, host
