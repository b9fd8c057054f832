"""Checkpoint and resume of a long bank optimization.

Counterpart of gpitch_tpu/pipelines/resume.py.  The whole training state
(the window bank and the Adam state: both moments and the step count, which
the bias corrections read) is checkpointed every K steps, and a restart
resumes from the newest checkpoint, so an interrupted and resumed run
equals an uninterrupted one bit for bit.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..core.params import copy_params
from ..models.fit import Adam, AdamSteps
from ..utils.checkpoint import list_checkpoints, load_model, save_model
from .windowed_sgpr import bank_loss

__all__ = ["optimize_bank_resumable"]


def _adam_state(optimizer: Adam) -> dict:
    """The checkpointed Adam state.  The count is the optimizer's 0-d int64
    tensor, which a checkpoint holds as the 0-d int64 array it held when
    the count was a host int: checkpoints of either form load in both."""
    return {"m": tuple(optimizer.m), "v": tuple(optimizer.v), "t": optimizer.t}


def optimize_bank_resumable(bank, num_steps: int, checkpoint_dir: str,
                            checkpoint_every: int = 100,
                            learning_rate: float = 0.01):
    """Adam over the whole bank with a checkpoint of (bank, Adam state)
    every ``checkpoint_every`` steps, resumed from the newest checkpoint in
    ``checkpoint_dir`` when there is one.  The steps are ``AdamSteps``'s
    (one captured step replayed on the card), with ``checkpoint_every`` as
    the segment.  Returns (bank, losses, start_step): ``losses`` covers the
    steps run by this call.  A bank-only checkpoint (the format before the
    Adam state was saved) restores the bank with fresh moments, under a
    RuntimeWarning.  The input bank is unchanged."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    run = AdamSteps(copy_params(bank), bank_loss, max(num_steps, 1), learning_rate)
    done = list_checkpoints(checkpoint_dir)
    start = done[-1] if done else 0
    if start:
        try:
            saved, state = load_model(checkpoint_dir, (bank, _adam_state(run.optimizer)),
                                      step=start)
        except ValueError:
            saved, state = load_model(checkpoint_dir, bank, step=start), None
            warnings.warn(
                "resuming from a checkpoint without the optimizer state: the "
                "Adam moments restart at zero, so the resumed run is NOT "
                "bit-identical to an uninterrupted one", RuntimeWarning, stacklevel=2)
        run.load(saved, 0 if state is None else int(state["t"]))
        if state is not None:
            with torch.no_grad():
                torch._foreach_copy_(run.optimizer.m, list(state["m"]))
                torch._foreach_copy_(run.optimizer.v, list(state["v"]))

    all_losses = []
    at = start
    while at < num_steps:
        chunk = min(checkpoint_every, num_steps - at)
        losses, _ = run.segments(chunk, chunk)               # one host fence
        all_losses.append(losses)
        at += chunk
        save_model(checkpoint_dir, (run.model, _adam_state(run.optimizer)), step=at)
    losses = np.concatenate(all_losses) if all_losses else np.zeros(0)
    return run.result(), losses, start
