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

from ..core.params import copy_params, trainable_tensors
from ..models.fit import Adam
from ..utils.checkpoint import list_checkpoints, load_model, save_model
from .windowed_sgpr import bank_loss

__all__ = ["optimize_bank_resumable"]


def _adam_state(optimizer: Adam) -> dict:
    return {"m": tuple(optimizer.m), "v": tuple(optimizer.v), "t": optimizer.t}


def optimize_bank_resumable(bank, num_steps: int, checkpoint_dir: str,
                            checkpoint_every: int = 100,
                            learning_rate: float = 0.01):
    """Adam over the whole bank with a checkpoint of (bank, Adam state)
    every ``checkpoint_every`` steps, resumed from the newest checkpoint in
    ``checkpoint_dir`` when there is one.  Returns (bank, losses, start_step):
    ``losses`` covers the steps run by this call.  A bank-only checkpoint
    (the format before the Adam state was saved) restores the bank with
    fresh moments, under a RuntimeWarning.  The input bank is unchanged."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    bank = copy_params(bank)
    optimizer = Adam(trainable_tensors(bank), lr=learning_rate)
    done = list_checkpoints(checkpoint_dir)
    start = done[-1] if done else 0
    if start:
        try:
            bank, state = load_model(checkpoint_dir, (bank, _adam_state(optimizer)),
                                     step=start)
        except ValueError:
            bank, state = load_model(checkpoint_dir, bank, step=start), None
            warnings.warn(
                "resuming from a checkpoint without the optimizer state: the "
                "Adam moments restart at zero, so the resumed run is NOT "
                "bit-identical to an uninterrupted one", RuntimeWarning, stacklevel=2)
        optimizer = Adam(trainable_tensors(bank), lr=learning_rate)
        if state is not None:
            optimizer.m, optimizer.v = list(state["m"]), list(state["v"])
            optimizer.t = int(state["t"])

    all_losses = []
    at = start
    while at < num_steps:
        chunk = min(checkpoint_every, num_steps - at)
        losses = []
        for _ in range(chunk):
            optimizer.zero_grad()
            loss = bank_loss(bank)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        at += chunk
        all_losses.append(torch.stack(losses).cpu().numpy())      # the host fence
        save_model(checkpoint_dir, (bank, _adam_state(optimizer)), step=at)
    losses = np.concatenate(all_losses) if all_losses else np.zeros(0)
    return bank, losses, start
