"""Window-data-parallel and source-parallel distribution over
``torch.distributed`` ranks.

Counterpart of gpitch_tpu/parallel/mesh.py.  The JAX package declares
shardings over a device mesh and lets XLA place the collectives; here each
rank is one process with its own slice, and the collectives are explicit:

* windows (data parallel): the windows of a bank are independent, so each
  rank trains its own slice and only the per-step loss totals and, at the
  end, the trained windows cross ranks (``pipelines.windowed_sgpr.
  optimize_bank(mesh=...)``); ``make_bank_loss_shard_map`` sums the local
  bound over ranks for a caller's own loop;
* sources (model parallel): ModGP's stacked per-source leaves split over
  ranks; the likelihood couples sources only through sums over sources of
  the (N, S) marginals, which are summed over ranks, as the KL terms are.

A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over every
rank of the process group.  ``torch.distributed`` is imported inside the
functions that use it, never when this module is imported.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import torch

from ..core.params import Param, map_params, named_params, trainable_tensors

__all__ = ["make_mesh", "shard_leading_axis", "replicate", "pad_bank_windows",
           "shard_bank", "shard_modgp_sources", "init_multihost",
           "make_bank_loss_shard_map"]


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, backend: str | None = None,
                   timeout_s: float = 300.0) -> bool:
    """Join the process group: ``torch.distributed.init_process_group`` at
    ``coordinator_address`` ('host:port', or any init method URL such as
    'tcp://...' or 'file://...') with ``num_processes`` ranks as rank
    ``process_id``, or from the environment (MASTER_ADDR, WORLD_SIZE,
    RANK) when no address is given.  ``backend``: NCCL when a CUDA card is
    present, else gloo, unless given.  Returns False when no group can
    form (no address and no such environment, or the rendezvous fails
    within ``timeout_s``), as the JAX package's does; True when a group
    exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return False
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except Exception:
        return False
    return True


def make_mesh(n_devices: int | None = None, axis_name: str = "w", devices=None):
    """A 1-D DeviceMesh named ``axis_name`` over the process group's ranks
    (``n_devices`` must be the group's size when given; ``devices`` is
    accepted for the JAX package's signature and ignored).  The mesh's
    device type follows the backend: 'cuda' for NCCL, 'cpu' for gloo."""
    del devices
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_multihost first")
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"a mesh spans every rank: n_devices {n_devices} != "
                         f"world size {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))


def axis_info(mesh, axis_name="w"):
    """(process group, size, this rank's index) of the mesh axis."""
    if not all(hasattr(mesh, a) for a in ("get_group", "size", "get_local_rank")):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), not {mesh!r}")
    names = mesh.mesh_dim_names or ()
    dim = names.index(axis_name) if axis_name in names else 0
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def comm_device(group) -> torch.device:
    """Where a collective's buffers live: the card for NCCL, the host for
    gloo (whose CUDA support covers only some collectives)."""
    import torch.distributed as dist
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def on_host(group) -> bool:
    """Whether the group's collectives run on the host (gloo)."""
    return comm_device(group).type == "cpu"


# The split captures in progress (``models.fit.CapturedSteps``), innermost
# last: each a callable (x, group) -> the tensor that stands for x's sum in
# the graph captured next (see ``_SumOverRanks``).
HOST_POINTS: list = []


class _SumOverRanks(torch.autograd.Function):
    """An all-reduce (sum) whose output every rank holds and differentiates
    alike: the cotangent of each rank's input is the output's own, as for
    JAX's psum under shard_map with a replicated output.
    ``torch.distributed.nn.functional.all_reduce`` would all-reduce the
    cotangent in the backward too, which suits a loss that is the sum of the
    ranks' losses and gives size x the gradient of a replicated one.

    A card tensor under a CUDA graph's capture: NCCL's all-reduce is
    recorded into the graph.  gloo's is host work, which no graph can hold:
    inside a split capture (``HOST_POINTS``) the capture ends here and the
    next graph's starts, and each replay all-reduces on the host between
    the two; any other capture raises."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        if x.is_cuda and on_host(group) and torch.cuda.is_current_stream_capturing():
            if not HOST_POINTS:
                raise RuntimeError("a gloo all-reduce cannot be captured in a CUDA graph: "
                                   "run the step in a split capture (models.fit.CapturedSteps)")
            return HOST_POINTS[-1](x.detach().contiguous(), group)
        buf = x.detach().to(comm_device(group), copy=True).contiguous()
        dist.all_reduce(buf, group=group)
        return buf.to(x.device)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (see
    ``_SumOverRanks``)."""
    return _SumOverRanks.apply(x, group)


def all_over_ranks(flag: torch.Tensor, group) -> torch.Tensor:
    """Whether the 0-d bool ``flag`` holds on every rank of ``group`` (on
    the flag's device; the flag itself where ``group`` is None)."""
    if group is None:
        return flag
    return sum_over_ranks((~flag).to(torch.float32).reshape(1), group)[0] == 0


def source_row_reduce(model):
    """For a ModGP whose sources are split over ranks (``source_group``
    set), ``reduce(x)``: the sums over the ranks of the rows of x (B, D),
    whose columns are the model's trainable leaves in
    ``trainable_tensors`` order.  A replicated leaf (the likelihood's) is
    counted on the group's first rank only, so it enters each sum once, as
    in one process.  None for a model that is not split."""
    group = getattr(model, "source_group", None)
    if group is None:
        return None
    import torch.distributed as dist
    first = dist.get_rank(group) == 0
    keep = torch.cat([torch.full((p.raw.numel(),), first or not name.startswith(".likelihood."),
                                 device=p.raw.device)
                      for name, p in named_params(model) if p.trainable])

    def reduce(x: torch.Tensor) -> torch.Tensor:
        return sum_over_ranks(torch.where(keep, x, 0.0).sum(-1), group)

    return reduce


def _map_tensors(tree, fn):
    """``fn`` over every tensor of a tree of Params (in dataclasses),
    tensors, dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Param) or (dataclasses.is_dataclass(tree)
                                   and not isinstance(tree, type)):
        return map_params(tree, lambda p: Param(fn(p.raw.detach()), p.transform,
                                                p.trainable))
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def shard_leading_axis(tree: Any, mesh, axis_name="w") -> Any:
    """This rank's contiguous slice of every leaf whose leading size divides
    by the mesh axis' size (other leaves stay whole, replicated)."""
    _, size, rank = axis_info(mesh, axis_name)

    def take(x):
        if x.dim() >= 1 and x.shape[0] % size == 0:
            per = x.shape[0] // size
            return x[rank * per:(rank + 1) * per].clone()
        return x

    return _map_tensors(tree, take)


def replicate(tree: Any, mesh) -> Any:
    """A copy of the tree with every leaf broadcast from the mesh's first
    rank."""
    import torch.distributed as dist
    group, _, _ = axis_info(mesh)
    src = dist.get_global_rank(group, 0)
    dev = comm_device(group)

    def bcast(x):
        buf = x.detach().to(dev, copy=True).contiguous()
        dist.broadcast(buf, src=src, group=group)
        return buf.to(x.device)

    return _map_tensors(tree, bcast)


def repeat_last_window(bank, pad: int):
    """The bank with ``pad`` copies of its last window appended."""
    def pad_leaf(p: Param) -> Param:
        x = p.raw.detach()
        return Param(torch.cat([x, x[-1:].repeat((pad,) + (1,) * (x.dim() - 1))]),
                     p.transform, p.trainable)

    return map_params(bank, pad_leaf)


def pad_bank_windows(bank, multiple: int):
    """Pad the window axis of a bank to a multiple of ``multiple`` with
    fully masked copies of the last window; returns (bank, nw).

    A fully masked window adds exactly zero to the collapsed bound and to
    every gradient (every data term carries the mask), so the padding is
    loss-free.  A bank without a mask raises ValueError."""
    nw = bank.X.raw.shape[0]
    pad = -(-nw // multiple) * multiple - nw
    if pad == 0:
        return bank, nw
    if bank.mask is None:
        raise ValueError("pad_bank_windows requires a masked bank "
                         "(build_window_bank(masks=...))")
    padded = repeat_last_window(bank, pad)
    mask = padded.mask.raw.detach().clone()
    mask[nw:] = 0.0
    padded.mask = Param(mask, padded.mask.transform, False)
    return padded, nw


def shard_bank(bank, mesh=None, axis_name: str = "w"):
    """Pad and shard a window bank over the mesh; returns (this rank's
    bank, nw, mesh)."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    _, size, _ = axis_info(mesh, axis_name)
    bank, nw = pad_bank_windows(bank, size)
    return shard_leading_axis(bank, mesh, axis_name), nw, mesh


def make_bank_loss_shard_map(mesh, axis_name="w"):
    """``loss_fn(local_bank)``: the sum of this rank's per-window negative
    bounds, summed over the mesh axis' ranks (one scalar all-reduce, the
    whole communication of the window-parallel scheme).  Differentiable:
    each rank's gradient is that of the total with respect to its own
    windows.  The window axis must divide by the mesh size
    (``pad_bank_windows``, ``shard_bank``)."""
    from ..pipelines.windowed_sgpr import bank_loss
    group, _, _ = axis_info(mesh, axis_name)

    def loss_fn(bank):
        return sum_over_ranks(bank_loss(bank), group)

    return loss_fn


def shard_modgp_sources(model, mesh=None, axis_name: str = "w"):
    """This rank's share of a ModGP's sources: the stacked per-source leaves
    (kernel banks, inducing inputs, q_mu, q_sqrt) split over the mesh
    axis' ranks, the rest (the noise variance) whole.  The returned model's
    loss sums the likelihood's per-source terms and the KL terms over
    ranks, so it equals the whole model's loss on every rank.  With a
    source count that does not divide, the model stays whole.  Returns
    (model, mesh)."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    group, size, rank = axis_info(mesh, axis_name)
    s = model.num_sources
    if s % size:
        return model, mesh
    per = s // size
    sl = slice(rank * per, (rank + 1) * per)

    def take(p: Param) -> Param:
        return Param(p.raw.detach()[sl].clone(), p.transform, p.trainable)

    def kerns(bank, stacked):
        return map_params(bank, take) if stacked else tuple(bank[sl])

    local = dataclasses.replace(
        model, kern_act=kerns(model.kern_act, model.stacked_act),
        kern_com=kerns(model.kern_com, model.stacked_com),
        likelihood=dataclasses.replace(model.likelihood, num_sources=per),
        num_sources=per, source_group=group,
        **{name: take(getattr(model, name)) for name in
           ("za", "zc", "q_mu_act", "q_mu_com", "q_sqrt_act", "q_sqrt_com")})
    return local, mesh


def gather_windows(bank, local, nw: int, group):
    """The whole bank on every rank: ``bank`` (the unsharded input) with its
    trainable leaves replaced by the ranks' ``local`` slices (equal window
    counts, rank order, padding past ``nw`` dropped), in one all-gather."""
    import torch.distributed as dist
    leaves = trainable_tensors(local)
    per = leaves[0].shape[0]
    rows = torch.cat([t.detach().reshape(per, -1) for t in leaves], 1)
    out = gather_rows(rows, group)[:nw].to(leaves[0].device)
    sizes = [t[0].numel() for t in leaves]
    parts = iter(out.split(sizes, 1))
    return map_params(bank, lambda p: Param(
        next(parts).reshape(p.raw.shape).clone() if p.trainable else p.raw.detach().clone(),
        p.transform, p.trainable))


def gather_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (per, D) rows, concatenated in rank order (on the
    collective's device)."""
    import torch.distributed as dist
    buf = rows.to(comm_device(group), copy=True).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts)
