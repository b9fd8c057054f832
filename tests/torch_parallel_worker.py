"""One rank of the port's two-process gloo runs (tests/test_torch_parallel.py).

    python tests/torch_parallel_worker.py <rank> <world> <store file> <out.npz>

Joins the group through a file store (no port), runs every case on the
CPU in f64 and, on rank 0, writes what the test compares into <out.npz>.
The workloads are built here, and the test builds the same ones for the
unsharded runs.  Imports torch and the port only.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

F64 = torch.float64


def tiny_bank(nw=5, ws=64, masks=True):
    """tests/test_parallel.py's _tiny_bank in the port: nw windows of ws
    samples, y = 0.3 N(0, 1) from default_rng(0), every 8th sample an
    inducing point, a Sum of two Matern12sm kernels."""
    from gpitch_tpu_torch.kernels import Matern12sm, Sum
    from gpitch_tpu_torch.pipelines import build_window_bank
    rng = np.random.default_rng(0)
    xw = np.stack([np.linspace(0, 1, ws).reshape(-1, 1) + i for i in range(nw)])
    yw = rng.standard_normal((nw, ws, 1)) * 0.3
    zw = xw[:, ::8]

    def builder():
        return Sum(kern_list=(Matern12sm.create(1.0, 0.2, [1.0], [8.0], dtype=F64),
                              Matern12sm.create(1.0, 0.3, [1.0], [16.0], dtype=F64)))

    return build_window_bank(xw, yw, zw, builder, masks=np.ones((nw, ws)) if masks else None,
                             dtype=F64, device="cpu")


def tiny_sosp():
    """tests/test_parallel.py's _tiny_sosp in the port (f64, CPU)."""
    from gpitch_tpu_torch.pipelines import SoSp
    fs = 16000.0
    t = np.arange(int(0.5 * fs)) / fs
    train = [np.sin(2 * np.pi * f * t) * np.exp(-3 * t) for f in (220.0, 277.2, 329.6)]
    mix_t = np.arange(2201) / fs
    mix = sum(np.sin(2 * np.pi * f * mix_t) * np.exp(-2 * mix_t)
              for f in (220.0, 277.2, 329.6))
    return SoSp(train_signals=train,
                train_names=["piano_M57_train.wav", "piano_M61_train.wav",
                             "piano_M64_train.wav"],
                fs=fs, mixture=(mix_t.reshape(-1, 1), mix), window_size=401,
                kernel_mode="fft", max_par=1, num_inducing=24, dec=4,
                device="cpu", dtype=F64)


def modgp_data(s=8):
    """tests/test_parallel.py's 8-source ModGP (M 6, 32 points), with a
    nonzero target."""
    from gpitch_tpu_torch.kernels import Matern32, MercerMatern12sm
    from gpitch_tpu_torch.models import ModGP
    z = np.linspace(0, 1, 6).reshape(-1, 1)
    kern_act = [Matern32.create(1.0, 1.0, dtype=F64) for _ in range(s)]
    kern_com = [MercerMatern12sm.create(1.0, 0.5, [1.0], [10.0 * (i + 1)], dtype=F64)
                for i in range(s)]
    model = ModGP.create(z=[[z] * s, [z] * s], kern=[kern_act, kern_com], dtype=F64,
                         device="cpu")
    x = np.linspace(0, 1, 32).reshape(-1, 1)
    y = 0.5 * np.sin(2 * np.pi * 10.0 * x)
    return model, torch.as_tensor(x), torch.as_tensor(y)


def trainable_grads(model, loss) -> list:
    from gpitch_tpu_torch.core.params import named_params
    names = [n for n, p in named_params(model) if p.trainable]
    leaves = [p.raw for _, p in named_params(model) if p.trainable]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return names, [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


def main() -> int:
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch.distributed as dist

    from gpitch_tpu_torch.core.params import named_params
    from gpitch_tpu_torch.parallel import (init_multihost, make_bank_loss_shard_map,
                                           make_mesh, shard_bank, shard_modgp_sources)
    from gpitch_tpu_torch.parallel.mesh import gather_rows
    from gpitch_tpu_torch.pipelines import optimize_bank
    torch.set_num_threads(1)
    assert init_multihost(f"file://{store}", world, rank, backend="gloo", timeout_s=60)
    mesh = make_mesh(world)
    group = mesh.get_group()
    res = {}

    # the shard-map loss of a padded, sharded bank and its gradient
    bank = tiny_bank()
    local, nw, _ = shard_bank(bank, mesh)
    loss = make_bank_loss_shard_map(mesh)(local)
    names, grads = trainable_grads(local, loss)
    res["shard_loss"] = loss.detach().numpy()
    for n, g in zip(names, grads):
        res[f"shard_grad{n}"] = gather_rows(g.reshape(g.shape[0], -1), group)[:nw].numpy()

    # optimize_bank over the mesh: Adam (with and without window chunks) and L-BFGS
    for name, kw in (("adam", dict(num_steps=5, learning_rate=0.05)),
                     ("adam_chunked", dict(num_steps=5, learning_rate=0.05, window_chunk=2,
                                           segment=2)),
                     ("lbfgs", dict(num_steps=6, method="lbfgs"))):
        trained, losses = optimize_bank(tiny_bank(), mesh=mesh, **kw)
        res[f"{name}_losses"] = losses
        for n, p in named_params(trained):
            res[f"{name}{n}"] = p.raw.detach().numpy()

    # the SoSp pipeline through optimize_bank(mesh=)
    sosp = tiny_sosp()
    res["sosp_losses"] = sosp.optimize(maxiter=5, learning_rate=0.02, mesh=mesh)
    res["sosp_matrix_var"] = sosp.matrix_var

    # ModGP's sources over the ranks: the loss and every gradient
    model, x, y = modgp_data()
    local, _ = shard_modgp_sources(model, mesh)
    loss = local.loss(x, y)
    res["modgp_loss"] = loss.detach().numpy()
    names, grads = trainable_grads(local, loss)
    for n, g in zip(names, grads):
        per_source = g.dim() >= 1 and n != ".likelihood.variance"
        res[f"modgp_grad{n}"] = (gather_rows(g.reshape(g.shape[0], -1), group).numpy()
                                 if per_source else g.numpy())
    dist.barrier()
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
