"""Synthetic modulated-GP demo: a 3-harmonic component under a two-bump
envelope, fitted by the single-source ModGP with minibatch Adam.

The port's counterpart of demos/demo_modgp.py: the same data, inducing
points, kernels and schedule.  Prints the fit's line and the source
recovery RMSE, which must stay under ``--max-rmse``.

Run:  python -m gpitch_tpu_torch.demos.modgp [--steps 1000] [--n 16000]
      [--device cuda] [--plot]
"""

from __future__ import annotations

import numpy as np


def main(argv=None) -> int:
    from ._common import parser, verdict
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--n", type=int, default=16000)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--minibatch", type=int, default=100)
    ap.add_argument("--max-rmse", type=float, default=0.05)
    args = ap.parse_args(argv)

    import torch

    from ..kernels import Matern32, MercerMatern12sm
    from ..models import ModGP, fit_adam_segmented, minibatch_fn
    from ..pipelines import init_liv

    n, fs = args.n, 16000
    x = np.linspace(0.0, (n - 1.0) / fs, n).reshape(-1, 1)
    component = sum(np.sin(2 * np.pi * x * (k + 1) * 15.0) for k in range(3))
    component /= np.max(np.abs(component))
    envelope = np.exp(-25 * (x - 0.33) ** 2) + np.exp(-75 * (x - 0.66) ** 2)
    envelope /= np.max(np.abs(envelope))
    y = component * envelope + np.sqrt(1e-6) * np.random.default_rng(0).standard_normal((n, 1))

    z, _ = init_liv(x=x, y=y, win_size=31, thres=0.05, dec=1)
    kact = Matern32.create(variance=1.0, lengthscales=1.0)
    kcom = MercerMatern12sm.create(energy=[1.0, 1.0, 1.0], frequency=[15.0, 30.0, 45.0])
    model = ModGP.create(z=z, kern=[[kact], [kcom]], device=args.device)
    dev = model.za.raw.device
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)

    # one run, fenced every quarter: the first quarter's excess over the
    # others is the first pass's one-time cost (eager torch compiles nothing)
    model, losses, first_s, run_s = fit_adam_segmented(
        model, lambda m, xb, yb: m.loss(xb, yb, num_data=n), args.steps, args.lr,
        minibatch_fn(xt, yt, args.minibatch, torch.Generator(device=dev).manual_seed(0)),
        segment=max(1, args.steps // 4))
    elbo = -float(losses[-1]) if args.steps > 0 else float("nan")
    print(f"{args.steps} Adam steps: first-segment excess {first_s:.1f}s, run {run_s:.2f}s "
          f"({args.steps / run_s:.0f} steps/s), ELBO {elbo:.1f}")

    results = model.predict_act_n_com(xt[::4])
    m_src = results[4].cpu().numpy()
    rmse = float(np.sqrt(np.mean((m_src[:, 0:1] - (component * envelope)[::4]) ** 2)))
    print(f"source recovery RMSE: {rmse:.4f}")

    if args.plot:
        from ..viz import plot_pdgp
        fig = plot_pdgp(x, y, x[::4], results, z=(z[0][0], z[1][0]))
        fig.savefig("demo-modgp.png", dpi=100)
        print("saved demo-modgp.png")
    return verdict(np.isfinite(rmse) and rmse < args.max_rmse,
                   f"source recovery RMSE {rmse} >= {args.max_rmse}")


if __name__ == "__main__":
    raise SystemExit(main())
