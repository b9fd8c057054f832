"""Source-separation demo: three isolated piano-like notes (C4, E4, G4)
train the pitch kernels, and the window bank of a mixture of three fresh
takes at staggered onsets is trained on the device, its per-source
posteriors merged by Hann overlap-add and scored by RMSE.

The port's counterpart of demos/demo_separation.py: the same notes,
mixture, kernels and schedule.  Prints the bank's line and the mean
per-source RMSE, which must stay under ``--max-rmse``.

Run:  python -m gpitch_tpu_torch.demos.separation [--seconds 3]
      [--maxiter 300] [--device cuda] [--plot]
"""

from __future__ import annotations

import time

import numpy as np

MIDIS = (60, 64, 67)        # C4, E4, G4
ONSETS = (0.0, 0.8, 1.6)


def main(argv=None) -> int:
    from ._common import parser, sync, verdict
    ap = parser(__doc__)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--maxiter", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--max-par", type=int, default=5)
    ap.add_argument("--dec", type=int, default=4)
    ap.add_argument("--num-inducing", type=int, default=64)
    ap.add_argument("--max-rmse", type=float, default=0.02)
    args = ap.parse_args(argv)

    from ..audio import synth_piano_note
    from ..pipelines import SoSp
    from ..utils import midi2freq

    fs = 16000
    train = [synth_piano_note(fs=fs, seconds=2.0, f0=midi2freq(m), seed=m)[1]
             for m in MIDIS]
    names = [f"demo_M{m}_train.wav" for m in MIDIS]
    sources = [synth_piano_note(fs=fs, seconds=args.seconds, f0=midi2freq(m),
                                onset=o, noise=0.0, seed=100 + m)[1]
               for m, o in zip(MIDIS, ONSETS)]
    x = np.linspace(0.0, (sources[0].shape[0] - 1.0) / fs,
                    sources[0].shape[0]).reshape(-1, 1)
    mix = sum(sources) / 3.0 + 1e-3 * np.random.default_rng(0).standard_normal(x.shape)
    sources = [s / 3.0 for s in sources]

    t0 = time.perf_counter()
    model = SoSp(train_signals=train, train_names=names, fs=fs, mixture=(x, mix),
                 kernel_mode="fft", max_par=args.max_par, dec=args.dec,
                 num_inducing=args.num_inducing, device=args.device)
    sync(args.device)
    print(f"built {model.nwin}-window bank in {time.perf_counter() - t0:.1f}s "
          f"({model.num_pitches} pitches, M={model.z.shape[1]})")

    losses, (first_s, run_s) = model.optimize(maxiter=args.maxiter,
                                              learning_rate=args.lr, timed=True)
    print(f"{args.maxiter} bank Adam steps: first-segment excess {first_s:.1f}s, "
          f"run {run_s * 1e3:.1f}ms ({args.maxiter / run_s:.0f} steps/s over "
          f"{model.nwin} windows), loss {losses[0]:.1f} -> {losses[-1]:.1f}")
    print(f"throughput: {args.seconds * args.maxiter / run_s:.0f} audio-seconds "
          "optimized per second")

    model.predict_s()
    rmse = model.compute_rmse(sources)
    print(f"mean per-source RMSE: {rmse:.4f}")

    if args.plot:
        from ..viz import plot_sources_all
        fig = plot_sources_all(x, mix, [e[0] for e in model.esource], sources=sources)
        fig.savefig("demo-separation.png", dpi=100)
        print("saved demo-separation.png")
    return verdict(np.isfinite(rmse) and rmse < args.max_rmse,
                   f"mean per-source RMSE {rmse} >= {args.max_rmse}")


if __name__ == "__main__":
    raise SystemExit(main())
