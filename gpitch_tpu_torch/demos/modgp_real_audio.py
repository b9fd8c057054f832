"""Real-audio modulated-GP demo: an isolated piano note (a WAV, or a
synthetic piano-like note when none is given) fitted by the single-source
ModGP, the component kernel's partials from the FFT.

The port's counterpart of demos/demo_modgp_real_audio.py: the same
features, inducing points (extrema, decimated), kernels and schedule.
Prints the fit's line and the reconstruction RMSE over the whole signal,
which must stay under ``--max-rmse``.

Run:  python -m gpitch_tpu_torch.demos.modgp_real_audio [--wav file.wav]
      [--midi 60] [--steps 2000] [--partials 5] [--device cuda] [--plot]
"""

from __future__ import annotations

import numpy as np


def main(argv=None) -> int:
    from ._common import parser, verdict
    ap = parser(__doc__)
    ap.add_argument("--wav", type=str, default=None,
                    help="isolated-note WAV file; synthetic note if omitted")
    ap.add_argument("--midi", type=int, default=60)
    ap.add_argument("--frames", type=int, default=32000)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=0.0025)
    ap.add_argument("--minibatch", type=int, default=100)
    ap.add_argument("--partials", type=int, default=5)
    ap.add_argument("--dec", type=int, default=9, help="inducing-point decimation")
    ap.add_argument("--max-rmse", type=float, default=0.05)
    args = ap.parse_args(argv)

    import torch

    from ..audio import init_cparam, readaudio, synth_piano_note
    from ..kernels import Matern32, MercerMatern12sm
    from ..models import ModGP, fit_adam_segmented, minibatch_fn, predict_windowed
    from ..pipelines import init_liv
    from ..utils import midi2freq

    f0 = midi2freq(args.midi)
    if args.wav:
        x, y, fs = readaudio(args.wav, frames=args.frames, scaled=True)
        print(f"loaded {args.wav}: {y.shape[0]} samples @ {fs} Hz")
    else:
        fs = 16000
        x, y = synth_piano_note(fs=fs, seconds=args.frames / fs, f0=f0)
        print(f"synthesized piano-like note: {y.shape[0]} samples @ {fs} Hz, "
              f"f0 {f0:.1f} Hz")
    n = y.shape[0]

    freqs, energies, _, _, _ = init_cparam(y, fs=fs, maxh=args.partials, ideal_f0=f0)
    print("partials (Hz):", np.round(freqs, 1).tolist())
    z, _ = init_liv(x=x, y=y, win_size=31, thres=0.05, dec=args.dec)

    kact = Matern32.create(variance=3.5, lengthscales=0.2)
    kcom = MercerMatern12sm.create(variance=1.0, lengthscales=0.5, energy=energies,
                                   frequency=freqs)
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
    print(f"{args.steps} Adam steps: first-segment excess {first_s:.1f}s, run {run_s:.2f}s "
          f"({args.steps / run_s:.0f} steps/s), "
          f"ELBO {-losses[-1]:.1f} (start {-losses[0]:.1f})")

    results = predict_windowed(model, xt, ws=1600)
    m_src = results[4].cpu().numpy()
    rmse = float(np.sqrt(np.mean((m_src[:, 0:1] - y) ** 2)))
    print(f"reconstruction RMSE: {rmse:.4f}")

    if args.plot:
        from ..viz import plot_pdgp
        fig = plot_pdgp(x, y, x, results, z=(z[0][0], z[1][0]))
        fig.savefig("demo-modgp-real-audio.png", dpi=100)
        print("saved demo-modgp-real-audio.png")
    return verdict(np.isfinite(rmse) and rmse < args.max_rmse,
                   f"reconstruction RMSE {rmse} >= {args.max_rmse}")


if __name__ == "__main__":
    raise SystemExit(main())
