"""Transcription (AMT) demo: a short piece of three piano-like notes (C4,
E4, G4 at staggered onsets) transcribed from the per-pitch variance
envelopes of a window bank trained on the device, scored by the
frame-level F-measure against the known notes.

The port's counterpart of demos/demo_transcription.py: the same piece,
dictionary, kernels and schedule.  Prints the bank's line and the
F-measure, which must reach ``--min-f``.

Run:  python -m gpitch_tpu_torch.demos.transcription [--seconds 3]
      [--maxiter 300] [--model-pitches 3] [--device cuda] [--plot]
"""

from __future__ import annotations

import time

import numpy as np

MIDIS = (60, 64, 67)
ONSETS = (0.0, 1.0, 2.0)
DUR = 0.5  # audible length of each note (s), for the ground truth


def main(argv=None) -> int:
    from ._common import parser, sync, verdict
    ap = parser(__doc__)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--maxiter", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--max-par", type=int, default=5)
    ap.add_argument("--dec", type=int, default=4)
    ap.add_argument("--num-inducing", type=int, default=64)
    ap.add_argument("--threshold", type=float, default=0.15)
    ap.add_argument("--model-pitches", type=int, default=len(MIDIS),
                    help="size of the pitch dictionary (3: only the sounding "
                         "notes; 88: the full piano)")
    ap.add_argument("--min-f", type=float, default=0.5)
    args = ap.parse_args(argv)

    from ..audio import synth_piano_note
    from ..pipelines import AMT, f_measure
    from ..utils import midi2freq

    fs = 16000
    if args.model_pitches > len(MIDIS):
        extra = [m for m in range(21, 109) if m not in MIDIS]
        model_midis = sorted(list(MIDIS) + extra[:args.model_pitches - len(MIDIS)])
    else:
        model_midis = list(MIDIS)
    train = [synth_piano_note(fs=fs, seconds=2.0, f0=midi2freq(m), seed=m)[1]
             for m in model_midis]
    names = [f"demo_M{m}_train.wav" for m in model_midis]
    notes = [synth_piano_note(fs=fs, seconds=args.seconds, f0=midi2freq(m),
                              onset=o, noise=0.0, seed=200 + m)[1]
             for m, o in zip(MIDIS, ONSETS)]
    n = notes[0].shape[0]
    x = np.linspace(0.0, (n - 1.0) / fs, n).reshape(-1, 1)
    y = sum(notes) / 3.0 + 1e-3 * np.random.default_rng(0).standard_normal(x.shape)

    t0 = time.perf_counter()
    model = AMT(train_signals=train, train_names=names, fs=fs, test=(x, y),
                pitches=model_midis, kernel_mode="fft", max_par=args.max_par,
                dec=args.dec, num_inducing=args.num_inducing, device=args.device)
    sync(args.device)
    print(f"built {model.nwin}-window bank in {time.perf_counter() - t0:.1f}s "
          f"({len(model_midis)}-pitch dictionary)")

    losses, (first_s, run_s) = model.optimize(maxiter=args.maxiter,
                                              learning_rate=args.lr, timed=True)
    print(f"{args.maxiter} bank Adam steps: first-segment excess {first_s:.1f}s, "
          f"run {run_s * 1e3:.1f}ms ({args.maxiter / run_s:.0f} steps/s over "
          f"{model.nwin} windows), loss {losses[0]:.1f} -> {losses[-1]:.1f}")
    print(f"throughput: {args.seconds * args.maxiter / run_s:.0f} "
          "audio-seconds optimized per second")

    # ground-truth roll at the window centres (silent rows for the pitches
    # that do not sound)
    hop = (model.window_size - 1) // 2
    centers = (np.arange(model.nwin) * hop + model.window_size // 2) / fs
    onset_of = dict(zip(MIDIS, ONSETS))
    ref = np.stack([(centers >= onset_of[m]) & (centers <= onset_of[m] + DUR)
                    if m in onset_of else np.zeros_like(centers, dtype=bool)
                    for m in model_midis])
    # per-pitch rescaling amplifies noise on silent rows: the global scale
    # when the dictionary is larger than the sounding set
    est = model.pianoroll_estimate(threshold=args.threshold,
                                   per_pitch=len(model_midis) == len(MIDIS))
    p, r, f = f_measure(est, ref)
    print(f"frame-level precision {p:.3f}  recall {r:.3f}  F-measure {f:.3f}")

    if args.plot:
        from ..viz.plots import _plt
        plt = _plt()
        fig, axes = plt.subplots(2, 1, figsize=(12, 6))
        win_fs = 1.0 / (hop / fs)
        for ax, mat, title in ((axes[0], model.matrix_var, "variance envelope"),
                               (axes[1], est, "pianoroll estimate")):
            ax.imshow(np.asarray(mat), aspect="auto", origin="lower",
                      extent=[0, model.nwin / win_fs, 0, len(model_midis)])
            if len(model_midis) <= 12:
                ax.set_yticks(np.arange(len(model_midis)) + 0.5)
                ax.set_yticklabels([str(m) for m in model_midis])
            ax.set_title(title)
        axes[1].set_xlabel("time (s)")
        fig.savefig("demo-transcription.png", dpi=100)
        print("saved demo-transcription.png")
    return verdict(np.isfinite(f) and f >= args.min_f,
                   f"frame-level F-measure {f} < {args.min_f}")


if __name__ == "__main__":
    raise SystemExit(main())
