#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload sosp14-adam --seeds 1 2 3 ... \
        [--control 3] [--faults 3] --out chiprun_out/cal.jsonl

For each seed, in one process: the program's part of a run that the
comparison reads (an Adam cell's set-up and a window of ``check_steps``
steps; one whole job of a job cell), then the float64 reference, and the
numbers the run compares (the lower readings; at the window's full length
the benchmark's own runs give them too).  ``--control k``: on the first k
seeds, the reference computed in float32 with TF32 products put in the
program's place (the upper readings).  ``--faults k``: on the first k
seeds, the program run again with each fault a cell can have planted in
it: every Adam step leaving its state unchanged, half of the windows left
out of the loss (the rest weighed twice), one answer altered where it is
produced (a variance, a source sample).  One JSON line a reading, with
the reference's seconds.  A tool for setting limits; the checks do not
run it.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted in it, for the block's length."""
    from gpitch_tpu_torch.models import fit
    from gpitch_tpu_torch.pipelines import separation, transcription, windowed_sgpr
    saved = []

    def put(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "unchanged":            # the count advances, the state does not
        put(fit.Adam, "commit", lambda self, params, m, v, ok=None: self.t.add_(1))
    elif fault == "half_batch":         # the loss over half of the windows, scaled back
        put(windowed_sgpr, "bank_loss", lambda bank: 2.0 * bank.loss()[::2].sum())
    elif fault == "altered_variance":
        real = windowed_sgpr.pitch_variances

        def altered(bank):
            out = real(bank).clone()
            out[0, 0] *= 1.01
            return out
        put(separation, "pitch_variances", altered)
        put(transcription, "pitch_variances", altered)
    elif fault == "altered_source":
        real_sources = separation.predict_bank_sources

        def altered_sources(*a, **kw):
            mean, var = real_sources(*a, **kw)
            mean = mean.clone()
            mean[0, 1] += 0.01 * mean.abs().max()
            return mean, var
        put(separation, "predict_bank_sources", altered_sources)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


FAULTS = {"adam_fit": ("unchanged", "half_batch", "altered_variance"),
          "separation_job": ("unchanged", "half_batch", "altered_source")}


def program_part(drv, kind: str, generator):
    """What a run hands the comparison, with the window cut short for an
    Adam cell (``check_steps`` steps)."""
    if kind == "adam_fit":
        drv.first_steps()
        drv.steps = drv.traffic["check_steps"]
        drv.model.bank = drv.start
        drv.window()
    else:
        drv.recs = [generator.make_recording(drv.config, generator.job_seed(drv.seed, 0))]
        drv.jobs, drv.checked = [drv._job(drv.recs[0], keep=True)], 0
    got = drv.outputs()
    drv.release()
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import drivers, generator, harness
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    _, _, config, traffic = harness.load_cell(ROOT, args.workload)
    kind = traffic["kind"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(**kw):
        line = json.dumps({"workload": args.workload, **kw})
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    def driver(seed):
        return drivers.KINDS[kind](config, traffic, seed, 1.0, "cuda")

    for i, seed in enumerate(args.seeds):
        drv = driver(seed)
        got = program_part(drv, kind, generator)
        t0 = time.perf_counter()
        truth = drv.reference_outputs(torch.float64)
        emit(seed=seed, side="program", readings=drv.compare(got, truth),
             reference_s=time.perf_counter() - t0)
        if i < args.control:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ctrl = drv.reference_outputs(torch.float32)
                if kind == "adam_fit":
                    ctrl = dict(ctrl, last_losses=ctrl["losses"][-2:], final=ctrl["last_state"])
                    against = dict(truth, final_loss=drv.reference_loss(ctrl["final"],
                                                                        torch.float64))
                else:
                    against = truth
                emit(seed=seed, side="control_tf32", readings=drv.compare(ctrl, against))
            except Exception as e:      # a control that fails to give a number has failed
                emit(seed=seed, side="control_tf32", error=repr(e))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        if i < args.faults:
            for fault in FAULTS[kind]:
                bad = driver(seed)
                with planted(fault):
                    out = program_part(bad, kind, generator)
                against = truth if kind != "adam_fit" else dict(
                    truth, final_loss=drv.reference_loss(out["final"], torch.float64))
                emit(seed=seed, side="fault_" + fault, readings=drv.compare(out, against))
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
