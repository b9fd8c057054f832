"""The cells' drivers, one per kind of traffic, and the program's entry.

A traffic file names its ``kind``; the driver of that kind builds the
program's pipeline for the configuration from the seed's recording, warms
every shape the window uses, runs the window, runs a profiled stretch for a
traced run, and gives what the program produced to the comparison with the
reference.  Only this file calls the program (``gpitch_tpu_torch``), and
only through its public entry points: the pipelines ``SoSp`` and ``AMT``,
their ``optimize`` and ``predict_s``, ``windowed_sgpr.bank_loss`` and the
parameter tree's ``named_params``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import check, counts, generator, reference
from .trace import Spans, profile

__all__ = ["KINDS", "build_model", "program_leaves"]

# the program's parameter paths and the reference's leaf names
LEAF_NAMES = {".kern.stacked.variance": "variance",
              ".kern.stacked.lengthscales": "lengthscale",
              ".kern.stacked.energy": "energy", ".kern.stacked.frequency": "frequency",
              ".variance": "noise"}
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# job numbers of the generator's streams beside the window's jobs
WARM_JOB, SAMPLE_JOB, PROFILED_JOB = 2 ** 31 - 1, 2 ** 31 - 2, 2 ** 31 - 3


def build_model(config: dict, rec: dict, device):
    """The configuration's pipeline (``SoSp`` or ``AMT``) over the recording,
    built as a user builds it: the pitch kernels from the isolated notes'
    FFT, the inducing points at each window's extrema."""
    from gpitch_tpu_torch.pipelines import AMT, SoSp
    pitches = list(config["pitches"])
    notes = [rec["notes"][p] for p in pitches]
    names = [f"piano_M{p}_train.wav" for p in pitches]
    kw = dict(window_size=config["window_size"], kernel_mode="fft",
              max_par=config["max_par"], num_inducing=config["num_inducing"],
              dec=config["dec"], device=device, dtype=DTYPES[config["dtype"]])
    x = rec["x"].reshape(-1, 1)
    if config["task"] == "separation":
        return SoSp(train_signals=notes, train_names=names, fs=rec["fs"],
                    mixture=(x, rec["mix"]), **kw)
    return AMT(train_signals=notes, train_names=names, fs=rec["fs"], test=(x, rec["mix"]),
               pitches=pitches, y_scale=config["y_scale"], reg=False, **kw)


def program_leaves(bank, trainable_only: bool = True) -> dict:
    """The bank's raw parameter leaves by the reference's names."""
    from gpitch_tpu_torch.core.params import named_params
    return {LEAF_NAMES[path]: p.raw for path, p in named_params(bank)
            if path in LEAF_NAMES and (p.trainable or not trainable_only)}


def _host(leaves: dict) -> dict:
    return {k: v.detach().double().cpu() for k, v in leaves.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Driver:
    """What every kind shares: the configuration, the traffic, the seed,
    the device, the host spans and the shapes the counts need.  After the
    window, ``unit_s`` is the wall time of one unit of its work (a step, a
    job) and ``flops_per_unit()`` that unit's frozen operation count."""

    def __init__(self, config: dict, traffic: dict, seed: int, seconds: float, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.seconds, self.device = seconds, torch.device(device)
        self.spans = Spans()
        self.unit_s = None

    def shapes(self, bank) -> dict:
        st = bank.kern.stacked
        return {"nw": int(bank.X.raw.shape[0]), "n": int(bank.X.raw.shape[-2]),
                "m": int(bank.Z.raw.shape[-2]), "s": int(st.energy.raw.shape[-2]),
                "p": int(st.energy.raw.shape[-1])}

    def _model(self, rec):
        model = build_model(self.config, rec, self.device)
        if not model.bank.fused_eligible():
            raise RuntimeError("the bank is not stacked: the pitches' FFTs gave "
                               "different partial counts")
        return model

    def _reference(self, rec, dtype):
        prob = reference.make_problem(self.config, rec)
        return prob.to(dtype, self.device)


# ------------------------------------------------------------- Adam fits
class AdamFit(Driver):
    """A fit with the default optimizer: the window is one
    ``optimize(maxiter=K)`` call from the pipeline's start, K fixed in
    set-up so that the call lasts about the window's length.

    Set-up builds the pipeline, takes the step's own loss gradient at the
    start (the port's ``optimize`` keeps no optimizer state to read it
    from), drives the pipeline through its first ``first_steps`` steps by
    the window's own call (eager steps, the capture, a replay), times a
    call of ``calibration_steps`` (whole fenced segments: 2 x 250 steps, or
    one a chunk) and sets the pipeline back to its start: the input bank of
    ``optimize`` is left unchanged.  The comparison reads the window's own
    call: the losses of its first ``check_steps`` steps (its eager steps,
    its capture, its replays and the fence after step 250), its last two
    losses and its final state."""

    def _optimize(self, model, steps: int, timed: bool = False):
        kw = {"window_chunk": self.traffic["window_chunk"]} \
            if self.traffic.get("window_chunk") else {}
        return model.optimize(maxiter=steps, learning_rate=self.traffic["learning_rate"],
                              timed=timed, **kw)

    def setup(self) -> None:
        self.first_steps()
        n = self.traffic["calibration_steps"]
        _sync(self.device)
        t0 = time.perf_counter()
        # a call's time is its own (the eager steps, the capture: the first
        # of its equal fenced segments less the others' median) and its
        # steps'; the window's call of K steps lasts the window's length
        _, (own, steps_s) = self._optimize(self.model, n, timed=True)
        per_step = max(steps_s / n, 0.5 * (time.perf_counter() - t0) / n)
        self.steps = max(n, self.traffic["check_steps"],
                         int(round((self.seconds - own) / per_step)))
        self.model.bank = self.start

    def first_steps(self) -> None:
        """The pipeline built from the seed's recording, its loss gradient
        at the start, and its first ``first_steps`` steps by the window's
        own call: the change they make and the variances after them."""
        self.rec = generator.make_recording(self.config, generator.job_seed(self.seed, 0))
        model = self.model = self._model(self.rec)
        self.start = model.bank
        self.shape = self.shapes(model.bank)
        start = _host(program_leaves(model.bank))
        self.grad = self._gradient(model.bank)
        self._optimize(model, self.traffic["first_steps"])
        self.change = {k: v - start[k] for k, v in _host(program_leaves(model.bank)).items()}
        self.matrix_var = np.asarray(model.matrix_var, np.float64)

    def _gradient(self, bank) -> dict:
        """The gradient of the step's loss (``windowed_sgpr.bank_loss``) at
        the bank's state, in the window's chunks padded as the port pads
        them."""
        from gpitch_tpu_torch.parallel.mesh import repeat_last_window
        from gpitch_tpu_torch.pipelines.windowed_sgpr import bank_loss
        from gpitch_tpu_torch.core.params import take_windows
        nw = bank.X.raw.shape[0]
        chunk = min(self.traffic.get("window_chunk") or nw, nw)
        pad = -nw % chunk
        padded = repeat_last_window(bank, pad) if pad else bank
        parts = []
        for c0 in range(0, nw + pad, chunk):
            part = take_windows(padded, slice(c0, c0 + chunk))
            leaves = program_leaves(part)
            got = torch.autograd.grad(bank_loss(part), list(leaves.values()))
            parts.append({k: g.detach() for k, g in zip(leaves, got)})
        return {k: torch.cat([p[k] for p in parts])[:nw].double().cpu() for k in parts[0]}

    def window(self) -> dict:
        _sync(self.device)
        t0 = time.perf_counter()
        losses = self._optimize(self.model, self.steps)
        wall = time.perf_counter() - t0
        self.window_s, self.unit_s = wall, wall / self.steps
        losses = np.asarray(losses, np.float64)
        self.losses = losses[: self.traffic["check_steps"]]
        self.last_losses = losses[-2:]
        self.final = _host(program_leaves(self.model.bank))
        return {"metrics": {"bank_step_ms": self.unit_s * 1e3},
                "attempted": self.steps, "failed": int((~np.isfinite(losses)).sum())}

    def profiled(self):
        return profile(lambda: self._optimize(self.model, self.traffic["profile_steps"]),
                       "bench.optimize")[1]

    def release(self) -> None:
        self.model = self.start = None
        _free()

    def outputs(self) -> dict:
        return {"losses": self.losses, "last_losses": self.last_losses, "final": self.final,
                "grad": self.grad, "change": self.change, "matrix_var": self.matrix_var}

    def reference_outputs(self, dtype, final=None) -> dict:
        """What the reference computes in the program's place, in ``dtype``
        (float32 products in TF32 when the caller allows them): its own
        first ``check_steps`` Adam steps, and its loss at the state
        ``final`` (the program's final state by default; none for ``{}``)."""
        prob = self._reference(self.rec, dtype)
        tot, first, kept, last = reference.adam_steps(
            prob, self.traffic["check_steps"], self.traffic["learning_rate"],
            self.config["reference_block"], keep_at=self.traffic["first_steps"])
        final = self.final if final is None else final
        return {"losses": tot, "grad": _host(first),
                "change": {k: (kept[k] - prob.raw[k]).double().cpu() for k in kept},
                "matrix_var": reference.positive(kept["variance"]).double().cpu().numpy().T,
                "final_loss": self.reference_loss(final, dtype, prob) if final else None,
                "last_state": _host(last)}

    def reference_loss(self, leaves: dict, dtype, prob=None) -> float:
        """The reference's total loss at the state ``leaves``."""
        prob = self._reference(self.rec, dtype) if prob is None else prob
        losses, _ = reference.loss_and_grad(
            prob, {k: leaves[k].to(prob.X.device, dtype) for k in prob.raw},
            self.config["reference_block"])
        return float(losses.double().sum())

    @staticmethod
    def compare(got: dict, truth: dict) -> dict:
        keep = check.moved(truth["grad"])
        var = np.asarray(keep["variance"]).T
        scale = np.abs(truth["losses"]).max()
        # the last loss is taken before the last step: the loss after it is
        # extrapolated from the last two
        after = 2.0 * got["last_losses"][-1] - got["last_losses"][-2]
        return {"loss_rel": check.max_rel(got["losses"], truth["losses"]),
                "final_gap": float(abs(after - truth["final_loss"]) / scale),
                "grad_gap": check.worst_leaf_gap(got["grad"], truth["grad"]),
                "change_gap": check.worst_leaf_gap(got["change"], truth["change"], keep),
                "matrix_var_gap": check.max_rel(got["matrix_var"][var],
                                                truth["matrix_var"][var])}

    def flops_per_unit(self) -> float:
        sh = self.shape
        return counts.total(counts.bank_step(sh["nw"], sh["m"], sh["n"], sh["s"], sh["p"]))


# ------------------------------------------------------ whole separations
class SeparationJob(Driver):
    """Whole separation jobs back to back: each a fresh recording drawn
    from the seed, ``SoSp(...)``, ``optimize(maxiter)``, ``predict_s()``
    (the per-source posteriors merged by Hann overlap-add).  The window
    ends when the job that crosses its length finishes.  Set-up makes the
    recordings and runs one job on a recording of its own.  The comparison
    reads one of the window's jobs, drawn from the seed: every loss of its
    fit, and its sources against the reference's at the state the
    reference's own fit reaches."""

    def _job(self, rec, keep: bool) -> dict:
        sp = self.spans
        model = sp.timed("build", self._model, rec)
        losses = sp.timed("fit", model.optimize, maxiter=self.traffic["maxiter"],
                          learning_rate=self.traffic["learning_rate"])
        est = sp.timed("predict", model.predict_s)
        out = {"finite": bool(np.isfinite(losses).all()
                              and all(np.isfinite(e[0]).all() for e in est))}
        if keep:
            out.update(losses=np.asarray(losses, np.float64),
                       means=np.stack([e[0][:, 0] for e in est]),
                       variances=np.stack([e[1][:, 0] for e in est]))
        self.shape = self.shapes(model.bank)
        return out

    def setup(self) -> None:
        most = int(np.ceil(self.seconds / self.traffic["least_job_s"])) + 1
        self.recs = [generator.make_recording(self.config, generator.job_seed(self.seed, j))
                     for j in range(most)]
        self._job(generator.make_recording(self.config, generator.job_seed(self.seed, WARM_JOB)),
                  keep=False)
        self.spans = Spans()

    def window(self) -> dict:
        jobs = []
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            jobs.append(self._job(self.recs[len(jobs) % len(self.recs)], keep=True))
            if time.perf_counter() - t0 >= self.seconds:
                break
        wall = time.perf_counter() - t0
        self.jobs, self.window_s, self.unit_s = jobs, wall, wall / len(jobs)
        audio = len(jobs) * self.config["seconds"]
        rng = np.random.default_rng(generator.job_seed(self.seed, SAMPLE_JOB))
        self.checked = int(rng.integers(len(jobs)))
        return {"metrics": {"audio_s_per_s": audio / wall}, "attempted": len(jobs),
                "failed": sum(not j["finite"] for j in jobs)}

    def profiled(self):
        rec = generator.make_recording(self.config, generator.job_seed(self.seed, PROFILED_JOB))
        window_spans, self.spans = self.spans, Spans()     # the window's spans alone are read
        try:
            return profile(lambda: self._job(rec, keep=False), "bench.job")[1]
        finally:
            self.spans = window_spans

    def release(self) -> None:
        self.jobs = {self.checked: self.jobs[self.checked]}
        _free()

    def outputs(self) -> dict:
        return self.jobs[self.checked]

    def reference_outputs(self, dtype) -> dict:
        """The checked job's fit by the reference from its own start (every
        step's loss) and its merged sources at the state it reaches."""
        rec = self.recs[self.checked % len(self.recs)]
        prob = self._reference(rec, dtype)
        tot, _, _, last = reference.adam_steps(prob, self.traffic["maxiter"],
                                               self.traffic["learning_rate"],
                                               self.config["reference_block"])
        mean, var = reference.predict_sources(prob, last, self.config["predict_block"])
        n = rec["x"].shape[0]
        return {"losses": tot,
                "means": np.stack([reference.merge(m.double().cpu().numpy(), n) for m in mean]),
                "variances": np.stack([reference.merge(v.double().cpu().numpy(), n, True)
                                       for v in var])}

    @staticmethod
    def compare(got: dict, truth: dict) -> dict:
        sources = range(len(truth["means"]))
        return {"loss_rel": check.max_rel(got["losses"], truth["losses"]),
                "source_gap": max(check.max_rel(got["means"][s], truth["means"][s])
                                  for s in sources),
                "source_var_gap": max(check.max_rel(got["variances"][s], truth["variances"][s])
                                      for s in sources)}

    def flops_per_unit(self) -> float:
        sh = self.shape
        step = counts.bank_step(sh["nw"], sh["m"], sh["n"], sh["s"], sh["p"])
        return (self.traffic["maxiter"] * counts.total(step)
                + counts.total(counts.predict_sources(sh["nw"], sh["n"], sh["s"], sh["p"])))


KINDS = {"adam_fit": AdamFit, "separation_job": SeparationJob}
