"""The control, on the card: the reference computed in float32 with TF32
products (the next precision below the configuration's float32), put in
the program's place, fails each cell's limits: an Adam cell's first steps,
last loss and final state, a job's whole fit and its sources, each from
the control's own start."""

import json

import pytest
import torch

from benchmark import check, drivers, generator, harness

from benchmark.tests.conftest import ROOT

SEED = 4_000_000_001


def _tf32(fn):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("workload", ["sosp14-adam", "sosp14-job"])
def test_control_fails_the_cells_limits(cuda, workload):
    _, _, config, traffic = harness.load_cell(ROOT, workload)
    drv = drivers.KINDS[traffic["kind"]](config, traffic, SEED, 1.0, cuda)
    limits = check.load_limits(harness.BENCH_DIR, workload)
    if traffic["kind"] == "adam_fit":
        drv.rec = generator.make_recording(config, generator.job_seed(SEED, 0))
        ctrl = _tf32(lambda: drv.reference_outputs(torch.float32, final={}))
        ctrl = dict(ctrl, last_losses=ctrl["losses"][-2:], final=ctrl["last_state"])
        truth = drv.reference_outputs(torch.float64, final=ctrl["final"])
    else:
        drv.recs, drv.checked = [generator.make_recording(config, generator.job_seed(SEED, 0))], 0
        truth = drv.reference_outputs(torch.float64)
        ctrl = _tf32(lambda: drv.reference_outputs(torch.float32))
    ok, checks = check.judge(drv.compare(ctrl, truth), limits)
    assert not ok, json.dumps(checks)
