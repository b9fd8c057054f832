"""The plain reference against the port, on the CPU in float64 at a small
size: the same windows, inducing points and pitch kernels, the bound and
its gradient, Adam steps (the state after two and after four, each from
the start), the sources and their merge.  The test may
import both; the reference imports neither."""

import numpy as np
import pytest
import torch

from benchmark import drivers, generator, reference

from benchmark.tests.conftest import tiny


@pytest.mark.parametrize("name", ["sosp-14s", "transcription"])
def test_reference_follows_the_port_in_float64(name):
    from gpitch_tpu_torch.pipelines.windowed_sgpr import bank_loss
    config = dict(tiny(name), dtype="float64")
    rec = generator.make_recording(config, generator.job_seed(2 ** 32 + 9, 0))
    model = drivers.build_model(config, rec, "cpu")
    prob = reference.make_problem(config, rec)
    assert model.bank.fused_eligible()
    assert np.array_equal(model.bank.Z.raw[..., 0].numpy(), prob.Z.numpy())
    leaves = drivers.program_leaves(model.bank)
    assert sorted(leaves) == sorted(prob.raw)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.detach().numpy(), prob.raw[k].numpy(), rtol=1e-12, atol=1e-12)
    loss = bank_loss(model.bank)
    got = torch.autograd.grad(loss, list(leaves.values()))
    ref_losses, ref_grad = reference.loss_and_grad(prob, prob.raw, 3)
    assert float(loss.detach()) == pytest.approx(float(ref_losses.sum()), rel=1e-12)
    for k, g in zip(leaves, got):
        np.testing.assert_allclose(g.numpy(), ref_grad[k].numpy(), rtol=1e-9,
                                   atol=1e-9 * float(ref_grad[k].abs().max()))
    start = model.bank
    model.optimize(maxiter=2, learning_rate=0.01)
    tot, _, kept, after = reference.adam_steps(prob, 4, 0.01, 3, keep_at=2)
    for k, v in drivers.program_leaves(model.bank).items():
        np.testing.assert_allclose(v.detach().numpy(), kept[k].numpy(), rtol=1e-9, atol=1e-12)
    model.bank = start                  # optimize leaves its input bank unchanged
    losses = model.optimize(maxiter=4, learning_rate=0.01)
    np.testing.assert_allclose(losses, tot, rtol=1e-12)
    for k, v in drivers.program_leaves(model.bank).items():
        np.testing.assert_allclose(v.detach().numpy(), after[k].numpy(), rtol=1e-9, atol=1e-12)
    if config["task"] == "separation":
        est = model.predict_s()
        mean, var = reference.predict_sources(prob, after, 2)
        n = rec["x"].shape[0]
        for s in range(len(est)):
            rm = reference.merge(mean[s].numpy(), n)
            rv = reference.merge(var[s].numpy(), n, squared=True)
            np.testing.assert_allclose(est[s][0][:, 0], rm, atol=1e-9 * np.abs(rm).max())
            np.testing.assert_allclose(est[s][1][:, 0], rv, atol=1e-9 * np.abs(rv).max())
    else:
        np.testing.assert_allclose(model.matrix_var,
                                   reference.positive(after["variance"]).numpy().T, rtol=1e-12)


def test_reference_imports_nothing_of_the_program():
    import ast
    import inspect
    for mod in (reference, generator):
        tree = ast.parse(inspect.getsource(mod))
        names = {a.name.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for a in node.names}
        names |= {node.module.split(".")[0] for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert names <= {"__future__", "heapq", "math", "numpy", "torch"}, names
