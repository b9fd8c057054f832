"""The port's tooling surface against gpitch_tpu's: file helpers, the
timers and the trace, the numerics settings, the plots, the demos and the
exported names.

``utils/files.py`` gives the JAX package's results exactly (the same
directory, archives and result lists; ``append_sources`` within 1e-12, the
two packages' tanh); ``Timer`` and ``trace`` run on the CPU; ``set_jitter``/``set_jitter_rel``
override the dtype defaults and ``None`` restores them; every ``viz``
function draws on the Agg backend from tensors; each demo's ``main`` runs
with tiny arguments on the CPU, and exits 1 when its threshold is missed;
``adam_step_fn`` steps as ``fit_adam`` does.  Each ``__all__`` of the port
equals the JAX package's less the JAX-only names listed here.
"""

import ast
import importlib
import os
import sys

import matplotlib

matplotlib.use("Agg", force=True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gpitch_tpu.utils import files as jfiles  # noqa: E402
from gpitch_tpu_torch import config  # noqa: E402
from gpitch_tpu_torch import viz  # noqa: E402
from gpitch_tpu_torch.utils import files as tfiles  # noqa: E402
from gpitch_tpu_torch.utils import profiling as tprof  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64

# The JAX package's exported names that the port does not have, and why:
# they choose between its own compiler paths (Pallas or XLA, matmul
# precision, a jit under that precision, XLA's compilation cache), and the
# port has no such choice and no fallback: its hand kernels always run on
# the card, its matmuls are always f32-exact, and nothing is compiled at a
# call.  zero_untrainable_grads: an untrainable Param of the port holds a
# tensor that needs no gradient, so autograd gives it none to zero.  The
# FLOPs models, the utilization report and the JSONL metrics logger: the
# benchmark's own counts (benchmark/counts.py) replaced them.
JAX_ONLY = {
    "config": {"jit", "precision_scope", "matmul_precision", "set_matmul_precision",
               "enable_persistent_compilation_cache", "use_pallas_specmix",
               "set_pallas_specmix", "use_pallas_chol", "set_pallas_chol",
               "use_tri_inv_blocked", "set_tri_inv_blocked"},
    "core": {"zero_untrainable_grads"},
    "": {"zero_untrainable_grads"},
    "utils": {"MetricsLogger", "utilization_report", "flops_specmix", "flops_cholesky",
              "flops_trisolve", "flops_gh_expectations", "flops_svgp_step"},
}
# the subpackages, and the modules that carry an __all__ of their own
SUBPACKAGES = ["", "config", "core", "models", "utils", "pipelines", "kernels", "linalg",
               "audio", "likelihoods", "parallel", "viz", "native", "core.transforms"]


def _jax_top_level_names():
    """The names gpitch_tpu/__init__.py binds (it has no __all__)."""
    tree = ast.parse(open(os.path.join(ROOT, "gpitch_tpu", "__init__.py")).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    # ``from .core import`` also binds the subpackage ``core``
    names.add("core")
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_torch_exports_equal_jax_less_the_jax_only_names(sub):
    j = importlib.import_module("gpitch_tpu" + ("." + sub if sub else ""))
    t = importlib.import_module("gpitch_tpu_torch" + ("." + sub if sub else ""))
    want = set(j.__all__) if sub else _jax_top_level_names()
    assert set(t.__all__) == want - JAX_ONLY.get(sub, set())
    for name in t.__all__:
        assert hasattr(t, name), name


def test_torch_import_reaches_no_matplotlib_and_no_jax():
    """A fresh interpreter imports the whole package without matplotlib or
    JAX."""
    import subprocess
    code = ("import sys; import gpitch_tpu_torch, gpitch_tpu_torch.viz, "
            "gpitch_tpu_torch.parallel, gpitch_tpu_torch.demos.modgp; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'jax', 'optax', 'gpitch_tpu', 'tests_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------------------- files
def test_torch_file_helpers_match_jax(tmp_path):
    from scipy.io import wavfile
    for name in ["011PF_M60_train.wav", "011PF_M64_train.wav", "other_M60.txt"]:
        open(tmp_path / name, "w").close()
    for pitches in (None, [60, 64]):
        np.testing.assert_array_equal(tfiles.load_filenames(tmp_path, "011PF", pitches),
                                      jfiles.load_filenames(tmp_path, "011PF", pitches))

    def seg(s):
        return [[np.full((2, 1), 10 * q + src + s * 100 - 1.5) for src in range(3)]
                for q in range(3)]
    inlist = [seg(0), seg(1)]
    assert tfiles.merge_all is tfiles.merge_all_results
    tm, jm = tfiles.merge_all(inlist), jfiles.merge_all(inlist)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tfiles.append_sources(tm), jfiles.append_sources(jm)):
        # the logistic's tanh: numpy's here, XLA's there (6e-13 apart at these inputs)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=0)

    d = tmp_path / "models"
    d.mkdir()
    np.savez(d / "model_a.npz", w=np.arange(3.0))
    np.savez(d / "model_b.npz", w=np.arange(4.0))
    (tobjs, tnames), (jobjs, jnames) = (tfiles.loadm(str(d), "model"),
                                        jfiles.loadm(str(d), "model"))
    assert tnames == jnames == ["model_a.npz", "model_b.npz"]
    for a, b in zip(tobjs, jobjs):
        np.testing.assert_array_equal(a["w"], b["w"])

    data, params = tmp_path / "maps", tmp_path / "params"
    data.mkdir()
    params.mkdir()
    wavfile.write(str(data / "011PFNOF_M60_F_train.wav"), 16000,
                  np.random.default_rng(0).normal(size=9000).astype(np.float32))
    np.savez(params / "params_act_011PFNOF_M60_F_train.npz", l=np.ones(1))
    got = tfiles.load_pitch_params_data([60, 61], str(data), str(params), frames=2000,
                                        start=100)
    want = jfiles.load_pitch_params_data([60, 61], str(data), str(params), frames=2000,
                                         start=100)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][0], want[1][0])
    np.testing.assert_array_equal(got[2][0]["l"], want[2][0]["l"])


# --------------------------------------------------------------- profiling
def test_torch_timer_and_reports_on_the_cpu(tmp_path):
    x = torch.ones(64, 64, dtype=F64)
    t = tprof.Timer.time_fn(lambda a: a @ a, x, iters=3, warmup=1)
    assert t > 0
    with tprof.Timer() as timer:
        x @ x
    assert timer.elapsed > 0
    with tprof.trace(str(tmp_path / "trace")) as logdir:
        x @ x
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0


# ---------------------------------------------------------------- settings
def test_torch_jitter_settings_override_and_restore():
    from gpitch_tpu_torch.linalg.ops import add_jitter
    try:
        config.set_jitter(1e-3)
        config.set_jitter_rel(0.5)
        assert config.default_jitter(F64) == config.default_jitter(torch.float32) == 1e-3
        assert config.NumericsConfig().jitter_value(F64) == 1e-3
        assert config.default_jitter_rel(F64) == 0.5
        K = torch.eye(3, dtype=F64) * 2.0
        np.testing.assert_allclose(add_jitter(K).diagonal().numpy(), 2.0 + 1e-3 + 0.5 * 2.0)
    finally:
        config.set_jitter(None)
        config.set_jitter_rel(None)
    assert config.default_jitter(F64) == 1e-6 and config.default_jitter(torch.float32) == 1e-4
    assert config.default_jitter_rel(F64) == 0.0
    assert config.default_float() == torch.get_default_dtype()
    devices, path = config.init_settings(run_on_server=False)
    assert path == "/" and len(devices) >= 1


def test_torch_adam_step_fn_steps_as_fit_adam():
    from gpitch_tpu_torch.core.params import copy_params, trainable_tensors
    from gpitch_tpu_torch.models import adam_step_fn, fit_adam
    from gpitch_tpu_torch.models.fit import Adam
    from gpitch_tpu_torch.pipelines import bank_loss
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_resume import _bank
    bank = _bank()
    want, wl = fit_adam(bank, bank_loss, 4, 0.05)
    model = copy_params(bank)
    opt = Adam(trainable_tensors(model), lr=0.05)
    step = adam_step_fn(lambda m: bank_loss(m), opt)
    carry, losses = (model, opt), []
    for _ in range(4):
        carry, loss = step(carry)
        losses.append(loss.item())
    np.testing.assert_array_equal(losses, wl)
    for a, b in zip(trainable_tensors(carry[0]), trainable_tensors(want)):
        assert torch.equal(a, b)


# -------------------------------------------------------------------- viz
@pytest.fixture
def _close_figs():
    yield
    import matplotlib.pyplot as plt
    plt.close("all")


def _small_model(s=2, m=6):
    from gpitch_tpu_torch.kernels import Matern32, MercerMatern12sm
    from gpitch_tpu_torch.models import ModGP
    z = np.linspace(0.0, 1.0, m).reshape(-1, 1)
    ka = [Matern32.create(1.0, 1.0) for _ in range(s)]
    kc = [MercerMatern12sm.create(1.0, 0.5, [1.0, 0.5], [100.0 * (i + 1), 200.0 * (i + 1)])
          for i in range(s)]
    return ModGP.create(z=[[z] * s, [z] * s], kern=[ka, kc], device="cpu")


def test_torch_every_plot_draws_from_tensors(_close_figs):
    """All 16 functions on the Agg backend, given tensors where the JAX
    package's take arrays; axis counts as tests/test_viz.py checks them."""
    t = torch.as_tensor
    x = np.linspace(0, 1, 64).reshape(-1, 1)
    y = np.sin(2 * np.pi * 5 * x)
    mean, var = t(y.reshape(-1)), t(np.full(64, 0.01))
    assert viz.plotgp(t(x), t(y), t(x), mean, var) is not None
    assert viz.plot_predict(t(x), mean, var, z=t(x[::8]), latent=True) is not None
    assert viz.plot_predict(t(x), mean, var, z=t(x[::8])) is not None
    fig = viz.plot_zoom_in(t(x), t(y), t(x), mean, var, limits=(0.2, 0.3, -1, 1))
    assert len(fig.axes) >= 2
    assert len(viz.plot_data(t(x), t(y), sources=[t(y)] * 3).axes) == 4
    s = 3
    z = (t(np.tile(x[::8][None], (s, 1, 1))), t(np.tile(x[::8][None], (s, 1, 1))))
    fig = viz.plot_predict_all(t(x), t(np.tile(y, (1, s))), t(np.full((64, s), 0.01)),
                               t(np.tile(y, (1, s))), t(np.full((64, s), 0.01)), z=z)
    assert len(fig.axes) == 2 * s
    assert len(viz.plot_sources_all(t(x), t(y), [t(y[:, 0])] * s,
                                    sources=[t(y[:, 0])] * s).axes) == 1 + s
    assert len(viz.plot_sources(t(x), t(y), [t(y)] * 2).axes) == 2
    assert len(viz.plot_training_all(t(x), t(y), t(y), mean, var, mean, var).axes) == 4
    m = _small_model()
    pred = m.predict_act_n_com(t(x))
    assert len(viz.plot_trained_models([m], [(t(x), t(y))], [pred], instr_name="piano")) == 1
    assert len(viz.plot_parameters([_small_model(1, 6) for _ in range(3)]).axes) == 5
    sw = [[t(y[:20]), t(y[20:40])], [t(y[:20]), t(y[20:40])]]
    assert len(viz.plot_patches([t(x[:20]), t(x[20:40])], [t(y[:20]), t(y[20:40])],
                                sw).axes) == 2
    rng = np.random.default_rng(0)
    fig = viz.plot_fft_all(t(np.linspace(0, 8000, 64)), t(np.linspace(0, 8000, 128)),
                           [t(rng.standard_normal(128))], [t(rng.standard_normal(256))],
                           [(np.array([440.0, 880.0]), np.array([1.0, 0.5]))])
    assert len(fig.axes) >= 1
    F = t(np.linspace(0, 8000, 100))
    assert viz.plot_fft(F, torch.exp(-F / 1000), peaks=(np.array([440.0]),
                                                         np.array([0.6]))) is not None
    roll = torch.zeros(88, 40)
    roll[39, 5:20] = 1
    assert viz.plot_pianoroll(roll) is not None
    xk = t(np.linspace(0, 0.01, 50))
    assert viz.plot_kernel_fit(xk, torch.exp(-xk * 300), torch.exp(-xk * 280)) is not None
    fig = viz.plot_pdgp(t(x), t(y), t(x), m.predict_act_n_com(t(x)),
                        z=(m.za.value[0], m.zc.value[0]))
    assert len(fig.axes) == 3


# ------------------------------------------------------------------ demos
DEMO_ARGS = {
    "modgp": ["--steps", "20", "--n", "800"],
    "modgp_real_audio": ["--steps", "20", "--frames", "3200", "--partials", "3"],
    "separation": ["--seconds", "0.3", "--maxiter", "3", "--num-inducing", "16",
                   "--max-par", "2"],
    "transcription": ["--seconds", "0.3", "--maxiter", "3", "--num-inducing", "16",
                      "--max-par", "2"],
}
LOOSE = {"modgp": ["--max-rmse", "1e9"], "modgp_real_audio": ["--max-rmse", "1e9"],
         "separation": ["--max-rmse", "1e9"], "transcription": ["--min-f", "-1"]}
STRICT = {"modgp": ["--max-rmse", "0"], "modgp_real_audio": ["--max-rmse", "0"],
          "separation": ["--max-rmse", "0"], "transcription": ["--min-f", "2"]}


@pytest.mark.parametrize("name", sorted(DEMO_ARGS))
def test_torch_demo_main_runs_on_the_cpu(name, capsys, tmp_path, monkeypatch, _close_figs):
    """Each demo at tiny size on the CPU prints its result line and exits 0
    under a loose threshold (with --plot, into a scratch directory) and 1
    under an impossible one."""
    monkeypatch.chdir(tmp_path)
    demo = importlib.import_module(f"gpitch_tpu_torch.demos.{name}")
    args = DEMO_ARGS[name] + ["--device", "cpu"]
    assert demo.main(args + LOOSE[name] + ["--plot"]) == 0
    out = capsys.readouterr().out
    assert ("RMSE" in out) if name != "transcription" else ("F-measure" in out), out
    assert "saved demo-" in out and any(f.endswith(".png") for f in os.listdir(tmp_path))
    assert demo.main(args + STRICT[name]) == 1
