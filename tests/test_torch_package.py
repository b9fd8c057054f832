"""Guards of the PyTorch port's package rules: no JAX, no global torch
state on import, no silent move to the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gpitch_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "gpitch_tpu"), f"{path}: {mod}"


def test_import_leaves_global_torch_state_unchanged():
    code = (
        "import torch\n"
        "def state():\n"
        "    return (torch.get_default_dtype(), torch.backends.cuda.matmul.allow_tf32,\n"
        "            torch.get_float32_matmul_precision())\n"
        "before = state()\n"
        "import gpitch_tpu_torch, gpitch_tpu_torch.pipelines, gpitch_tpu_torch.linalg\n"
        "import gpitch_tpu_torch.audio, gpitch_tpu_torch.utils, gpitch_tpu_torch.native\n"
        "import sys\n"
        "assert state() == before, (before, state())\n"
        "assert 'jax' not in sys.modules and 'gpitch_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_separation_never_imports_torch_dynamo_or_sympy():
    """Build, train and predict import nothing heavy on first use: the first
    torch.optim optimizer of a process imports torch._dynamo and the first
    torch.broadcast_shapes imports sympy, one-time costs of seconds that a
    short run would pay in full."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from gpitch_tpu_torch.pipelines import SoSp\n"
        "t = np.arange(3000) / 16000.0\n"
        "y = np.sin(2 * np.pi * 262.0 * t)\n"
        "m = SoSp(train_signals=[y], train_names=['piano_M60_train.wav'], fs=16000.0,\n"
        "         mixture=(t.reshape(-1, 1), y), window_size=1001, num_inducing=16,\n"
        "         device='cpu')\n"
        "losses = m.optimize(maxiter=2)\n"
        "m.predict_f()\n"
        "assert np.isfinite(losses).all() and np.isfinite(m.compute_rmse([y]))\n"
        "heavy = [n for n in ('torch._dynamo', 'sympy') if n in sys.modules]\n"
        "assert not heavy, heavy\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_point_without_device_argument_never_runs_on_the_cpu():
    from gpitch_tpu_torch.config import resolve_device
    from gpitch_tpu_torch.pipelines import SoSp
    n = 3000
    t = np.arange(n) / 16000.0
    y = np.sin(2 * np.pi * 262.0 * t)
    kw = dict(train_signals=[y], train_names=["piano_M60_train.wav"], fs=16000.0,
              mixture=(t.reshape(-1, 1), y), window_size=1001, num_inducing=16)
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert SoSp(**kw).bank.X.raw.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SoSp(**kw)
    assert SoSp(**kw, device="cpu").bank.X.raw.device.type == "cpu"


def test_chip_smoke_refuses_without_a_card_or_outside_the_repo(tmp_path):
    """No result line without CUDA, and none from a directory that holds the
    script alone."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
