"""gpitch_tpu_torch: the PyTorch/CUDA port of gpitch_tpu.

It imports torch, numpy and scipy, never JAX or the JAX package, and
changes no global torch state when imported (matplotlib is imported by
``viz`` only when a plot is drawn, ``torch.distributed`` by ``parallel``
only when a group is used).  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.  The hand-written CUDA kernels (csrc/) are
built with nvcc at first use.

Top-level names, as the JAX package's: the subpackages, the models and
fits, the numerics settings and the host helpers.
"""

from . import (audio, config, kernels, likelihoods, linalg, models, parallel,
               pipelines, utils)
from .audio.windowing import segmented
from .config import (NumericsConfig, default_float, default_jitter,
                     init_settings, set_jitter)
from .core import (Param, constrained, gauss_hermite_moments, hermgauss, module,
                   param, positive_param, static_field)
from .models import GPR, SGPR, SGPRSS, ModGP, fit_adam, fit_lbfgs, predict_windowed
from .utils.files import (append_sources, load_filenames, load_pitch_params_data,
                          loadm, merge_all)
from .utils.math import (find_ideal_f0, freq2midi, gaussfun, ilogistic,
                         isoftplus, logistic, midi2freq, norm, softplus)

__version__ = "0.1.0"

__all__ = [
    "audio", "config", "core", "kernels", "likelihoods", "linalg", "models",
    "parallel", "pipelines", "utils", "segmented", "NumericsConfig",
    "default_float", "default_jitter", "init_settings", "set_jitter", "Param",
    "constrained", "gauss_hermite_moments", "hermgauss", "module", "param",
    "positive_param", "static_field", "GPR", "SGPR", "SGPRSS", "ModGP",
    "fit_adam", "fit_lbfgs", "predict_windowed", "append_sources",
    "load_filenames", "load_pitch_params_data", "loadm", "merge_all",
    "find_ideal_f0", "freq2midi", "gaussfun", "ilogistic", "isoftplus",
    "logistic", "midi2freq", "norm", "softplus",
]
