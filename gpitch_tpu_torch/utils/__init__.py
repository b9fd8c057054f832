from .checkpoint import (list_checkpoints, load_model, load_params, save_model,  # noqa: F401
                         save_params)
from .files import append_sources, load_filenames, merge_all_results  # noqa: F401
from .math import (find_ideal_f0, freq2midi, gaussfun, igaussfun, ilogistic,  # noqa: F401
                   isoftplus, logistic, midi2freq, norm, softplus)
from .profiling import Timer, trace  # noqa: F401

__all__ = [
    "logistic", "ilogistic", "softplus", "isoftplus", "gaussfun",
    "igaussfun", "norm", "midi2freq", "freq2midi", "find_ideal_f0",
    "save_params", "load_params", "save_model", "load_model", "list_checkpoints",
    "load_filenames", "merge_all_results", "append_sources",
    "trace", "Timer",
]
