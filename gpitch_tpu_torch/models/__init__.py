from .fit import (Adam, adam_step_fn, fit_adam, fit_adam_segmented,  # noqa: F401
                  fit_adam_timed, fit_lbfgs, fit_modgp, lbfgs_solve, minibatch_fn)
from .hmc import hmc_sample, model_logprob_fn  # noqa: F401
from .natgrad import fit_natgrad_adam, natgrad_polish, natgrad_step  # noqa: F401
from .sgpr import GPR, SGPR, SGPRSS  # noqa: F401
from .svgp import ModGP, predict_windowed  # noqa: F401

__all__ = ["ModGP", "predict_windowed", "GPR", "SGPR", "SGPRSS",
           "fit_adam", "fit_adam_segmented", "fit_adam_timed", "fit_modgp", "fit_lbfgs",
           "adam_step_fn", "minibatch_fn", "natgrad_step", "fit_natgrad_adam",
           "hmc_sample", "model_logprob_fn"]
