from .fit import (Adam, fit_adam, fit_adam_segmented, fit_adam_timed,  # noqa: F401
                  fit_lbfgs, fit_modgp, lbfgs_solve, minibatch_fn)
from .natgrad import fit_natgrad_adam, natgrad_polish, natgrad_step  # noqa: F401
from .sgpr import SGPR, SGPRSS  # noqa: F401
from .svgp import ModGP, predict_windowed  # noqa: F401
