from .fit import (Adam, fit_adam, fit_adam_segmented, fit_adam_timed,  # noqa: F401
                  fit_modgp, minibatch_fn)
from .sgpr import SGPR, SGPRSS  # noqa: F401
from .svgp import ModGP, predict_windowed  # noqa: F401
