from .math import (find_ideal_f0, freq2midi, gaussfun, igaussfun, ilogistic,  # noqa: F401
                   isoftplus, logistic, midi2freq, norm, softplus)
