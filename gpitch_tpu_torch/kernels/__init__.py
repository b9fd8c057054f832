from .base import Kernel, StackedSum, Sum, absdist, stack_modules  # noqa: F401
from .spectral import Matern12sm, MercerMatern12sm, cos_mixture, cosine_features  # noqa: F401
from .stationary import (RBF, Cosine, Gammaexponential, LogisticHat, Matern12,  # noqa: F401
                         Matern32, Matern52, Stationary)
