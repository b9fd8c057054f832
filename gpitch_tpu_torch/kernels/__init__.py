from .base import (Constant, Kernel, Product, StackedSum, Sum, White, absdist,  # noqa: F401
                   euclid_dist, sqdist, stack_modules, unstack_modules)
from .feature import Env, Hann, KernelGPR, MeanGP, NonParam, Sig  # noqa: F401
from .spectral import (Matern12sm, Matern32sm, Matern32smOld, Matern32sml,  # noqa: F401
                       MercerCosMix, MercerMatern12sm, Spectrum, Spectrum2,
                       cos_mixture, cos_mixture_r, cosine_features)
from .stationary import (RBF, Cosine, Gammaexponential, LogisticHat, Matern12,  # noqa: F401
                         Matern32, Matern52, Stationary)

__all__ = [
    "Kernel", "Sum", "StackedSum", "Product", "White", "Constant", "absdist",
    "euclid_dist", "sqdist", "stack_modules", "unstack_modules", "RBF", "Matern12",
    "Matern32", "Matern52", "Cosine", "Gammaexponential", "LogisticHat",
    "Stationary", "Matern12sm", "Matern32sm", "Matern32smOld", "Matern32sml",
    "MercerMatern12sm", "MercerCosMix", "Spectrum", "Spectrum2", "cos_mixture",
    "cosine_features", "Sig", "Hann", "Env", "NonParam", "MeanGP", "KernelGPR",
]
