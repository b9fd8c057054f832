from .params import (Param, constrained, load_adam_state, load_raw, module,  # noqa: F401
                     n_params, named_params, param, positive_param, static_field,
                     with_raw)
from .quadrature import expectation_gaussian_nonlin, gauss_hermite_moments, hermgauss  # noqa: F401
from .transforms import FillTriangular, Identity, Logistic, Positive, Transform  # noqa: F401

# the JAX package's names, less zero_untrainable_grads: an untrainable Param
# holds a tensor that needs no gradient, so autograd gives it none
__all__ = [
    "Param", "param", "positive_param", "module", "static_field",
    "constrained", "n_params",
    "hermgauss", "gauss_hermite_moments", "expectation_gaussian_nonlin",
    "Transform", "Identity", "Positive", "Logistic", "FillTriangular",
]
