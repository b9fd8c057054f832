from .fit import fit_adam, fit_adam_segmented  # noqa: F401
from .sgpr import SGPR, SGPRSS  # noqa: F401
