from .chol import cholesky_batched, cholesky_plain  # noqa: F401
from .ops import add_jitter, chol_inv, safe_chol_inv, tri_inv_blocked  # noqa: F401
from .specmix import specmix_matrix, specmix_plain  # noqa: F401
