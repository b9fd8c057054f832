from .chol import cholesky_batched, cholesky_plain  # noqa: F401
from .fused_whiten import (fused_whiten, fused_whiten_bwd,  # noqa: F401
                           fused_whiten_bwd_plain, fused_whiten_flat,
                           fused_whiten_plain)
from .ops import add_jitter, chol_inv, safe_chol_inv, tri_inv_blocked  # noqa: F401
from .specmix import specmix_matrix, specmix_plain  # noqa: F401
