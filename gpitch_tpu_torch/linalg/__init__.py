from .chol import cholesky_batched, cholesky_plain  # noqa: F401
from .fused_whiten import (fused_whiten, fused_whiten_bwd,  # noqa: F401
                           fused_whiten_bwd_plain, fused_whiten_flat,
                           fused_whiten_plain)
from .ops import (add_jitter, base_conditional, base_conditional_inv,  # noqa: F401
                  chol_inv, conditional, gauss_kl, safe_chol_inv, safe_cholesky,
                  solve_lower, solve_upper, tri_inv_blocked)
from .specmix import specmix_matrix, specmix_plain  # noqa: F401

__all__ = [
    "add_jitter", "safe_cholesky", "solve_lower", "solve_upper", "chol_inv",
    "safe_chol_inv", "conditional", "base_conditional", "base_conditional_inv",
    "gauss_kl",
]
