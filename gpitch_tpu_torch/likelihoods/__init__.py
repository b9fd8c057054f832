from .modulated import (LooLik, ModLik, ModulatedLikelihood, MpdLik, SsLik,  # noqa: F401
                        exp_value_closed_form, gaussian_logdensity, log_lik_exp)

__all__ = [
    "ModulatedLikelihood", "ModLik", "LooLik", "SsLik", "MpdLik",
    "exp_value_closed_form", "gaussian_logdensity", "log_lik_exp",
]
