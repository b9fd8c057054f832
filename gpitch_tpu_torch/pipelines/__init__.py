from .init import (init_iv, init_kern, init_kern_act, init_kern_com,  # noqa: F401
                   init_kern_mercer_product, init_kernel_training,
                   init_kernel_with_trained_models, init_liv, init_liv_robust)
from .kernel_learning import (approximate_kernel, autocorr, fit_kernel,  # noqa: F401
                              fit_kernel_gabor, gabor_sum, sample_cov)
from .resume import optimize_bank_resumable  # noqa: F401
from .separation import SoSp, learn_pitch_params, load_mixture_from_sources  # noqa: F401
from .transcription import AMT, f_measure, mad_pianoroll, pianoroll_from_variances  # noqa: F401
from .windowed_sgpr import (bank_loss, build_window_bank, chunked_vmap,  # noqa: F401
                            optimize_bank, pad_inducing, pitch_variances,
                            predict_bank_mixture, predict_bank_sources, sum_kernel)

__all__ = [
    "init_liv", "init_iv", "init_kernel_training", "init_kern_act", "init_kern_com",
    "init_kern", "init_kern_mercer_product", "sample_cov", "autocorr",
    "approximate_kernel", "fit_kernel", "fit_kernel_gabor", "gabor_sum", "SoSp",
    "learn_pitch_params", "load_mixture_from_sources", "AMT",
    "pianoroll_from_variances", "f_measure", "build_window_bank", "bank_loss",
    "optimize_bank", "pad_inducing", "pitch_variances", "predict_bank_mixture",
    "predict_bank_sources", "chunked_vmap", "optimize_bank_resumable",
]
