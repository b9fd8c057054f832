from .init import init_kern_com, init_liv, init_liv_robust  # noqa: F401
from .separation import SoSp, learn_pitch_params  # noqa: F401
from .transcription import AMT, f_measure, mad_pianoroll, pianoroll_from_variances  # noqa: F401
from .windowed_sgpr import (bank_loss, build_window_bank, optimize_bank,  # noqa: F401
                            pad_inducing, pitch_variances, predict_bank_mixture,
                            predict_bank_sources, sum_kernel)
