from .separation import SoSp, learn_pitch_params  # noqa: F401
from .windowed_sgpr import (bank_loss, build_window_bank, optimize_bank,  # noqa: F401
                            pad_inducing, pitch_variances, predict_bank_mixture,
                            predict_bank_sources, sum_kernel)
