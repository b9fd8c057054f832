from .io import read_wav, synth_piano_note  # noqa: F401
from .pianoroll import Pianoroll, read_note_table  # noqa: F401
from .spectrum import init_cparam  # noqa: F401
from .windowing import merged_mean, merged_variance, window_stack  # noqa: F401
