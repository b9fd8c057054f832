from .io import Audio, read_wav, readaudio, synth_piano_note, synth_tone  # noqa: F401
from .pianoroll import Pianoroll, read_note_table  # noqa: F401
from .spectrum import get_features, init_cparam, peak_indexes  # noqa: F401
from .windowing import (augmentate, get_results_arrays, get_results_arrays_noov,  # noqa: F401
                        hann, merged_mean, merged_variance, merged_x, merged_y,
                        num_windows, ola_weights, overlap_add, segmented,
                        trim_n_merge, window_stack, windowed)

__all__ = [
    "Audio", "read_wav", "readaudio", "synth_tone", "synth_piano_note", "Pianoroll",
    "read_note_table", "init_cparam", "peak_indexes", "get_features", "windowed",
    "segmented", "augmentate", "trim_n_merge", "hann", "ola_weights", "overlap_add",
    "merged_mean", "merged_variance", "merged_x", "window_stack", "num_windows",
]
