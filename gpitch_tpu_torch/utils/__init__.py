from .math import find_ideal_f0, freq2midi, midi2freq  # noqa: F401
