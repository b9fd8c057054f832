"""The demos as package entry points: ``python -m
gpitch_tpu_torch.demos.<name>`` with <name> one of ``modgp``,
``modgp_real_audio``, ``separation`` and ``transcription``.  Each prints
its result line and exits non-zero when the result misses its threshold."""
