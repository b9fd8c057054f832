"""The benchmark of gpitch_tpu_torch: see run.py and BENCHMARK.json."""
