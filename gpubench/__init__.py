"""The benchmark of ddalphaamg_tpu_torch on NVIDIA GPUs (BENCHMARK.json at
the repository's root names its cells; run.py runs one)."""
