"""The benchmark of stark_tpu_torch on an NVIDIA H100 (`BENCHMARK.json`)."""
