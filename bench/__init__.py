"""The benchmark of repro_torch: one cell of BENCHMARK.json a run."""
