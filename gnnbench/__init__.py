"""The benchmark of repro_torch (see BENCHMARK.json and PERF.md)."""
