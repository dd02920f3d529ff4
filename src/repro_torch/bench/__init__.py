"""Benchmarks of the port (torch twins of the reference's
``benchmarks/``); each writes its own ``BENCH_*_torch.json``."""
