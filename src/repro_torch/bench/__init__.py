"""Benchmarks of the port (torch twins of the reference's
``benchmarks/``): ``kernels_bench`` writes its own
``BENCH_kernels_torch.json`` when asked; ``ablations`` prints its
JSON."""
