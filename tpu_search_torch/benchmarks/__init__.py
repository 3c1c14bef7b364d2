"""Benchmarks of the port, each runnable as ``python -m
tpu_search_torch.benchmarks.<name>``."""
