"""Benchmarks of the port: the paper's tables on a CUDA card."""
