"""Benchmarks of the port on the card: the twins of the JAX package's
root ``bench_*.py`` scripts."""
