"""Modular arithmetic, primes, NTT roots, RNS base extension, samplers."""
