"""Measurement probes of the port: the twins of the JAX package's
``probes/`` scripts, run on the card."""
