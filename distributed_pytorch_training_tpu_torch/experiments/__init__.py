"""Builders shared by the CLIs (the JAX package's experiments/harness.py)."""
