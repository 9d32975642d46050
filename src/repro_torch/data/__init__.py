"""Deterministic synthetic token batches (a copy of the JAX package's
``data/tokens.py``)."""
