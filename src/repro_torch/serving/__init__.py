"""Serving: ring-buffer KV caches, prefill, decode and greedy generation,
ported from the JAX package's ``serving/``."""
