"""Serving: ring-buffer KV caches, MLA and SSM state, cross K/V, prefill,
decode and greedy generation, ported from the JAX package's ``serving/``."""
