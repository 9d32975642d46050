"""LM training: AdamW, int8 error-feedback compression and the train step,
the port of the JAX package's ``training/``."""
