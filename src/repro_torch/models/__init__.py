"""The language-model scaffolding's models, ported from the JAX package's
``models/`` (config, layers, GQA attention, the decoder stack): the
self-attention layers with a dense FFN, the serving slice's scope."""
