"""The language-model scaffolding's models, ported from the JAX package's
``models/``: config, layers, attention (GQA, cross, MLA), MoE, the Mamba2
SSM and the stack for every layer kind of the ten configs."""
