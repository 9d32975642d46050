"""Minitron 4B — pruned Nemotron [arXiv:2407.14679; hf].

Dense GQA decoder. 32L, d_model 3072, 24 heads (kv 8), d_ff 9216,
vocab 256000.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
)
