"""Llama 3.2 Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L text backbone (d_model 8192, 64 heads, kv 8, d_ff 28672, vocab
128256): every 5th layer cross-attends to image patch embeddings. The
vision tower is a STUB: input_specs() provides precomputed patch
embeddings (B, 1600, d_model). long_500k SKIPPED (full attention).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_SELF = LayerSpec(kind="attn", ffn="dense")
_CROSS = LayerSpec(kind="cross", ffn="dense")

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    pattern=(_SELF, _SELF, _SELF, _SELF, _CROSS),
    n_media_tokens=1600,
)
