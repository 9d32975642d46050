"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01; unverified].

Dense GQA decoder, no biases. 64L, d_model 12288, 96 heads (kv 8),
d_ff 33792, vocab 256000.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    rope_theta=75_000_000.0,
)
