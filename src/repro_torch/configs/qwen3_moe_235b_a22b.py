"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B; hf].

94L, d_model 4096, 64 heads (GQA kv 4, head_dim 128), per-expert d_ff 1536,
vocab 151936. 128 experts, top-8, no shared experts.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    pattern=(LayerSpec(kind="attn", ffn="moe"),),
    n_experts=128,
    topk=8,
    moe_dff=1536,
)
