"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf].

27L, d_model 2048, 16 heads, MLA (kv_lora 512, rope_dim 64, head_dim 128),
vocab 102400. Layer 1 dense (d_ff 10944); layers 2-27 MoE with 64 routed
experts (d_ff 1408) + 2 shared, top-6.

NOTE: the assignment line says "2 shared+160 routed top-6" — 160 routed is
the full-V2 figure; we follow the line's own "MoE 64e top-6" (the actual
V2-Lite config). Recorded in DESIGN.md §Arch-applicability.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense prologue layer width
    vocab=102400,
    prologue=(LayerSpec(kind="mla", ffn="dense"),),
    pattern=(LayerSpec(kind="mla", ffn="moe"),),
    mla_kv_lora=512,
    mla_rope_dim=64,
    n_experts=64,
    n_shared_experts=2,
    topk=6,
    moe_dff=1408,
)
