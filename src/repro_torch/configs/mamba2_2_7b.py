"""Mamba2 2.7B — SSD, attention-free [arXiv:2405.21060; unverified].

64L, d_model 2560, ssm_state 128, expand 2 (d_inner 5120, 80 heads of 64),
vocab 50280. No FFN (Mamba blocks only). long_500k RUNS: O(1)/token state.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,   # attention-free; attn fields unused
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    pattern=(LayerSpec(kind="ssm", ffn="none"),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)
