"""Gemma 3 12B [hf:google/gemma-3-1b-pt; unverified].

48L, d_model 3840, 16 heads (kv 8), head_dim 256, d_ff 15360,
vocab 262144. 5:1 local:global attention (sliding window 1024), 128k
context. long_500k RUNS for this arch: 5/6 of layers are sub-quadratic
sliding-window and global layers decode linearly per token; local layers
use ring-buffer KV caches of length `window`.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=1024, ffn="dense")
_GLOBAL = LayerSpec(kind="attn", window=None, ffn="dense")

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
