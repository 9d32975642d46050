"""Hymba 1.5B — hybrid parallel attention+SSM heads [arXiv:2411.13676; hf].

32L, d_model 1600, 25 heads (kv 5, head_dim 64), d_ff 5504, vocab 32001,
ssm_state 16. Every layer runs attention and a Mamba branch in parallel
(learned per-channel mix). Hymba uses full attention on 3 layers and
sliding-window elsewhere; we approximate the {first, middle, last} global
placement with a period-8 pattern (globals at layers 8,16,24,32 — noted in
DESIGN.md). long_500k RUNS (windowed attention + O(1) SSM state).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_SWA = LayerSpec(kind="hybrid", window=1024, ffn="dense")
_GLB = LayerSpec(kind="hybrid", window=None, ffn="dense")

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    pattern=(_SWA, _SWA, _SWA, _SWA, _SWA, _SWA, _SWA, _GLB),
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
)
