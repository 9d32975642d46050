"""Whisper large-v3 — encoder-decoder ASR [arXiv:2212.04356; unverified].

32 encoder + 32 decoder layers, d_model 1280, 20 heads (kv 20, MHA),
d_ff 5120, vocab 51866. The conv mel frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, frames, d_model); frames =
seq_len of the shape cell. Decode shapes = decoder steps whose cross-KV
cache covers the `seq_len` encoder frames with a 448-token causal
self-cache (the semantically right reading for enc-dec — DESIGN.md).
long_500k SKIPPED (quadratic encoder).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,  # decoder
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    act="gelu",
    n_media_tokens=1500,  # 30 s window after conv stride 2 (default)
)
