"""Model configuration: one dataclass covering all 10 assigned families, a
copy of the JAX package's ``models/config.py`` with ``dtype`` a torch dtype.

Layers are described by a repeating *pattern* of layer specs; the stack is
``prologue + pattern * (n_layers // len(pattern))``. The port unrolls the
stack (one module a layer); the execution knobs ``remat``, ``scan_layers``,
``seq_shard`` and ``grad_compress`` are kept so that configs compare field by
field with the reference's, and serving ignores them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch


@dataclass(frozen=True)
class LayerSpec:
    """One layer's shape within the repeating pattern."""

    kind: str = "attn"  # attn | mla | ssm | hybrid | cross
    window: int | None = None  # sliding-window size (None = global)
    ffn: str = "dense"  # dense | moe | none


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads

    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    prologue: tuple[LayerSpec, ...] = ()  # non-repeated leading layers

    # --- MLA (DeepSeek) ---
    mla_kv_lora: int = 0
    mla_rope_dim: int = 64

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    moe_dff: int = 0  # per-expert FFN width (d_ff of the dense path if 0)
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # --- encoder-decoder (Whisper) ---
    n_enc_layers: int = 0
    enc_is_causal: bool = False

    # --- VLM / audio frontends are stubs: inputs are precomputed embeddings
    n_media_tokens: int = 0  # image patches / audio frames per sample

    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: object = torch.bfloat16

    # --- execution knobs of the reference (serving ignores them) ---
    remat: bool = True
    scan_layers: bool = True
    seq_shard: bool = True  # SP: shard activations' seq dim over 'model'
    grad_compress: bool = False  # int8 error-feedback gradient all-reduce

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def n_pattern_groups(self) -> int:
        body = self.n_layers - len(self.prologue)
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {body} layers not divisible by pattern "
            f"{len(self.pattern)}"
        )
        return body // len(self.pattern)

    @property
    def d_ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_ssm_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb

        def attn_p():
            return d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d

        def mla_p():
            r, rd = self.mla_kv_lora, self.mla_rope_dim
            return (
                d * n_q * (hd + rd)  # q (nope+rope)
                + d * (r + rd)  # kv down + shared k_rope
                + r * n_kv * (hd + hd)  # kv up (k_nope, v)
                + n_q * hd * d  # o
            )

        def ssm_p():
            di, ns, nh = self.d_ssm_inner, self.ssm_state, self.n_ssm_heads
            return (
                d * (2 * di + 2 * ns + nh)  # in_proj (x, z, B, C, dt)
                + self.ssm_conv * (di + 2 * ns)  # conv
                + 2 * nh  # A_log, D
                + di * d  # out_proj
            )

        def ffn_p(spec: LayerSpec):
            if spec.ffn == "none":
                return 0
            if spec.ffn == "moe":
                per = 3 * d * self.moe_dff
                return (
                    self.n_experts * per
                    + self.n_shared_experts * per
                    + d * self.n_experts  # router
                )
            return 3 * d * self.d_ff

        layers = list(self.prologue) + list(self.pattern) * self.n_pattern_groups
        for spec in layers:
            if spec.kind in ("attn", "cross"):
                total += attn_p()
            elif spec.kind == "mla":
                total += mla_p()
            elif spec.kind == "ssm":
                total += ssm_p()
            elif spec.kind == "hybrid":
                total += attn_p() + ssm_p()
            total += ffn_p(spec) + 2 * d  # two norms
            if self.n_enc_layers:  # enc-dec: every decoder layer cross-attends
                total += attn_p() + d
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn_p() + 3 * d * self.d_ff + 2 * d)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: topk + shared experts only)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        per = 3 * d * self.moe_dff
        n_moe_layers = sum(
            1
            for s in list(self.prologue)
            + list(self.pattern) * self.n_pattern_groups
            if s.ffn == "moe"
        )
        inactive = n_moe_layers * (self.n_experts - self.topk) * per
        return self.n_params() - inactive

    def with_groups(self, k: int) -> "ModelConfig":
        """Same config with k pattern groups (and proportionally scaled
        encoder), unrolled — used by the dry-run to recover exact depth-linear
        cost terms (XLA's cost_analysis counts scan bodies once)."""
        enc = 0
        if self.n_enc_layers:
            enc = max(1, round(self.n_enc_layers * k / self.n_pattern_groups))
        return replace(
            self,
            name=f"{self.name}@g{k}",
            n_layers=len(self.prologue) + len(self.pattern) * k,
            n_enc_layers=enc,
            scan_layers=False,
        )

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = len(self.pattern)
        pro = len(self.prologue)
        layers = pro + pat * min(2, self.n_pattern_groups)
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab=256,
            mla_kv_lora=32 if self.mla_kv_lora else 0,
            mla_rope_dim=8 if self.mla_kv_lora else 64,
            n_experts=min(self.n_experts, 8),
            topk=min(self.topk, 2),
            moe_dff=32 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_media_tokens=16 if self.n_media_tokens else 0,
            remat=False,
            seq_shard=False,
        )
