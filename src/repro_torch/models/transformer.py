"""The decoder stack: the serving slice of the JAX package's
``models/transformer.py``.

``Transformer`` holds one module a layer, ``prologue + pattern ×
n_pattern_groups`` unrolled in that order (the reference stacks each pattern
position's layers along a group axis and scans; ``lm_params_from_arrays``
in ``convert.py`` unstacks them). Weights keep the reference's ``(in, out)``
layout and are applied as ``x @ w``; names follow its param tree
(``layers.{i}.attn.wq`` is the reference's ``groups[pi]["attn"]["wq"][g]``).

Scope: ``LayerSpec(kind="attn")``, global or windowed, with ``ffn="dense"``,
tied or untied embeddings. Every other layer kind, MoE and the
encoder-decoder stack raise ``NotImplementedError`` naming their ROADMAP
item when a model or a cache is made; nothing runs in their place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import gqa_attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (
    embed, gelu, init_rms, rms_norm, silu, swiglu_ffn, truncated_normal,
    unembed,
)

ATTN = ("wq", "wk", "wv", "wo")
FFN = ("w_gate", "w_up", "w_down")


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """The stack's layers in order: prologue, then the pattern repeated."""
    return list(cfg.prologue) + list(cfg.pattern) * cfg.n_pattern_groups


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of anything
    outside the serving slice (12.1a)."""
    if cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder stack (n_enc_layers > 0) and "
            "its cross-KV caches are ROADMAP item 12.1b")
    for spec in layer_specs(cfg):
        if spec.kind == "cross":
            raise NotImplementedError(
                f"{cfg.name}: cross-attention layers are ROADMAP item 12.1b")
        if spec.kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {spec.kind!r} layers are ROADMAP item 12.2")
        if spec.ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: ffn={spec.ffn!r} is ROADMAP item 12.2")


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Every weight's name and shape, in ``Transformer``'s naming."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab, d)
    for i in range(len(layer_specs(cfg))):
        pre = f"layers.{i}."
        shapes.update({
            pre + "ln1": (d,), pre + "ln2": (d,),
            pre + "attn.wq": (d, H * hd), pre + "attn.wk": (d, Hkv * hd),
            pre + "attn.wv": (d, Hkv * hd), pre + "attn.wo": (H * hd, d),
            pre + "ffn.w_gate": (d, cfg.d_ff), pre + "ffn.w_up": (d, cfg.d_ff),
            pre + "ffn.w_down": (cfg.d_ff, d),
        })
    return shapes


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """Pre-norm self-attention then a SwiGLU FFN, each added to the stream."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, p: dict):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.ln1 = _param(p["ln1"])
        self.ln2 = _param(p["ln2"])
        self.attn = nn.ParameterDict({k: _param(p["attn." + k]) for k in ATTN})
        self.ffn = nn.ParameterDict({k: _param(p["ffn." + k]) for k in FFN})
        self.act = silu if cfg.act == "silu" else gelu

    def forward(self, x, positions, cache=None, pos=None):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        x = x + gqa_attention(
            self.attn, h, positions, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=self.spec.window, cache=cache,
            pos=pos)
        h2 = rms_norm(x, self.ln2, cfg.norm_eps)
        f = self.ffn
        return x + swiglu_ffn(h2, f["w_gate"], f["w_up"], f["w_down"], self.act)


class Transformer(nn.Module):
    """The decoder-only stack over ``params``, a ``{name: tensor}`` dict
    in ``param_shapes``' naming (taken as they are, not copied)."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        check_supported(cfg)
        shapes = param_shapes(cfg)
        if set(params) != set(shapes):
            raise ValueError(
                f"{cfg.name}: params missing {sorted(set(shapes) - set(params))}"
                f", unexpected {sorted(set(params) - set(shapes))}")
        bad = {k: (tuple(params[k].shape), s) for k, s in shapes.items()
               if tuple(params[k].shape) != s}
        if bad:
            raise ValueError(f"{cfg.name}: shapes (given, expected) {bad}")
        self.cfg = cfg
        self.embed = _param(params["embed"])
        self.final_norm = _param(params["final_norm"])
        if not cfg.tie_embeddings:
            self.unembed = _param(params["unembed"])
        self.layers = nn.ModuleList()
        for i, spec in enumerate(layer_specs(cfg)):
            pre = f"layers.{i}."
            self.layers.append(DecoderLayer(cfg, spec, {
                k[len(pre):]: v for k, v in params.items()
                if k.startswith(pre)}))

    @property
    def table(self) -> torch.Tensor:
        """The unembedding table: ``embed`` when the embeddings are tied."""
        return self.embed if self.cfg.tie_embeddings else self.unembed

    def apply_stack(self, x, positions, caches=None, pos: int | None = None):
        """Run every layer; with ``caches`` (one a layer) a prefill (S > 1)
        fills them and a decode (S == 1, at the Python int ``pos``) writes
        and reads them."""
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, None if caches is None else caches[i], pos)
        return x

    def forward(self, tokens):
        """The causal forward from position 0: float32 logits (B, S, vocab).
        The reference's second output, the MoE auxiliary loss, is 0 without
        MoE and is not returned."""
        B, S = tokens.shape
        x = embed(tokens, self.embed).to(self.cfg.dtype)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        x = self.apply_stack(x, positions)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return unembed(x, self.table)


def init_params(cfg: ModelConfig, seed: int, device=None) -> Transformer:
    """Random weights from ``seed``, drawn on the device, with the
    reference's standard deviations (0.02; the output projections 0.02 /
    sqrt(2·n_layers); norms 0). The draws are not the reference's:
    ``lm_params_from_arrays`` carries its weights across."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s, s_out = 0.02, 0.02 / (2 * cfg.n_layers) ** 0.5
    params = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "final_norm"):
            params[name] = init_rms(shape[0], cfg.dtype, device)
        else:
            std = s_out if leaf in ("wo", "w_down") else s
            params[name] = truncated_normal(shape, std, cfg.dtype, device, gen)
    return Transformer(cfg, params)
