"""Model assembly: the port of the JAX package's ``models/transformer.py``
for all ten configs.

``Transformer`` holds one module a layer, ``prologue + pattern ×
n_pattern_groups`` unrolled in that order (the reference stacks each pattern
position's layers along a group axis and scans; ``lm_params_from_arrays``
in ``convert.py`` unstacks them), and for the encoder-decoder config the
encoder's layers the same way. Weights keep the reference's ``(in, out)``
layout and are applied as ``x @ w``; names follow its param tree
(``layers.{i}.attn.wq`` is the reference's ``groups[pi]["attn"]["wq"][g]``,
``encoder.{j}.ffn.w_up`` its ``encoder["ffn"]["w_up"][j]``).

Layer kinds: ``attn`` (GQA, global or sliding-window), ``mla`` (latent
attention), ``ssm`` (Mamba2), ``hybrid`` (attention and SSM heads side by
side, Hymba), ``cross`` (the VLM's cross-attention to media states); FFNs
``dense`` (SwiGLU), ``moe`` or ``none``. Whisper's decoder layers
self-attend, then cross-attend to the encoder's states (``xattn``), then
run the FFN; its encoder is bidirectional.

A layer's cache is a :class:`LayerCache` (``serving/cache.py`` makes them):
a GQA or MLA ring, an SSM state, and the cross K/V of the media or encoder
states. The reference makes the cross K/V caches as zeros and never fills
them; here a prefill projects the media into them (``serving/engine.py``
says why).

Training (``training/train.py``): the weights are frozen until a training
step turns their gradients on; ``forward(..., with_aux=True)`` also returns
the MoE load-balance loss, and with ``cfg.remat`` each pattern group and
each encoder layer is recomputed in the backward (``torch.utils.checkpoint``)
where the reference wraps its scan body in ``jax.checkpoint``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    CrossKV, KVCache, MLACache, cross_kv_project, gqa_attention, mla_attention,
)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (
    embed, gelu, rms_norm, silu, swiglu_ffn, truncated_normal, unembed,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import SSMCache, mamba_block

#: the leaves the reference keeps in float32 whatever ``cfg.dtype`` is
FLOAT32_LEAVES = frozenset({"router", "A_log", "dt_bias", "D"})
#: the output projections, drawn with std 0.02 / sqrt(2·n_layers)
OUT_LEAVES = frozenset({"wo", "w_down", "ws_down", "out_proj"})
#: the leaves drawn as constants: norms 0, ``mix_*`` 0.5, ``D`` 1 and the
#: SSM's biases and log-rates 0
CONST_LEAVES = {"ln1": 0.0, "ln2": 0.0, "ln_x": 0.0, "final_norm": 0.0,
                "enc_final_norm": 0.0, "mix_a": 0.5, "mix_s": 0.5,
                "conv_b": 0.0, "A_log": 0.0, "dt_bias": 0.0, "D": 1.0}
ENCODER_SPEC = LayerSpec(kind="attn", window=None, ffn="dense")


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """The stack's layers in order: prologue, then the pattern repeated."""
    return list(cfg.prologue) + list(cfg.pattern) * cfg.n_pattern_groups


def uses_media(cfg: ModelConfig) -> bool:
    """Whether the model reads media: an encoder, or cross layers."""
    return bool(cfg.n_enc_layers) or any(s.kind == "cross"
                                         for s in layer_specs(cfg))


def _attn_shapes(cfg: ModelConfig) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (d, H * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd),
            "wo": (H * hd, d)}


def _mla_shapes(cfg: ModelConfig) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    r, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
    return {"wq": (d, H * (hd + rd)), "w_dkv": (d, r), "w_krope": (d, rd),
            "w_ukv": (r, H * 2 * hd), "wo": (H * hd, d)}


def _ssm_shapes(cfg: ModelConfig) -> dict:
    d, di, N = cfg.d_model, cfg.d_ssm_inner, cfg.ssm_state
    H, K = cfg.n_ssm_heads, cfg.ssm_conv
    return {"in_proj": (d, 2 * di + 2 * N + H), "conv_w": (K, di + 2 * N),
            "conv_b": (di + 2 * N,), "A_log": (H,), "dt_bias": (H,),
            "D": (H,), "out_proj": (di, d)}


def _ffn_shapes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    if spec.ffn == "none":
        return {}
    if spec.ffn == "moe":
        E, f = cfg.n_experts, cfg.moe_dff
        out = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
               "w_down": (E, f, d)}
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            out.update(ws_gate=(d, fs), ws_up=(d, fs), ws_down=(fs, d))
        return out
    f = cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec,
                  decoder_cross: bool) -> dict[str, tuple[int, ...]]:
    """One layer's leaves as ``_init_layer`` makes them, ``group.leaf``."""
    d = cfg.d_model
    groups: dict[str, dict] = {}
    if spec.kind in ("attn", "cross", "hybrid"):
        groups["attn"] = _attn_shapes(cfg)
    elif spec.kind == "mla":
        groups["attn"] = _mla_shapes(cfg)
    if spec.kind in ("ssm", "hybrid"):
        groups["ssm"] = _ssm_shapes(cfg)
    if decoder_cross:  # whisper decoder: the cross-attention sublayer
        groups["xattn"] = _attn_shapes(cfg)
    groups["ffn"] = _ffn_shapes(cfg, spec)
    out = {"ln1": (d,), "ln2": (d,)}
    if spec.kind == "hybrid":
        out.update(mix_a=(d,), mix_s=(d,))
    if decoder_cross:
        out["ln_x"] = (d,)
    for g, leaves in groups.items():
        out.update({f"{g}.{k}": s for k, s in leaves.items()})
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Every weight's name and shape, in ``Transformer``'s naming."""
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab, d)
    dec_cross = cfg.n_enc_layers > 0
    for i, spec in enumerate(layer_specs(cfg)):
        shapes.update({f"layers.{i}.{k}": s for k, s in
                       _layer_shapes(cfg, spec, dec_cross).items()})
    for j in range(cfg.n_enc_layers):
        shapes.update({f"encoder.{j}.{k}": s for k, s in
                       _layer_shapes(cfg, ENCODER_SPEC, False).items()})
    if cfg.n_enc_layers:
        shapes["enc_final_norm"] = (d,)
    return shapes


def tree_slots(cfg: ModelConfig) -> dict[str, tuple[tuple, int | None]]:
    """Every port weight name and where the reference's param tree holds
    it: ``(path, g)``, ``path`` the keys and list indices from the root,
    ``g`` the index along a stacked leaf's first axis (None if unstacked).
    Layer ``i`` past the prologue is ``groups[pi][...][g]`` with ``i =
    len(prologue) + g·len(pattern) + pi``; encoder layer j is
    ``encoder[...][j]``."""
    n_pro, n_pat = len(cfg.prologue), len(cfg.pattern)
    out = {}
    for name in param_shapes(cfg):
        parts = name.split(".")
        if parts[0] == "layers":
            i, rest = int(parts[1]), tuple(parts[2:])
            if i < n_pro:
                out[name] = (("prologue", i) + rest, None)
            else:
                g, pi = divmod(i - n_pro, n_pat)
                out[name] = (("groups", pi) + rest, g)
        elif parts[0] == "encoder":
            out[name] = (("encoder",) + tuple(parts[2:]), int(parts[1]))
        else:
            out[name] = ((name,), None)
    return out


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """A weight's dtype: float32 for the router and the SSM's ``A_log``,
    ``dt_bias`` and ``D``, as in the reference; ``cfg.dtype`` otherwise."""
    return torch.float32 if name.rsplit(".", 1)[-1] in FLOAT32_LEAVES else cfg.dtype


def abstract_params(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Every weight as a ``meta`` tensor of its shape and dtype: nothing
    allocated (the dry run's)."""
    return {name: torch.empty(shape, dtype=param_dtype(cfg, name),
                              device="meta")
            for name, shape in param_shapes(cfg).items()}


def _param(t: torch.Tensor) -> nn.Parameter:
    """Weights are frozen: serving builds no autograd graph. A training
    step turns their gradients on for its own forward and backward."""
    return nn.Parameter(t, requires_grad=False)


def _group(p: dict, name: str) -> nn.ParameterDict:
    pre = name + "."
    return nn.ParameterDict({k[len(pre):]: _param(v) for k, v in p.items()
                             if k.startswith(pre)})


@dataclass
class LayerCache:
    """One layer's serving state: ``kv`` a GQA or MLA ring, ``ssm`` the SSM
    state, ``xkv`` the VLM cross layer's media K/V, ``ekv`` Whisper's
    encoder K/V; the kinds a layer does not have are None."""
    kv: KVCache | MLACache | None = None
    ssm: SSMCache | None = None
    xkv: CrossKV | None = None
    ekv: CrossKV | None = None

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(t for c in (self.kv, self.ssm, self.xkv, self.ekv)
                     if c is not None for t in c.tensors())


def _cross_kv(cfg: ModelConfig, p, states, cache: CrossKV | None):
    """The cross K/V of a layer: projected from ``states`` when they are
    given (a forward, or a prefill, which writes them into ``cache``), read
    from a filled ``cache`` when not (a decode step)."""
    if states is None:
        if cache is None or not cache.filled:
            raise ValueError(
                f"{cfg.name}: a cross layer needs media states, or caches "
                "that a prefill with media has filled")
        return cache.k, cache.v
    k, v = cross_kv_project(p, states, n_kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.head_dim)
    if cache is not None:
        if cache.k.shape != k.shape:
            raise ValueError(f"{cfg.name}: media K/V {tuple(k.shape)}, the "
                             f"cache holds {tuple(cache.k.shape)}")
        cache.k.copy_(k)
        cache.v.copy_(v)
        cache.filled = True
    return k, v


class DecoderLayer(nn.Module):
    """Pre-norm mixing (attention, MLA, SSM, both side by side, or
    cross-attention), Whisper's cross-attention to the encoder, then the
    FFN, each added to the stream. ``forward`` returns ``(x, aux)``: the
    MoE load-balance loss, or None for another FFN. A MoE layer keeps its
    last call's ``(aux, dropped)`` in ``moe_stats``, detached (device
    scalars): they hold no autograd graph alive after a training step."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, p: dict):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        for name in ("ln1", "ln2", "ln_x", "mix_a", "mix_s"):
            if name in p:
                setattr(self, name, _param(p[name]))
        for name in ("attn", "ssm", "xattn", "ffn"):
            setattr(self, name, _group(p, name))
        self.act = silu if cfg.act == "silu" else gelu
        self.moe_stats = None

    def forward(self, x, positions, cache: LayerCache | None = None,
                pos: int | None = None, media_states=None, enc_states=None):
        cfg, spec = self.cfg, self.spec
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        c = cache or LayerCache()
        if spec.kind in ("attn", "hybrid"):
            a = gqa_attention(self.attn, h, positions, window=spec.window,
                              cache=c.kv, pos=pos, **kw)
            if spec.kind == "attn":
                x = x + a
        if spec.kind == "cross":
            mkv = _cross_kv(cfg, self.attn, media_states, c.xkv)
            x = x + gqa_attention(self.attn, h, positions, cross_kv=mkv, **kw)
        elif spec.kind == "mla":
            x = x + mla_attention(
                self.attn, h, positions, n_heads=cfg.n_heads,
                head_dim=cfg.head_dim, rope_dim=cfg.mla_rope_dim, rope_theta=cfg.rope_theta,
                cache=c.kv, pos=pos)
        elif spec.kind == "ssm":
            x = x + mamba_block(self.ssm, h, cfg=cfg, cache=c.ssm)
        elif spec.kind == "hybrid":
            m = mamba_block(self.ssm, h, cfg=cfg, cache=c.ssm)
            x = x + a * self.mix_a + m * self.mix_s

        if len(self.xattn):  # whisper decoder: cross-attend to the encoder
            hx = rms_norm(x, self.ln_x, cfg.norm_eps)
            ekv = _cross_kv(cfg, self.xattn, enc_states, c.ekv)
            x = x + gqa_attention(self.xattn, hx, positions, cross_kv=ekv,
                                  **kw)

        aux = None
        if spec.ffn != "none":
            h2 = rms_norm(x, self.ln2, cfg.norm_eps)
            f = self.ffn
            if spec.ffn == "moe":
                y, (aux, dropped) = moe_ffn(
                    f, h2, n_experts=cfg.n_experts, topk=cfg.topk,
                    capacity_factor=cfg.capacity_factor,
                    n_shared=cfg.n_shared_experts)
                self.moe_stats = (aux.detach(), dropped.detach())
            else:
                y = swiglu_ffn(h2, f["w_gate"], f["w_up"], f["w_down"],
                               self.act)
            x = x + y
        return x, aux


class EncoderLayer(nn.Module):
    """Whisper's encoder layer: bidirectional self-attention, then a SwiGLU
    FFN with gelu, each pre-norm and added to the stream."""

    def __init__(self, cfg: ModelConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param(p["ln1"])
        self.ln2 = _param(p["ln2"])
        self.attn = _group(p, "attn")
        self.ffn = _group(p, "ffn")

    def forward(self, x, positions):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        x = x + gqa_attention(
            self.attn, h, positions, causal=False, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta)
        h2 = rms_norm(x, self.ln2, cfg.norm_eps)
        f = self.ffn
        return x + swiglu_ffn(h2, f["w_gate"], f["w_up"], f["w_down"], gelu)


def _arange(S: int, B: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


class Transformer(nn.Module):
    """The stack over ``params``, a ``{name: tensor}`` dict in
    ``param_shapes``' naming (taken as they are, not copied)."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
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

        def sub(pre: str) -> dict:
            return {k[len(pre):]: v for k, v in params.items()
                    if k.startswith(pre)}

        self.layers = nn.ModuleList(
            DecoderLayer(cfg, spec, sub(f"layers.{i}."))
            for i, spec in enumerate(layer_specs(cfg)))
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, sub(f"encoder.{j}."))
            for j in range(cfg.n_enc_layers))
        if cfg.n_enc_layers:
            self.enc_final_norm = _param(params["enc_final_norm"])

    @property
    def table(self) -> torch.Tensor:
        """The unembedding table: ``embed`` when the embeddings are tied."""
        return self.embed if self.cfg.tie_embeddings else self.unembed

    def encoder_forward(self, media: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings (B, T, d):
        bidirectional, then ``enc_final_norm``. The conv front end is a stub
        in the reference too: ``media`` is the post-conv embedding."""
        x = media.to(self.cfg.dtype)
        positions = _arange(x.shape[1], x.shape[0], x.device)
        for layer in self.encoder:
            x = (_checkpoint(layer, x, positions) if self._remat()
                 else layer(x, positions))
        return rms_norm(x, self.enc_final_norm, self.cfg.norm_eps)

    def media_states(self, media) -> dict:
        """``apply_stack``'s media arguments from ``media`` (B, T, d): the
        encoder's states for an encoder-decoder model, the media states in
        ``cfg.dtype`` for one with cross layers. A model that reads media
        and gets none, or one that reads none and gets some, raises
        ``ValueError``."""
        cfg = self.cfg
        if not uses_media(cfg):
            if media is not None:
                raise ValueError(f"{cfg.name}: this model reads no media")
            return {}
        if media is None:
            raise ValueError(f"{cfg.name}: this model needs media "
                             f"(B, T, {cfg.d_model})")
        if cfg.n_enc_layers:
            return {"enc_states": self.encoder_forward(media)}
        return {"media_states": media.to(cfg.dtype)}

    def _remat(self) -> bool:
        """Whether to recompute activations in the backward: ``cfg.remat``
        while the weights are being trained (``make_train_step`` turns their
        gradients on for a step), never while serving."""
        return (self.cfg.remat and torch.is_grad_enabled()
                and self.embed.requires_grad)

    def _run_layers(self, lo: int, hi: int, x, aux, positions, caches, pos,
                    media_states, enc_states):
        for i in range(lo, hi):
            x, a = self.layers[i](x, positions,
                                  None if caches is None else caches[i], pos,
                                  media_states, enc_states)
            if a is not None:
                aux = aux + a
        return x, aux

    def apply_stack(self, x, positions, caches=None, pos: int | None = None,
                    media_states=None, enc_states=None):
        """Run every layer; returns ``(x, aux)``, the MoE load-balance
        losses added in stack order from float32 0 (the reference's
        ``apply_stack``). With ``caches`` (a ``LayerCache`` a layer) a
        prefill (S > 1) fills them and a decode (S == 1, at the Python int
        ``pos``) writes and reads them. Media or encoder states, given, are
        projected for the cross layers (and into their caches). Under
        ``_remat`` each pattern group runs in one activation checkpoint, the
        prologue outside them, as the reference's scan body."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        args = (positions, caches, pos, media_states, enc_states)
        n_pro = len(cfg.prologue)
        x, aux = self._run_layers(0, n_pro, x, aux, *args)
        if not self._remat():
            return self._run_layers(n_pro, len(self.layers), x, aux, *args)
        n_pat = len(cfg.pattern)
        for lo in range(n_pro, len(self.layers), n_pat):
            x, aux = _checkpoint(self._run_layers, lo, lo + n_pat, x, aux,
                                 *args)
        return x, aux

    def moe_stats(self) -> list:
        """``(aux, dropped)`` of every MoE layer's last call, in stack
        order (device scalars)."""
        return [layer.moe_stats for layer in self.layers
                if layer.spec.ffn == "moe"]

    def forward(self, tokens, media=None, *, with_aux: bool = False):
        """The causal forward from position 0: float32 logits (B, S, vocab),
        and with ``with_aux`` the reference's second output too,
        ``(logits, aux)``: the MoE load-balance losses summed in stack
        order (float32 0 without MoE layers)."""
        B, S = tokens.shape
        x = embed(tokens, self.embed).to(self.cfg.dtype)
        x, aux = self.apply_stack(x, _arange(S, B, tokens.device),
                                  **self.media_states(media))
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = unembed(x, self.table)
        return (logits, aux) if with_aux else logits


def init_params(cfg: ModelConfig, seed: int, device=None) -> Transformer:
    """Random weights from ``seed``, drawn on the device, with the
    reference's standard deviations (0.02; the output projections 0.02 /
    sqrt(2·n_layers)) and constants (norms 0, ``mix_*`` 0.5, ``D`` 1, the
    SSM's ``A_log``, ``dt_bias`` and ``conv_b`` 0). The draws are not the
    reference's: ``lm_params_from_arrays`` carries its weights across."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s, s_out = 0.02, 0.02 / (2 * cfg.n_layers) ** 0.5
    params = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        dtype = param_dtype(cfg, name)
        if leaf in CONST_LEAVES:
            params[name] = torch.full(shape, CONST_LEAVES[leaf], dtype=dtype,
                                      device=device)
        else:
            std = s_out if leaf in OUT_LEAVES else s
            params[name] = truncated_normal(shape, std, dtype, device, gen)
    return Transformer(cfg, params)
