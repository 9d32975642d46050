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

On a live ``grid`` (``launch/lm_mesh.py::ProcessGrid``, one process a rank
of a (data, model) mesh) the model is built from one rank's shards, split as
the reference's ``param_specs`` of its ``mode`` split them: ``train``
(FSDP × TP) or ``serve`` (weight-stationary TP, the expert banks' ff over
'data'). Each layer (the encoder's too) gathers its leaves' FSDP axes
(``lm_mesh.fsdp_axes``: 'data' in training, none in serving) as it starts
and drops them as it ends (autograd keeps what its backward needs unless
``cfg.remat`` recomputes the group, gathers included). Over 'model' run
attention, MLA and cross-attention heads, SSM heads, FFN columns, the
experts (EP with the global capacity, ``moe.moe_ffn``) and the vocab; a
leaf the spec leaves whole over 'model' (a vocab, an FFN or expert bank
the axis does not divide) runs whole on every rank. Training uses
``in_proj``/``conv_*`` whole, each rank taking its heads' columns; serving
keeps them split (``ssm.mamba_block``). Serving's caches are split as the
reference's ``cache_specs_tree`` splits them (``serving/cache.py``,
``models/attention.py``). ``check_grid`` refuses a 'model' axis that
splits a query or SSM head.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    CrossKV, KVCache, MLACache, all_kv_heads, cross_kv_project, gqa_attention,
    mla_attention,
)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (
    embed, gelu, rms_norm, silu, swiglu_ffn, truncated_normal, unembed,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.sharding import copy_to, gather
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


#: the leaves a training rank of a grid uses whole, where the spec splits
#: them over 'model' (gathered) or leaves them whole (``copy_to``): every
#: rank runs all of MLA's latent and rope key and the SSM's ``B``/``C`` and
#: conv, its heads giving a part of their gradients. A serving rank uses
#: the latent's (whole under the ``serve`` specs) and runs the SSM on its
#: shards (``ssm.mamba_block``)
MODEL_WHOLE = {"train": frozenset({"attn.w_dkv", "attn.w_krope",
                                   "ssm.in_proj", "ssm.conv_w",
                                   "ssm.conv_b"}),
               "serve": frozenset({"attn.w_dkv", "attn.w_krope"})}
#: the K/V projections, used whole where the spec cuts them below a head
KV_LEAVES = frozenset({"attn.wk", "attn.wv", "xattn.wk", "xattn.wv"})


class _Layer(nn.Module):
    """What a decoder and an encoder layer share: their heads and their
    weights as the products use them, in one process or on a live grid
    (``launch/lm_mesh.py::ProcessGrid``), where they are this rank's under
    the specs of ``mode``."""

    def _on_grid(self, grid, specs, mode: str) -> None:
        from repro_torch.launch.lm_mesh import fsdp_axes

        self.grid, self.specs, self.mode = grid, specs, mode
        self.fsdp = fsdp_axes(mode)
        self._split_heads()

    def _split_heads(self) -> None:
        """The layer's heads: all of them in one process. On a grid this
        rank's H/m query heads, contiguous, and the KV heads they read.
        Where the spec cuts ``wk``/``wv`` at whole heads (Hkv divisible by
        m) the rank keeps its Hkv/m; where it cuts them below a head, or
        not at all, the layer computes every KV head (the leaves gathered
        over 'model', as GSPMD reshards them) and ``kv_index`` picks the
        one each local query head reads."""
        cfg, grid = self.cfg, self.grid
        m = 1 if grid is None else grid.size("model")
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.heads, self.kv_heads, self.kv_index = H // m, Hkv // m, None
        if Hkv % m:
            lo = grid.index("model") * (H // m)
            self.kv_heads = Hkv
            self.kv_index = torch.arange(lo, lo + H // m) // (H // Hkv)

    def _tp(self, name: str, axis: str = "model"):
        """The grid where the spec splits ``name`` over ``axis`` for its
        products (not for storage alone: ``self.fsdp``), which then run
        tensor-parallel there, else None (they run whole, alike on every
        rank, or in one process)."""
        if (self.grid is None or axis in self.fsdp
                or axis not in self.specs[name]):
            return None
        return self.grid

    def _weights(self) -> dict:
        """The layer's weights as its products use them, by name. On a
        grid each leaf's FSDP axes (``self.fsdp``) gathered; the
        ``MODEL_WHOLE`` leaves of the mode, and ``wk``/``wv`` where
        ``_split_heads`` computes every KV head, whole over 'model' too
        (gathered, or passed through ``copy_to`` where the spec leaves them
        whole: their gradients are then summed over 'model', each rank's
        heads giving a part)."""
        grid, out = self.grid, {}
        for name, w in self.named_parameters():
            if grid is not None:
                spec = self.specs[name]
                for ax in self.fsdp:
                    if ax in spec:
                        w = gather(w, grid, ax, spec.index(ax))
                if name in MODEL_WHOLE[self.mode] or (
                        self.kv_index is not None and name in KV_LEAVES):
                    w = (gather(w, grid, "model", spec.index("model"))
                         if "model" in spec else copy_to(w, grid, "model"))
            out[name] = w
        return out

    def _attn_kw(self, device) -> dict:
        cfg = self.cfg
        return dict(n_heads=self.heads, n_kv_heads=self.kv_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    grid=self.grid,
                    kv_index=(None if self.kv_index is None
                              else self.kv_index.to(device)))

    def _cross_kv(self, p: dict, states, cache: CrossKV | None):
        """The layer's cross K/V heads of media or encoder ``states``:
        projected from them when they are given (a forward, or a prefill,
        which writes them into ``cache``), else the filled ``cache`` itself
        (a decode step; ``gqa_attention`` reads it). On a grid the states
        are replicated over 'model' (each rank's heads give a part of their
        gradient) and the rank's heads projected; a cache takes every KV
        head (``all_kv_heads``) of its frames (``cache.seq``)."""
        cfg = self.cfg
        if states is None:
            if cache is None or not cache.filled:
                raise ValueError(
                    f"{cfg.name}: a cross layer needs media states, or "
                    "caches that a prefill with media has filled")
            return cache
        if self.grid is not None:
            states = copy_to(states, self.grid, "model")
        k, v = cross_kv_project(p, states, n_kv_heads=self.kv_heads,
                                head_dim=cfg.head_dim)
        if cache is not None:
            lo, hi = cache.seq or (0, k.shape[1])
            kw, vw = (all_kv_heads(t, self.grid, self.kv_index)[:, lo:hi]
                      for t in (k, v))
            if cache.k.shape != kw.shape:
                raise ValueError(f"{cfg.name}: media K/V {tuple(kw.shape)}, "
                                 f"the cache holds {tuple(cache.k.shape)}")
            cache.k.copy_(kw)
            cache.v.copy_(vw)
            cache.filled = True
        return k, v


def _sub(w: dict, group: str) -> dict:
    pre = group + "."
    return {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}


class DecoderLayer(_Layer):
    """Pre-norm mixing (attention, MLA, SSM, both side by side, or
    cross-attention), Whisper's cross-attention to the encoder, then the
    FFN, each added to the stream. ``forward`` returns ``(x, aux)``: the
    MoE load-balance loss, or None for another FFN. A MoE layer keeps its
    last call's ``(aux, dropped)`` in ``moe_stats``, detached (device
    scalars): they hold no autograd graph alive after a training step;
    ``moe_copies`` is that call's token copies (T·k, the global batch's on
    a grid) and ``moe_load`` the (E,) copies bound for each expert.

    On a grid attention and MLA run over this rank's heads, the SSM over
    its SSM heads, cross-attention to the replicated media or encoder
    states, the FFN tensor-parallel and the MoE FFN expert-parallel (its
    ff over 'data' too under the ``serve`` specs); serving's caches are
    the rank's shards."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, p: dict,
                 grid=None, specs: dict | None = None, mode: str = "train"):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        for name in ("ln1", "ln2", "ln_x", "mix_a", "mix_s"):
            if name in p:
                setattr(self, name, _param(p[name]))
        for name in ("attn", "ssm", "xattn", "ffn"):
            setattr(self, name, _group(p, name))
        self.act = silu if cfg.act == "silu" else gelu
        self.moe_stats = self.moe_copies = self.moe_load = None
        self._on_grid(grid, specs, mode)

    def _ffn(self, h2, f: dict):
        """The FFN over ``h2`` with its weights ``f``."""
        cfg, grid = self.cfg, self.grid
        if self.spec.ffn == "moe":
            y, (aux, dropped), load = moe_ffn(
                f, h2, n_experts=cfg.n_experts, topk=cfg.topk,
                capacity_factor=cfg.capacity_factor,
                n_shared=cfg.n_shared_experts, grid=grid,
                shared_grid=(self._tp("ffn.ws_gate")
                             if cfg.n_shared_experts else None),
                ff_grid=self._tp("ffn.w_gate", "data"))
            self.moe_stats = (aux.detach(), dropped.detach())
            self.moe_load = load.detach()
            rows = h2.shape[0] * (1 if grid is None else grid.size("data"))
            self.moe_copies = rows * h2.shape[1] * cfg.topk
            return y, aux
        return swiglu_ffn(h2, f["w_gate"], f["w_up"], f["w_down"], self.act,
                          self._tp("ffn.w_gate")), None

    def forward(self, x, positions, cache: LayerCache | None = None,
                pos: int | None = None, media_states=None, enc_states=None):
        cfg, spec, grid = self.cfg, self.spec, self.grid
        w, kw = self._weights(), self._attn_kw(x.device)
        c = cache or LayerCache()
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        if spec.kind in ("attn", "hybrid"):
            a = gqa_attention(_sub(w, "attn"), h, positions,
                              window=spec.window, cache=c.kv, pos=pos, **kw)
            if spec.kind == "attn":
                x = x + a
        if spec.kind == "cross":
            attn = _sub(w, "attn")
            mkv = self._cross_kv(attn, media_states, c.xkv)
            x = x + gqa_attention(attn, h, positions, cross_kv=mkv, **kw)
        elif spec.kind == "mla":
            x = x + mla_attention(
                _sub(w, "attn"), h, positions, n_heads=self.heads,
                head_dim=cfg.head_dim, rope_dim=cfg.mla_rope_dim,
                rope_theta=cfg.rope_theta, cache=c.kv, pos=pos, grid=grid)
        elif spec.kind == "ssm":
            x = x + mamba_block(_sub(w, "ssm"), h, cfg=cfg, cache=c.ssm,
                                grid=grid, serve=self.mode == "serve")
        elif spec.kind == "hybrid":
            m = mamba_block(_sub(w, "ssm"), h, cfg=cfg, cache=c.ssm,
                            grid=grid, serve=self.mode == "serve")
            x = x + a * w["mix_a"] + m * w["mix_s"]

        if len(self.xattn):  # whisper decoder: cross-attend to the encoder
            hx = rms_norm(x, w["ln_x"], cfg.norm_eps)
            xattn = _sub(w, "xattn")
            ekv = self._cross_kv(xattn, enc_states, c.ekv)
            x = x + gqa_attention(xattn, hx, positions, cross_kv=ekv, **kw)

        aux = None
        if spec.ffn != "none":
            y, aux = self._ffn(rms_norm(x, w["ln2"], cfg.norm_eps),
                               _sub(w, "ffn"))
            x = x + y
        return x, aux


class EncoderLayer(_Layer):
    """Whisper's encoder layer: bidirectional self-attention, then a SwiGLU
    FFN with gelu, each pre-norm and added to the stream. On a grid:
    head-parallel attention and a tensor-parallel FFN, as a decoder
    layer's."""

    def __init__(self, cfg: ModelConfig, p: dict, grid=None,
                 specs: dict | None = None, mode: str = "train"):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param(p["ln1"])
        self.ln2 = _param(p["ln2"])
        self.attn = _group(p, "attn")
        self.ffn = _group(p, "ffn")
        self._on_grid(grid, specs, mode)

    def forward(self, x, positions):
        cfg, w = self.cfg, self._weights()
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        x = x + gqa_attention(_sub(w, "attn"), h, positions, causal=False,
                              **self._attn_kw(x.device))
        h2 = rms_norm(x, w["ln2"], cfg.norm_eps)
        return x + swiglu_ffn(h2, w["ffn.w_gate"], w["ffn.w_up"],
                              w["ffn.w_down"], gelu, self._tp("ffn.w_gate"))


def _arange(S: int, B: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def check_grid(cfg: ModelConfig, grid) -> None:
    """Refuse what a grid does not run, under either mode's specs: a
    'model' axis that splits a query head (its size not dividing
    ``n_heads``, in a model with attention) or an SSM head (not dividing
    ``n_ssm_heads``, in one with SSM layers). Every kind of layer runs;
    a leaf the spec leaves whole over 'model' (a vocab, an FFN, an expert
    bank, ``in_proj`` that the axis does not divide) runs whole on each
    rank, and KV heads the spec cuts below a head are computed whole on
    each (``_split_heads``)."""
    m = grid.size("model")
    if m == 1:
        return
    kinds = {s.kind for s in layer_specs(cfg)}
    attends = bool(kinds & {"attn", "mla", "cross", "hybrid"}
                   or cfg.n_enc_layers)
    if attends and cfg.n_heads % m:
        raise ValueError(
            f"{cfg.name}: 'model' of {m} splits a query head: the "
            f"{cfg.n_heads} query heads do not divide into {m} parts")
    if kinds & {"ssm", "hybrid"} and cfg.n_ssm_heads % m:
        raise ValueError(
            f"{cfg.name}: 'model' of {m} splits an SSM head: the "
            f"{cfg.n_ssm_heads} SSM heads do not divide into {m} parts")


class Transformer(nn.Module):
    """The stack over ``params``, a ``{name: tensor}`` dict in
    ``param_shapes``' naming (taken as they are, not copied). With a live
    ``grid``, ``params`` holds this rank's shards, each of the shape its
    spec (``grid.param_specs(cfg, mode)``) gives it: ``mode`` ``train``
    or ``serve``."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor],
                 grid=None, mode: str = "train"):
        from repro_torch.launch.lm_mesh import fsdp_axes

        super().__init__()
        self.grid, self.mode, self.fsdp = grid, mode, fsdp_axes(mode)
        specs = None if grid is None else grid.param_specs(cfg, mode)
        shapes = param_shapes(cfg)
        if grid is not None:
            check_grid(cfg, grid)
            shapes = {k: grid.shard_shape(specs[k], s)
                      for k, s in shapes.items()}
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

        def sub(pre: str, tree=params) -> dict:
            return {k[len(pre):]: v for k, v in tree.items()
                    if k.startswith(pre)}

        self.specs = specs
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, spec, sub(f"layers.{i}."), grid,
                         None if grid is None else sub(f"layers.{i}.", specs),
                         mode)
            for i, spec in enumerate(layer_specs(cfg)))
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, sub(f"encoder.{j}."), grid,
                         None if grid is None else sub(f"encoder.{j}.", specs),
                         mode)
            for j in range(cfg.n_enc_layers))
        #: the grid where the spec splits the vocab over 'model' (embedding,
        #: logits and loss vocab-parallel), else None: the table runs whole
        #: on every rank
        self.vocab_grid = (grid if grid is not None and "model" in
                           specs["embed"] else None)
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

    def moe_dropped(self) -> list[int]:
        """The copies every MoE layer's last call dropped, in stack order
        (on a grid the global batch's: every rank's count is the same)."""
        return [round(float(layer.moe_stats[1]) * layer.moe_copies)
                for layer in self.layers if layer.spec.ffn == "moe"]

    def moe_loads(self) -> list[list[int]]:
        """The copies bound for each expert in every MoE layer's last call,
        before the capacity, in stack order (on a grid the global
        batch's)."""
        return [layer.moe_load.tolist() for layer in self.layers
                if layer.spec.ffn == "moe"]

    def forward(self, tokens, media=None, *, with_aux: bool = False):
        """The causal forward from position 0: float32 logits (B, S, vocab),
        and with ``with_aux`` the reference's second output too,
        ``(logits, aux)``: the MoE load-balance losses summed in stack
        order (float32 0 without MoE layers)."""
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        x, aux = self.apply_stack(x, _arange(S, B, tokens.device),
                                  **self.media_states(media))
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = self._unembed(x)
        return (logits, aux) if with_aux else logits

    def embed_tokens(self, tokens) -> torch.Tensor:
        """The tokens' embeddings in ``cfg.dtype`` (vocab-parallel on a
        grid that splits the vocab)."""
        return embed(tokens, self._table("embed"), self.vocab_grid).to(
            self.cfg.dtype)

    def _unembed(self, x) -> torch.Tensor:
        """Float32 logits; on a grid that splits the vocab, this rank's."""
        name = "embed" if self.cfg.tie_embeddings else "unembed"
        return unembed(x, self._table(name), self.vocab_grid)

    def head_logits(self, x) -> torch.Tensor:
        """Float32 logits over the whole vocab of normed states ``x``: on a
        grid that splits the vocab, every rank's gathered over 'model'
        (serving picks its tokens from them)."""
        logits = self._unembed(x)
        if self.vocab_grid is None:
            return logits
        return self.grid.all_gather(logits, "model", logits.dim() - 1)

    def _table(self, name: str) -> torch.Tensor:
        """The embedding or unembedding table; on a grid this rank's vocab
        rows (all of them where the spec leaves the vocab whole over
        'model'), gathered over the FSDP axes."""
        t = getattr(self, name)
        if self.grid is None:
            return t
        spec = self.specs[name]
        for ax in self.fsdp:
            if ax in spec:
                t = gather(t, self.grid, ax, spec.index(ax))
        return t


def init_weights(cfg: ModelConfig, seed: int, device, keep=None) -> dict:
    """``init_params``' weights as ``{name: tensor}``; with ``keep(name,
    leaf)`` each leaf, drawn whole (the draws follow one generator), is
    replaced by what ``keep`` returns (a rank's shard)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s, s_out = 0.02, 0.02 / (2 * cfg.n_layers) ** 0.5
    params = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        dtype = param_dtype(cfg, name)
        if leaf in CONST_LEAVES:
            t = torch.full(shape, CONST_LEAVES[leaf], dtype=dtype,
                           device=device)
        else:
            std = s_out if leaf in OUT_LEAVES else s
            t = truncated_normal(shape, std, dtype, device, gen)
        params[name] = t if keep is None else keep(name, t)
    return params


def init_params(cfg: ModelConfig, seed: int, device=None) -> Transformer:
    """Random weights from ``seed``, drawn on the device, with the
    reference's standard deviations (0.02; the output projections 0.02 /
    sqrt(2·n_layers)) and constants (norms 0, ``mix_*`` 0.5, ``D`` 1, the
    SSM's ``A_log``, ``dt_bias`` and ``conv_b`` 0). The draws are not the
    reference's: ``lm_params_from_arrays`` carries its weights across."""
    return Transformer(cfg, init_weights(cfg, seed, resolve_device(device)))
