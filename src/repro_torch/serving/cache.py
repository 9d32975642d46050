"""Cache construction a config, the port of the JAX package's
``serving/cache.py``: a :class:`LayerCache` a layer holding a GQA ring, an
MLA latent ring, an SSM state and conv tail, and the cross K/V of the media
(``xkv``, the VLM's cross layers) or of the encoder's states (``ekv``, each
of Whisper's decoder layers). On a live grid a rank allocates only its shard
of each leaf, as the reference's ``cache_specs_tree`` splits it."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    CrossKV, make_gqa_cache, make_mla_cache,
)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.ssm import make_ssm_cache
from repro_torch.models.transformer import LayerCache, layer_specs


def _cross(cfg: ModelConfig, B: int, n_media: int, device) -> CrossKV:
    shape = (B, n_media, cfg.n_kv_heads, cfg.head_dim)
    return CrossKV(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device))


def _layer_cache(cfg: ModelConfig, spec: LayerSpec, B: int, max_len: int,
                 n_media: int, device) -> LayerCache:
    c = LayerCache()
    Lc = spec.window or max_len
    if spec.kind in ("attn", "hybrid"):
        c.kv = make_gqa_cache(B, Lc, cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
                              device)
    elif spec.kind == "mla":
        c.kv = make_mla_cache(B, Lc, cfg.mla_kv_lora, cfg.mla_rope_dim,
                              cfg.dtype, device)
    elif spec.kind == "cross":
        c.xkv = _cross(cfg, B, n_media, device)
    if spec.kind in ("ssm", "hybrid"):
        c.ssm = make_ssm_cache(cfg, B, device)
    if cfg.n_enc_layers:  # whisper decoder: cross K/V of the encoder frames
        c.ekv = _cross(cfg, B, n_media, device)
    return c


def make_caches(cfg: ModelConfig, B: int, max_len: int,
                n_media: int | None = None, device=None,
                grid=None) -> list[LayerCache]:
    """One cache a layer, in stack order: ``Lc = window`` for a
    sliding-window layer, ``max_len`` for a global one; cross K/V for
    ``n_media`` media tokens or encoder frames (``cfg.n_media_tokens`` by
    default). For Whisper ``max_len`` counts the decoder's own positions
    only (448 in its serving shapes).

    On a live ``grid`` (``launch/lm_mesh.py::ProcessGrid``) the caches of
    the global batch ``B`` as this rank holds them: each leaf its shard
    (``grid.cache_shard``: the batch over 'data', the slots, frames, SSM
    heads or conv channels over 'model'), a cache split by slots or frames
    naming its block in ``seq``; nothing whole is allocated."""
    device = resolve_device(device)
    n_media = n_media if n_media is not None else cfg.n_media_tokens
    if grid is None:
        return [_layer_cache(cfg, spec, B, max_len, n_media, device)
                for spec in layer_specs(cfg)]
    caches = [_layer_cache(cfg, spec, B, max_len, n_media, "meta")
              for spec in layer_specs(cfg)]
    for name, t in list(cache_leaves(caches)):
        _, i, field, leaf = name.split(".")
        spec, idx = grid.cache_shard(name, t.shape)
        sub = getattr(caches[int(i)], field)
        setattr(sub, leaf, torch.full(
            tuple(s.stop - s.start for s in idx), -1 if leaf == "pos" else 0,
            dtype=t.dtype, device=device))
        if leaf in ("k", "c_kv") and spec[1] is not None:
            sub.seq = (idx[1].start, idx[1].stop)
    return caches


def abstract_caches(cfg: ModelConfig, B: int, max_len: int,
                    n_media: int | None = None) -> list[LayerCache]:
    """``make_caches`` on ``meta``: the shapes and dtypes, nothing
    allocated (the dry run's)."""
    return make_caches(cfg, B, max_len, n_media, device="meta")


def cache_leaves(caches: list[LayerCache]):
    """``(name, tensor)`` of every cache tensor, named
    ``layers.{i}.{field}.{leaf}`` after the cache's fields (``kv.k``,
    ``kv.c_kv``, ``ssm.state``, ``xkv.v``, ...)."""
    for i, c in enumerate(caches):
        for field in dataclasses.fields(c):
            sub = getattr(c, field.name)
            if sub is None:
                continue
            for f in dataclasses.fields(sub):
                t = getattr(sub, f.name)
                if isinstance(t, torch.Tensor):
                    yield f"layers.{i}.{field.name}.{f.name}", t


def cache_bytes(caches: list[LayerCache]) -> int:
    return sum(t.numel() * t.element_size()
               for c in caches for t in c.tensors())
