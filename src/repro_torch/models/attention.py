"""Attention variants: grouped-query attention (global, sliding-window or
bidirectional), cross-attention over media or encoder keys, and MLA
(DeepSeek's multi-head latent attention with its compressed KV cache): the
port of the JAX package's ``models/attention.py``.

All functions take and return (B, S, d) activations. A GQA cache is a
:class:`KVCache` of ``k``/``v`` (B, Lc, Hkv, hd) and ``pos`` (Lc,) int32,
the absolute position a slot holds (-1 empty); an MLA cache an
:class:`MLACache` of the latent ``c_kv`` (B, Lc, r), the shared rope key
``k_rope`` (B, Lc, rd) and ``pos``. Both are written in place. ``Lc =
window`` for sliding-window layers (a ring buffer) and ``Lc = max_len`` for
global ones. Three modes a call, as in the reference:

  cache=None              train forward (causal, or bidirectional)
  cache given, S > 1      prefill: attend causally AND fill the cache
  cache given, S == 1     decode: ring-write one entry, attend over cache

Cross-attention (``cross_kv=(k, v)``) applies RoPE to the queries only and
attends to every media key; ``cross_kv_project`` makes those keys once.

The arithmetic is the reference's jnp: logits and softmax in float32, masked
logits -1e30, the probabilities cast to the values' dtype before the PV
product. It is not ``F.scaled_dot_product_attention``, whose bf16 flash path
rounds elsewhere.

**Where the port departs from the reference.** The reference's prefill
(``_fill_cache``) writes the prompt's last ``Lc`` entries into slots
``0..Lc-1`` while its decode writes position ``p`` at slot ``p % Lc``. When
a prompt is longer than a window and not a multiple of it, the first decode
writes then overwrite keys still inside the window and keep keys the mask
already drops. Here prefill writes position ``p`` at slot ``p % Lc`` too, so
decode after any prompt equals the causal forward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import apply_rope, row_parallel
from repro_torch.models.sharding import copy_to

#: the masked logit, as the reference's ``jnp.where(mask, logits, -1e30)``
MASKED = -1e30


@dataclass
class KVCache:
    k: torch.Tensor  # (B, Lc, Hkv, hd)
    v: torch.Tensor  # (B, Lc, Hkv, hd)
    pos: torch.Tensor  # (Lc,) int32 absolute position of each slot, -1 empty

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.k, self.v, self.pos


@dataclass
class MLACache:
    c_kv: torch.Tensor  # (B, Lc, kv_lora) the latent
    k_rope: torch.Tensor  # (B, Lc, rope_dim) the rope key all heads share
    pos: torch.Tensor  # (Lc,) int32 absolute position of each slot, -1 empty

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.c_kv, self.k_rope, self.pos


@dataclass
class CrossKV:
    """The cross K/V of a media or encoder sequence (B, T, Hkv, hd), filled
    once by a prefill and read by every decode step after it."""
    k: torch.Tensor
    v: torch.Tensor
    filled: bool = False

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.k, self.v


def make_gqa_cache(B: int, Lc: int, n_kv_heads: int, head_dim: int, dtype,
                   device) -> KVCache:
    return KVCache(
        k=torch.zeros((B, Lc, n_kv_heads, head_dim), dtype=dtype, device=device),
        v=torch.zeros((B, Lc, n_kv_heads, head_dim), dtype=dtype, device=device),
        pos=torch.full((Lc,), -1, dtype=torch.int32, device=device),
    )


def make_mla_cache(B: int, Lc: int, kv_lora: int, rope_dim: int, dtype,
                   device) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((B, Lc, kv_lora), dtype=dtype, device=device),
        k_rope=torch.zeros((B, Lc, rope_dim), dtype=dtype, device=device),
        pos=torch.full((Lc,), -1, dtype=torch.int32, device=device),
    )


def _attend(q, k, v, mask):
    """q: (B,S,H,hd), k/v: (B,T,Hkv,hd), mask (B,S,T) or None (every key);
    query head h reads KV head h // rep, as the reference's reshape
    (B,S,Hkv,rep,hd)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, S, Hkv, rep, hd).float().permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]  # (B,Hkv,1,hd,T)
    logits = (qg @ kt) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, MASKED)
    p = torch.softmax(logits, dim=-1)  # (B,Hkv,rep,S,T)
    vg = v.permute(0, 2, 1, 3)[:, :, None]  # (B,Hkv,1,T,hd)
    out = p.to(v.dtype) @ vg  # (B,Hkv,rep,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _train_mask(positions, window, causal: bool = True):
    """(B, S, S) causal mask, windowed when ``window``; None when not
    ``causal`` (the reference's all-true mask: every key)."""
    if not causal:
        return None
    k_pos = positions[:, None, :]
    q_pos = positions[:, :, None]
    m = k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    return m


def _cache_mask(positions, cache_pos, window):
    """(B, S, Lc) mask from absolute cached positions (-1 = empty)."""
    k_pos = cache_pos[None, None, :]
    q_pos = positions[:, :, None]
    m = (k_pos >= 0) & (k_pos <= q_pos)
    if window is not None:
        m &= k_pos > q_pos - window
    return m


def _fill_cache(cache, positions, **entries) -> None:
    """Prefill from position 0: the last ``min(S, Lc)`` of each entry
    (B, S, ...), position ``p`` at slot ``p % Lc`` (the reference writes
    them at slots 0.., see the module's docstring)."""
    Lc = cache.pos.shape[0]
    S = positions.shape[1]
    take = min(S, Lc)
    pos = positions[0, S - take:]
    slots = pos.remainder(Lc).long()
    for name, e in entries.items():
        getattr(cache, name)[:, slots] = e[:, S - take:]
    cache.pos[slots] = pos.to(torch.int32)


def _ring_write(cache, pos: int, **entries) -> None:
    """Decode: write one entry (B, 1, ...) at slot ``pos % Lc``."""
    slot = pos % cache.pos.shape[0]
    for name, e in entries.items():
        getattr(cache, name)[:, slot] = e[:, 0]
    cache.pos[slot] = pos


def gqa_attention(p: dict, x, positions, *, n_heads: int, n_kv_heads: int,
                  head_dim: int, rope_theta: float, window: int | None = None,
                  causal: bool = True, cache: KVCache | None = None,
                  pos: int | None = None, cross_kv=None, grid=None,
                  kv_index: torch.Tensor | None = None):
    """Returns out (B,S,d). ``p`` holds ``wq`` (d, H·hd), ``wk``/``wv``
    (d, Hkv·hd) and ``wo`` (H·hd, d). A decode call (``cache`` given,
    S == 1) takes its position also as the Python int ``pos``, the slot it
    writes: a slot read back from the card would wait for it. With
    ``cross_kv=(k, v)``, (B, T, Hkv, hd) media or encoder keys, the queries
    attend to all T of them and ``cache`` is not used; ``causal=False`` is
    the encoder's bidirectional self-attention.

    On a live ``grid`` (training forward only) ``p`` holds this rank's
    'model' shard: ``n_heads`` query heads (``wq``'s columns, ``wo``'s
    rows) and ``n_kv_heads`` KV heads, which a contiguous split keeps in
    their groups; ``wo`` is row-parallel. Where the spec splits ``wk``/
    ``wv`` below a head, the caller gathers them whole and ``kv_index``
    picks each local query head's KV head (h // rep), of ``cross_kv`` too
    (which the caller projects with the same weights)."""
    B, S, d = x.shape
    if grid is not None:
        x = copy_to(x, grid, "model")
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    if cross_kv is not None:
        k, v = cross_kv
        if kv_index is not None:
            k, v = k[:, :, kv_index], v[:, :, kv_index]
        out = _attend(q, k, v, None)
    else:
        k = (x @ p["wk"]).reshape(B, S, n_kv_heads, head_dim)
        v = (x @ p["wv"]).reshape(B, S, n_kv_heads, head_dim)
        if kv_index is not None:
            k, v = k[:, :, kv_index], v[:, :, kv_index]
        k = apply_rope(k, positions, rope_theta)
        if cache is None or S > 1:
            out = _attend(q, k, v, _train_mask(positions, window, causal))
            if cache is not None:  # prefill
                _fill_cache(cache, positions, k=k, v=v)
        else:  # decode
            _ring_write(cache, pos, k=k, v=v)
            out = _attend(q, cache.k, cache.v,
                          _cache_mask(positions, cache.pos, window))
    out = out.reshape(B, S, n_heads * head_dim)
    y = out @ p["wo"] if grid is None else row_parallel(out, p["wo"], grid)
    return y.to(x.dtype)


def cross_kv_project(p: dict, media, *, n_kv_heads: int, head_dim: int):
    """Project media or encoder states (B, T, d) to cross K/V (B, T, Hkv,
    hd), once: no RoPE on them."""
    B, T, d = media.shape
    k = (media @ p["wk"]).reshape(B, T, n_kv_heads, head_dim)
    v = (media @ p["wv"]).reshape(B, T, n_kv_heads, head_dim)
    return k, v


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2). The cache holds only the
# rank-``kv_lora`` latent and the shared rope key; every step expands the
# whole latent to per-head keys and values through ``w_ukv``.
# ---------------------------------------------------------------------------

def _mla_attend(q_nope, q_rope, c_kv, k_rope, mask, p, H, hd, dtype):
    """q_nope (B,S,H,hd), q_rope (B,S,H,rd), c_kv (B,T,r), k_rope (B,T,rd),
    mask (B,S,T): every head has its own keys, the scale is
    1/sqrt(hd + rd)."""
    B, T, _ = c_kv.shape
    kv = (c_kv @ p["w_ukv"]).reshape(B, T, H, 2 * hd)
    k_nope, v = kv[..., :hd], kv[..., hd:]
    l_nope = q_nope.float().transpose(1, 2) @ k_nope.float().permute(0, 2, 3, 1)
    l_rope = q_rope.float().transpose(1, 2) @ k_rope.float().transpose(1, 2)[:, None]
    rd = q_rope.shape[-1]
    logits = (l_nope + l_rope) / math.sqrt(hd + rd)  # (B,H,S,T)
    logits = torch.where(mask[:, None], logits, MASKED)
    pattn = torch.softmax(logits, dim=-1)
    return (pattn.to(dtype) @ v.transpose(1, 2)).transpose(1, 2)  # (B,S,H,hd)


def mla_attention(p: dict, x, positions, *, n_heads: int, head_dim: int,
                  rope_dim: int, rope_theta: float,
                  cache: MLACache | None = None, pos: int | None = None,
                  grid=None):
    """Returns out (B,S,d). ``p`` holds ``wq`` (d, H·(hd+rd)), ``w_dkv``
    (d, r), ``w_krope`` (d, rd), ``w_ukv`` (r, H·2hd) and ``wo`` (H·hd, d);
    the modes and ``pos`` as ``gqa_attention``'s, always causal.

    On a live ``grid`` (training forward only) ``wq`` and ``w_ukv`` hold
    this rank's ``n_heads`` heads (their columns are head-major) and
    ``wo`` their rows, row-parallel; ``w_dkv`` and ``w_krope`` are whole,
    so every rank computes the whole latent and rope key (the caller
    passes them through ``copy_to``: each rank's heads give a part of
    their gradients)."""
    B, S, d = x.shape
    H, hd, rd = n_heads, head_dim, rope_dim
    if grid is not None:
        x = copy_to(x, grid, "model")
    q = (x @ p["wq"]).reshape(B, S, H, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv = x @ p["w_dkv"]  # (B,S,r) latent
    k_rope = apply_rope((x @ p["w_krope"])[:, :, None], positions,
                        rope_theta)[:, :, 0]
    if cache is None or S > 1:
        out = _mla_attend(q_nope, q_rope, c_kv, k_rope,
                          _train_mask(positions, None), p, H, hd, x.dtype)
        if cache is not None:  # prefill
            _fill_cache(cache, positions, c_kv=c_kv, k_rope=k_rope)
    else:  # decode against the latent cache
        _ring_write(cache, pos, c_kv=c_kv, k_rope=k_rope)
        out = _mla_attend(q_nope, q_rope, cache.c_kv, cache.k_rope,
                          _cache_mask(positions, cache.pos, None), p, H, hd,
                          x.dtype)
    out = out.reshape(B, S, H * hd)
    y = out @ p["wo"] if grid is None else row_parallel(out, p["wo"], grid)
    return y.to(x.dtype)
