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

**On a live grid** (``launch/lm_mesh.py::ProcessGrid``) the layer's weights
are a rank's 'model' shard: its query heads and their KV heads. Training
runs those heads. Serving keeps the caches as the reference's
``cache_specs_tree`` splits them: each cache (GQA, MLA, cross) holds the
batch rows of its data rank and, where 'model' divides its length, the
contiguous block ``seq = (lo, hi)`` of its slots or frames, every KV head
of them; the ``pos`` table stays whole. A prefill writes each rank's slots
of ``p % Lc`` (the KV heads gathered over 'model'); a decode step writes
the new entry on the rank that owns its slot, then every rank attends all
H heads (the queries gathered over 'model') over its own slots, and the
partials, each with its float32 running max and sum, are combined over
'model' in rank order (``_combine``): the sequence-parallel decode that
the dry run prices. MLA gathers its latent cache over 'model' a step and
runs its heads over all of it. A cache that 'model' does not divide is
whole on every rank, which attends its own heads over it.

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
    #: on a grid, the slots [lo, hi) that k/v hold; None: all of them
    seq: tuple[int, int] | None = None

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.k, self.v, self.pos


@dataclass
class MLACache:
    c_kv: torch.Tensor  # (B, Lc, kv_lora) the latent
    k_rope: torch.Tensor  # (B, Lc, rope_dim) the rope key all heads share
    pos: torch.Tensor  # (Lc,) int32 absolute position of each slot, -1 empty
    seq: tuple[int, int] | None = None  # as KVCache's

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.c_kv, self.k_rope, self.pos


@dataclass
class CrossKV:
    """The cross K/V of a media or encoder sequence (B, T, Hkv, hd), filled
    once by a prefill and read by every decode step after it."""
    k: torch.Tensor
    v: torch.Tensor
    filled: bool = False
    seq: tuple[int, int] | None = None  # on a grid, the frames k/v hold

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
    them at slots 0.., see the module's docstring); a shard (``cache.seq``)
    keeps those of its slots."""
    Lc = cache.pos.shape[0]
    S = positions.shape[1]
    take = min(S, Lc)
    pos = positions[0, S - take:]
    slots = pos.remainder(Lc).long()
    cache.pos[slots] = pos.to(torch.int32)
    src = torch.arange(S - take, S, device=pos.device)
    if cache.seq is not None:
        lo, hi = cache.seq
        own = (slots >= lo) & (slots < hi)
        slots, src = slots[own] - lo, src[own]
    for name, e in entries.items():
        getattr(cache, name)[:, slots] = e[:, src]


def _ring_write(cache, pos: int, **entries) -> None:
    """Decode: write one entry (B, 1, ...) at slot ``pos % Lc``, on the
    shard that holds it."""
    slot = pos % cache.pos.shape[0]
    cache.pos[slot] = pos
    lo, hi = cache.seq or (0, cache.pos.shape[0])
    if lo <= slot < hi:
        for name, e in entries.items():
            getattr(cache, name)[:, slot - lo] = e[:, 0]


def _local(k, v, kv_index):
    """The KV heads the local query heads read: ``kv_index``'s where the
    layer computes every KV head, else all of ``k``/``v``."""
    if kv_index is None:
        return k, v
    return k[:, :, kv_index], v[:, :, kv_index]


def all_kv_heads(k, grid, kv_index):
    """Every KV head of ``k`` (B, S, Hkv_local, hd) for a cache: gathered
    over 'model' where the rank computes its share of them, as it is
    where it computes all (``kv_index``) or runs alone."""
    if grid is None or grid.size("model") == 1 or kv_index is not None:
        return k
    return grid.all_gather(k, "model", 2)


def _partial(q, k, v, mask):
    """``_attend`` over some of the keys: the output (B,S,H,hd) in v's
    dtype, normalised over them, and their float32 max and sum of
    exponentials a (B, S, H)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, S, Hkv, rep, hd).float().permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]
    logits = (qg @ kt) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, MASKED)
    mx = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - mx)
    s = e.sum(-1, keepdim=True)
    vg = v.permute(0, 2, 1, 3)[:, :, None]
    out = (e / s).to(v.dtype) @ vg  # (B,Hkv,rep,S,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    stat = lambda t: t[..., 0].permute(0, 3, 1, 2).reshape(B, S, H)
    return out, stat(mx), stat(s)


def _combine(out, mx, s, grid):
    """The partials of ``_partial`` over 'model' joined into the softmax
    over every key: each rank's output weighted by its sum at the common
    max, added in rank order in float32, over the total, rounded once to
    the output's dtype. A rank whose keys are all masked weighs 0."""
    outs = grid.stack(out, "model")
    stats = grid.stack(torch.stack([mx, s]), "model")  # (m, 2, B, S, H)
    top = stats[:, 0].amax(0)
    w = stats[:, 1] * torch.exp(stats[:, 0] - top)
    total, acc = w[0], w[0][..., None] * outs[0].float()
    for r in range(1, outs.shape[0]):
        total = total + w[r]
        acc = acc + w[r][..., None] * outs[r].float()
    return (acc / total[..., None]).to(out.dtype)


def _cached(q, k, v, mask, seq, grid, kv_index):
    """Decode against cached keys and values (B, T, Hkv, hd), every KV
    head: in one process ``_attend``; on a grid this rank's heads over the
    whole cache where it holds all of it (``seq`` None), else the
    sequence-parallel partials over its slots, combined over 'model', of
    which it keeps its heads."""
    if grid is None or grid.size("model") == 1:
        return _attend(q, k, v, mask)
    Hl = q.shape[2]
    h0 = grid.index("model") * Hl
    if seq is None:
        if kv_index is None:
            rep = Hl * grid.size("model") // k.shape[2]
            k, v = (t[:, :, h0 // rep:(h0 + Hl) // rep] for t in (k, v))
        else:
            k, v = _local(k, v, kv_index)
        return _attend(q, k, v, mask)
    out, mx, s = _partial(grid.all_gather(q, "model", 2), k, v, mask)
    return _combine(out, mx, s, grid)[:, :, h0:h0 + Hl]


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
    attend to all T of them and ``cache`` is not used; a ``CrossKV`` that a
    prefill filled is read as a decode step reads a cache;
    ``causal=False`` is the encoder's bidirectional self-attention.

    On a live ``grid`` ``p`` holds this rank's 'model' shard: ``n_heads``
    query heads (``wq``'s columns, ``wo``'s rows) and ``n_kv_heads`` KV
    heads, which a contiguous split keeps in their groups; ``wo`` is
    row-parallel. Where the spec splits ``wk``/``wv`` below a head, the
    caller gathers them whole and ``kv_index`` picks each local query
    head's KV head (h // rep), of ``cross_kv`` too (which the caller
    projects with the same weights). Caches are the module docstring's."""
    B, S, d = x.shape
    if grid is not None:
        x = copy_to(x, grid, "model")
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    if isinstance(cross_kv, CrossKV):  # decode: the keys a prefill cached
        out = _cached(q, cross_kv.k, cross_kv.v, None, cross_kv.seq, grid,
                      kv_index)
    elif cross_kv is not None:
        out = _attend(q, *_local(*cross_kv, kv_index), None)
    else:
        k = (x @ p["wk"]).reshape(B, S, n_kv_heads, head_dim)
        v = (x @ p["wv"]).reshape(B, S, n_kv_heads, head_dim)
        k = apply_rope(k, positions, rope_theta)
        if cache is not None:
            kw, vw = (all_kv_heads(t, grid, kv_index) for t in (k, v))
        if cache is None or S > 1:
            out = _attend(q, *_local(k, v, kv_index),
                          _train_mask(positions, window, causal))
            if cache is not None:  # prefill
                _fill_cache(cache, positions, k=kw, v=vw)
        else:  # decode
            _ring_write(cache, pos, k=kw, v=vw)
            lo, hi = cache.seq or (0, cache.pos.shape[0])
            out = _cached(q, cache.k, cache.v,
                          _cache_mask(positions, cache.pos[lo:hi], window),
                          cache.seq, grid, kv_index)
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

    On a live ``grid`` ``wq`` and ``w_ukv`` hold this rank's ``n_heads``
    heads (their columns are head-major) and ``wo`` their rows,
    row-parallel; ``w_dkv`` and ``w_krope`` are whole, so every rank
    computes the whole latent and rope key (the caller passes them through
    ``copy_to``: each rank's heads give a part of their gradients). A
    cache split by slots over 'model' (``cache.seq``) is gathered whole for
    each decode step, and the rank's heads attend over all of it."""
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
        lat, kr = cache.c_kv, cache.k_rope
        if cache.seq is not None:
            lat, kr = (grid.all_gather(t, "model", 1) for t in (lat, kr))
        out = _mla_attend(q_nope, q_rope, lat, kr,
                          _cache_mask(positions, cache.pos, None), p, H, hd,
                          x.dtype)
    out = out.reshape(B, S, H * hd)
    y = out @ p["wo"] if grid is None else row_parallel(out, p["wo"], grid)
    return y.to(x.dtype)
