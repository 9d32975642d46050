"""Grouped-query attention, global or sliding-window, with ring-buffer KV
caches: the GQA half of the JAX package's ``models/attention.py``.

All functions take and return (B, S, d) activations. A cache is a
:class:`KVCache` of ``k``/``v`` (B, Lc, Hkv, hd) and ``pos`` (Lc,) int32,
the absolute position a slot holds (-1 empty), written in place. ``Lc =
window`` for sliding-window layers (a ring buffer) and ``Lc = max_len`` for
global ones. Three modes a call, as in the reference:

  cache=None              train forward (causal)
  cache given, S > 1      prefill: attend causally AND fill the cache
  cache given, S == 1     decode: ring-write one entry, attend over cache

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

from repro_torch.models.layers import apply_rope

#: the masked logit, as the reference's ``jnp.where(mask, logits, -1e30)``
MASKED = -1e30


@dataclass
class KVCache:
    k: torch.Tensor  # (B, Lc, Hkv, hd)
    v: torch.Tensor  # (B, Lc, Hkv, hd)
    pos: torch.Tensor  # (Lc,) int32 absolute position of each slot, -1 empty

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.k, self.v, self.pos


def make_gqa_cache(B: int, Lc: int, n_kv_heads: int, head_dim: int, dtype,
                   device) -> KVCache:
    return KVCache(
        k=torch.zeros((B, Lc, n_kv_heads, head_dim), dtype=dtype, device=device),
        v=torch.zeros((B, Lc, n_kv_heads, head_dim), dtype=dtype, device=device),
        pos=torch.full((Lc,), -1, dtype=torch.int32, device=device),
    )


def _attend(q, k, v, mask):
    """q: (B,S,H,hd), k/v: (B,T,Hkv,hd), mask (B,S,T); query head h reads
    KV head h // rep, as the reference's reshape (B,S,Hkv,rep,hd)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, S, Hkv, rep, hd).float().permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]  # (B,Hkv,1,hd,T)
    logits = (qg @ kt) / math.sqrt(hd)
    logits = torch.where(mask[:, None, None], logits, MASKED)
    p = torch.softmax(logits, dim=-1)  # (B,Hkv,rep,S,T)
    vg = v.permute(0, 2, 1, 3)[:, :, None]  # (B,Hkv,1,T,hd)
    out = p.to(v.dtype) @ vg  # (B,Hkv,rep,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _train_mask(positions, window):
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


def _fill_cache(cache: KVCache, k, v, positions) -> None:
    """Prefill from position 0: the last ``min(S, Lc)`` entries, position
    ``p`` at slot ``p % Lc`` (the reference writes them at slots 0.., see
    the module's docstring)."""
    Lc = cache.pos.shape[0]
    S = positions.shape[1]
    take = min(S, Lc)
    pos = positions[0, S - take:]
    slots = pos.remainder(Lc).long()
    cache.k[:, slots] = k[:, S - take:]
    cache.v[:, slots] = v[:, S - take:]
    cache.pos[slots] = pos.to(torch.int32)


def _ring_write(cache: KVCache, k, v, pos: int) -> None:
    """Decode: write one entry at slot ``pos % Lc``."""
    slot = pos % cache.pos.shape[0]
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.pos[slot] = pos


def gqa_attention(p: dict, x, positions, *, n_heads: int, n_kv_heads: int,
                  head_dim: int, rope_theta: float, window: int | None = None,
                  cache: KVCache | None = None, pos: int | None = None):
    """Returns out (B,S,d). ``p`` holds ``wq`` (d, H·hd), ``wk``/``wv``
    (d, Hkv·hd) and ``wo`` (H·hd, d). A decode call (``cache`` given,
    S == 1) takes its position also as the Python int ``pos``, the slot it
    writes: a slot read back from the card would wait for it. The
    reference's bidirectional (``causal=False``) and cross-attention forms
    serve the encoder-decoder and VLM stacks, ROADMAP item 12.1b."""
    B, S, d = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = (x @ p["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv_heads, head_dim)
    k = apply_rope(k, positions, rope_theta)
    if cache is None or S > 1:
        out = _attend(q, k, v, _train_mask(positions, window))
        if cache is not None:  # prefill
            _fill_cache(cache, k, v, positions)
    else:  # decode
        _ring_write(cache, k, v, pos)
        out = _attend(q, cache.k, cache.v,
                      _cache_mask(positions, cache.pos, window))
    y = out.reshape(B, S, n_heads * head_dim) @ p["wo"]
    return y.to(x.dtype)
