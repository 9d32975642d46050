"""Shared neural layers: norms, RoPE, embeddings, activations, initializers.

The torch counterparts of the JAX package's ``models/layers.py``, with the
same arithmetic: the norm and RoPE in float32, logits in float32, weights in
the reference's ``(in, out)`` layout applied as ``x @ w``. The reference's
sharding hints (``act_*``) do nothing on one device and are left out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: elements of a weight drawn at a time by ``truncated_normal`` (its
#: float32 scratch, 256 MiB at most, whatever the weight's size)
INIT_CHUNK = 1 << 26


def truncated_normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    """N(0, std) truncated at two standard deviations, cast to ``dtype``:
    the reference's distribution (not its bits: another generator). Drawn in
    float32 a chunk at a time, so a bf16 weight never has a float32 copy of
    itself."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), INIT_CHUNK):
        part = flat[lo:lo + INIT_CHUNK]
        buf = torch.empty(part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        part.copy_(buf.mul_(std))
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm computed in float32, the scale applied as ``1 + scale``."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """Float64 frequencies, as the reference computes them (cast to float32
    by the caller, so the bits match)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as float32 on ``device``, copied there once (a copy
    from host memory on every call would wait for the card)."""
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The
    split-half rotation: the first and second halves of each head are the
    pair's two coordinates."""
    freqs = _freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (vocab, d) for ``tokens``. Its backward is the
    dense embedding backward, which sorts the tokens and adds each row's
    gradients in that order on the card too (``table[tokens]``'s would be
    an ``index_put_``), so two training runs give the same bits."""
    return torch.nn.functional.embedding(tokens, table)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in float32. As in the reference, the (vocab, d) table is
    upcast to float32 on every call: a temporary of 4 bytes a table entry."""
    return x.float() @ table.float().T


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def swiglu_ffn(x, wg, wu, wd, act=silu):
    return (act(x @ wg) * (x @ wu)) @ wd
