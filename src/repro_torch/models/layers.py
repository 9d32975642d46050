"""Shared neural layers: norms, RoPE, embeddings, activations, initializers.

The torch counterparts of the JAX package's ``models/layers.py``, with the
same arithmetic: the norm and RoPE in float32, logits in float32, weights in
the reference's ``(in, out)`` layout applied as ``x @ w``. The reference's
sharding hints (``act_*``) do nothing on one device and are left out.

With a live ``grid`` (``launch/lm_mesh.py::ProcessGrid``) ``embed``,
``unembed`` and ``swiglu_ffn`` take this rank's 'model' shard of their
weights (vocab rows, FFN columns and rows) and run vocab- and
tensor-parallel; without one they are the one-process functions, unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models.sharding import copy_to, reduce_from

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

def embed(tokens: torch.Tensor, table: torch.Tensor, grid=None) -> torch.Tensor:
    """The rows of ``table`` (vocab, d) for ``tokens``. Its backward is the
    dense embedding backward, which sorts the tokens and adds each row's
    gradients in that order on the card too (``table[tokens]``'s would be
    an ``index_put_``), so two training runs give the same bits.

    On a grid ``table`` is this rank's vocab rows: a token outside them
    gives a zero row, and the rows are summed over 'model' (one rank's is
    not zero). The rank's own tokens alone go through the embedding, so its
    backward adds them in that order and adds nothing for another rank's
    token (a clamped index would add zeros into row 0)."""
    if grid is None or grid.size("model") == 1:
        return torch.nn.functional.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens.long() - grid.index("model") * rows
    own = ((local >= 0) & (local < rows)).nonzero(as_tuple=True)
    out = table.new_zeros(*tokens.shape, table.shape[1]).index_put(
        own, torch.nn.functional.embedding(local[own], table))
    return reduce_from(out, grid, "model")


def unembed(x: torch.Tensor, table: torch.Tensor, grid=None) -> torch.Tensor:
    """Logits in float32. As in the reference, the (vocab, d) table is
    upcast to float32 on every call: a temporary of 4 bytes a table entry.
    On a grid, the logits of this rank's vocab rows."""
    if grid is not None:
        x = copy_to(x, grid, "model")
    return x.float() @ table.float().T


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def row_parallel(x: torch.Tensor, w: torch.Tensor, grid) -> torch.Tensor:
    """``x @ w`` where ``x`` holds this rank's columns of the input and
    ``w`` the same rows (the 'model' split of an output projection): the
    partial products in float32, summed over 'model', rounded once to
    ``x``'s dtype."""
    if grid.size("model") == 1:
        return x @ w
    return reduce_from(x.float() @ w.float(), grid, "model").to(x.dtype)


def swiglu_ffn(x, wg, wu, wd, act=silu, grid=None):
    """On a grid ``wg``/``wu`` hold this rank's columns and ``wd`` its rows
    of the hidden dimension: column-, then row-parallel."""
    if grid is None:
        return (act(x @ wg) * (x @ wu)) @ wd
    x = copy_to(x, grid, "model")
    return row_parallel(act(x @ wg) * (x @ wu), wd, grid)
