"""Collectives over the emulated shard axis.

JAX runs n shards under ``jax.vmap(axis_name=...)`` and talks between them
with ``lax`` collectives. The port writes the shard axis out as the leading
dimension of every tensor, so each collective becomes a tensor op on it:

* ``ppermute`` over the shift-by-one ring (shard j sends to j+1) is
  ``torch.roll(x, 1, dims=0)``: row i receives row i-1;
* ``psum`` / ``pmax`` of per-shard partials are reductions over the whole
  ``(n, ...)`` tensor;
* ``axis_index`` is ``arange(n)[:, None]``.
"""

from __future__ import annotations

import torch


def ring_shift(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, 1, dims=0)


def psum(x: torch.Tensor) -> torch.Tensor:
    return x.sum()


def pmax(x: torch.Tensor) -> torch.Tensor:
    return x.max()


def axis_index(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[:, None]
