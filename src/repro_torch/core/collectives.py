"""Collectives over the emulated shard axis.

JAX runs n shards under ``jax.vmap(axis_name=...)`` and talks between them
with ``lax`` collectives. The port writes the shard axis out as the leading
dimension of every tensor, so each collective becomes a tensor op on it:

* ``ppermute`` over the shift-by-one ring (shard j sends to j+1) is
  ``torch.roll(x, 1, dims=0)``: row i receives row i-1;
* ``all_to_all`` of an ``(n_src, n_dest, ...)`` tensor, split and
  concatenated on axis 0 as ``lax.all_to_all(x, axis, 0, 0)``, is a swap
  of the first two axes: row k receives what every shard sent to k;
* ``psum`` / ``pmax`` of per-shard partials are reductions over the whole
  ``(n, ...)`` tensor;
* ``axis_index`` is ``arange(n)[:, None]``.
"""

from __future__ import annotations

import torch


def ring_shift(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, 1, dims=0)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """(n_src, n_dest, ...) -> (n_dest, n_src, ...), contiguous."""
    return x.transpose(0, 1).contiguous()


def psum(x: torch.Tensor) -> torch.Tensor:
    return x.sum()


def pmax(x: torch.Tensor) -> torch.Tensor:
    return x.max()


def axis_index(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[:, None]
