"""skip() helpers around the edge_combine kernel (paper §3.2).

Both run on the device with no host sync: ``n_keep`` stays a tensor that the
kernel reads, so a ring round never waits on the host. The JAX package's
``window_first_mask`` term is gone: its kernel needed each destination
window's first block to initialize the window's output, while the port's
wrapper pre-fills the whole output with the combiner identity.
"""

from __future__ import annotations

import torch


def skip_keep_mask(blk_lo: torch.Tensor, blk_hi: torch.Tensor,
                   active_prefix: torch.Tensor) -> torch.Tensor:
    """keep = block has an active source, by the skip() test
    prefix[hi+1] - prefix[lo] > 0 over the active bitmap.

    ``active_prefix`` is ``(n, P+1)``; ``blk_lo/blk_hi`` are ``(n, NB)``
    source ranges of shard i's blocks, with (P, -1) for an empty block."""
    P = active_prefix.shape[-1] - 1
    hi = (blk_hi.long() + 1).clamp(0, P)
    lo = blk_lo.long().clamp(0, P)
    cnt = active_prefix.gather(-1, hi) - active_prefix.gather(-1, lo)
    return (blk_hi >= 0) & (cnt > 0)


def compact_blocks(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(blk_ids (n, NB) int32, n_keep (n,) int32) from a keep mask (n, NB):
    each row's kept block ids ascending first, then the dropped ones.
    A stable sort on the negated mask stands in for ``nonzero``, which
    would sync with the host."""
    order = torch.sort((~keep).to(torch.int8), dim=-1, stable=True).indices
    return order.to(torch.int32), keep.sum(-1, dtype=torch.int32)
