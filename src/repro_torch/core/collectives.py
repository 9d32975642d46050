"""Collectives over the shard axis: emulated on one device, or over
``torch.distributed`` with one process a shard.

JAX runs n shards under ``jax.vmap(axis_name=...)`` and talks between them
with ``lax`` collectives. The port writes the shard axis out as the leading
dimension of every tensor, so each collective becomes a tensor op on it (the
module functions below, the one-process default):

* ``ppermute`` over the shift-by-one ring (shard j sends to j+1) is
  ``torch.roll(x, 1, dims=0)``: row i receives row i-1;
* ``all_to_all`` of an ``(n_src, n_dest, ...)`` tensor, split and
  concatenated on axis 0 as ``lax.all_to_all(x, axis, 0, 0)``, is a swap
  of the first two axes: row k receives what every shard sent to k;
* ``psum`` / ``pmax`` of per-shard partials are reductions over the whole
  ``(n, ...)`` tensor;
* ``axis_index`` is ``arange(n)[:, None]``.

:class:`ProcessMesh` is the counterpart of the reference's ``shard_map``
over a device mesh: each process holds one shard's rows (a leading axis of
1) and the same five names run over the process group, so the engine takes
either as its ``comm``. Float ``psum`` gathers the n partials and sums
them with the emulated op, so both paths add the same numbers in the same
order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: the byte counters of a :class:`ProcessMesh`: what each op handed the
#: backend, and what went through host buffers on the way (gloo on CUDA)
BYTE_KINDS = ("ring", "all_to_all", "gather", "reduce", "staged")


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


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class ProcessMesh:
    """This process's place in a mesh of ``world_size`` processes, one shard
    each, over the initialized default ``torch.distributed`` process
    group.

    The collectives take this shard's rows, a leading axis of 1, where the
    emulated ones take all n. Under gloo, tensors on the card go to host
    buffers and back, moved here and counted as ``staged`` bytes; under NCCL
    nothing is staged. ``bytes`` counts what each op handed the backend
    since the last :meth:`reset`."""

    def __init__(self, rank: int, world_size: int, *, backend: str,
                 device):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.backend = backend
        self.device = torch.device(device)
        self._stage = backend == "gloo" and self.device.type == "cuda"
        self.bytes = dict.fromkeys(BYTE_KINDS, 0)

    def reset(self) -> None:
        self.bytes = dict.fromkeys(BYTE_KINDS, 0)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the backend takes it: contiguous, on the host under
        gloo."""
        x = x.contiguous()
        if self._stage:
            self.bytes["staged"] += _nbytes(x)
            return x.cpu()
        return x

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        if self._stage:
            self.bytes["staged"] += _nbytes(x)
            return x.to(self.device)
        return x

    def barrier(self) -> None:
        """One small all_reduce, uncounted: every rank has joined, and
        NCCL's communicator exists before the first ring round."""
        x = self._out(torch.ones(1, device=self.device))
        dist.all_reduce(x)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's row goes to rank r+1; the row of rank r-1 comes
        back."""
        n, r = self.world_size, self.rank
        if n == 1:
            return x
        send = self._out(x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (r + 1) % n),
               dist.P2POp(dist.irecv, recv, (r - 1) % n)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self.bytes["ring"] += _nbytes(send)
        return self._back(recv)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(1, n_dest, ...) -> (1, n_src, ...): row entry k is what rank k
        sent to this one."""
        n = self.world_size
        if x.shape[0] != 1 or x.shape[1] != n:
            raise ValueError(f"all_to_all takes (1, {n}, ...), got "
                             f"{tuple(x.shape)}")
        if n == 1:
            return x.contiguous()
        send = self._out(x)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv.view(n, -1), send.view(n, -1))
        self.bytes["all_to_all"] += _nbytes(send)
        return self._back(recv)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Integers: an all_reduce of the local sum (exact). Floats: the n
        partials gathered in rank order, then summed by the emulated op."""
        if self.world_size == 1:
            return psum(x)
        if x.is_floating_point():
            local = self._out(x.reshape(-1))
            parts = [torch.empty_like(local) for _ in range(self.world_size)]
            dist.all_gather(parts, local)
            self.bytes["gather"] += _nbytes(local)
            return psum(self._back(torch.cat(parts)))
        return self._reduce(psum(x), dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        if self.world_size == 1:
            return pmax(x)
        return self._reduce(pmax(x), dist.ReduceOp.MAX)

    def _reduce(self, local: torch.Tensor, op) -> torch.Tensor:
        if local.is_floating_point():
            raise TypeError("the mesh reduces integers only; floats go "
                            "through psum's gather")
        t = self._out(local)  # a fresh 0-dim tensor: reduced in place
        dist.all_reduce(t, op=op)
        self.bytes["reduce"] += _nbytes(t)
        return self._back(t)

    def axis_index(self, n: int, device) -> torch.Tensor:
        if n != 1:
            raise ValueError(f"a rank holds one shard's rows, not {n}")
        return torch.full((1, 1), self.rank, dtype=torch.int64,
                          device=device)
