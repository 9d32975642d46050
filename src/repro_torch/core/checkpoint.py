"""Fault tolerance (paper §3.4): checkpoints and message-log fast recovery.

Port of ``Checkpointer``, ``MessageLog`` and ``recover_shard`` from
``repro/core/checkpoint.py``. The files on disk are the JAX package's, byte
for byte in layout, so either package reads what the other writes:

* a checkpoint is ``step-NNNNNN/`` with ``manifest.json`` and one
  ``shard-{i}.npz`` (``values``, ``active``) per shard, written under
  ``.tmp-step-NNNNNN/`` and published by an atomic rename;
* a message log is ``step-NNNNNN/`` with one ``shard-{i}.npz`` (``A_s``,
  ``cnt``: the shard's combined outgoing buffers for every destination) per
  shard.

When one shard fails, only that shard recomputes: it reloads its checkpoint
row and replays the supersteps since, combining the peers' logged
``A_s(i -> failed)`` with its own regenerated ``A_s(failed -> failed)``.
Logs are dropped once a newer checkpoint lands ("keep OMSs until a new
checkpoint is written").

Writes take tensors on any device or numpy arrays; reads return tensors on
``device`` (CUDA unless the caller names another).
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.core.api import ShardContext, VertexProgram
from repro_torch.device import resolve_device
from repro_torch.graph.partition import PartitionedGraph

_STEP_DIR = re.compile(r"^step-(\d+)$")


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    """Shard-file checkpoints with an atomic manifest."""

    def __init__(self, directory: str, every: int = 5, keep: int = 2):
        self.dir = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # a crash between makedirs(tmp) and the atomic rename in save()
        # leaves a .tmp-step-* behind; sweep them so they can't pile up
        for name in os.listdir(directory):
            if name.startswith(".tmp-step-"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # -- write ---------------------------------------------------------------
    def maybe_save(self, step: int, values, active) -> bool:
        """Save if ``step`` is on the cadence; True iff a checkpoint landed
        (the engine drops message logs only after a durable save)."""
        if self.every and step % self.every == 0:
            self.save(step, values, active)
            return True
        return False

    def save(self, step: int, values, active):
        vals = _numpy(values)
        act = _numpy(active)
        tmp = os.path.join(self.dir, f".tmp-step-{step:06d}")
        final = os.path.join(self.dir, f"step-{step:06d}")
        os.makedirs(tmp, exist_ok=True)
        for i in range(vals.shape[0]):
            np.savez(os.path.join(tmp, f"shard-{i}.npz"),
                     values=vals[i], active=act[i])
        manifest = dict(step=step, n_shards=int(vals.shape[0]),
                        P=int(vals.shape[1]), dtype=str(vals.dtype),
                        meta=None)  # the streamed mode records its edge streams here
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())  # recovery trusts any step dir it can see;
            # the manifest must be durable before the rename publishes it
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:06d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """Published checkpoint steps; entries that are not ``step-NNNNNN``
        directories are ignored."""
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_DIR.match(name)
            if m and os.path.isdir(os.path.join(self.dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int | None) -> tuple[str, int]:
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return os.path.join(self.dir, f"step-{step:06d}"), step

    def restore(self, step: int | None = None, device=None):
        """(values, active, step) as ``(n, P)`` tensors on ``device``."""
        device = resolve_device(device)
        d, step = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        vals, acts = [], []
        for i in range(manifest["n_shards"]):
            with np.load(os.path.join(d, f"shard-{i}.npz")) as z:
                vals.append(z["values"])
                acts.append(z["active"])
        return (torch.from_numpy(np.stack(vals)).to(device),
                torch.from_numpy(np.stack(acts)).to(device), step)

    def restore_shard(self, shard: int, step: int | None = None, device=None):
        """(values, active, step) of one shard as ``(P,)`` tensors."""
        device = resolve_device(device)
        d, step = self._step_dir(step)
        with np.load(os.path.join(d, f"shard-{shard}.npz")) as z:
            return (torch.from_numpy(z["values"]).to(device),
                    torch.from_numpy(z["active"]).to(device), step)


class MessageLog:
    """Per-superstep outgoing-message logs (the persisted OMSs of [19])."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, A_s_all, cnt_all):
        """A_s_all: (n_src, n_dest, P) combined outgoing buffers; cnt_all
        their message counts."""
        A = _numpy(A_s_all)
        C = _numpy(cnt_all)
        d = os.path.join(self.dir, f"step-{step:06d}")
        os.makedirs(d, exist_ok=True)
        for i in range(A.shape[0]):
            np.savez(os.path.join(d, f"shard-{i}.npz"), A_s=A[i], cnt=C[i])

    def load_for_dest(self, step: int, dest: int, n_shards: int,
                      skip_shard: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """Logged (A_s(i -> dest), cnt(i -> dest)) of every shard i but
        ``skip_shard``, ascending."""
        d = os.path.join(self.dir, f"step-{step:06d}")
        parts = []
        for i in range(n_shards):
            if i == skip_shard:
                continue
            with np.load(os.path.join(d, f"shard-{i}.npz")) as z:
                parts.append((z["A_s"][dest], z["cnt"][dest]))
        return parts

    def gc_before(self, step: int):
        """§3.4: drop message logs once a newer checkpoint is durable."""
        for name in sorted(os.listdir(self.dir)):
            m = _STEP_DIR.match(name)
            if m and int(m.group(1)) < step:
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)


def recover_shard(pg: PartitionedGraph, program: VertexProgram, failed: int,
                  ckpt: Checkpointer, log: MessageLog, target_step: int):
    """Message-log fast recovery of one failed shard ([19], paper §3.4).

    Re-executes supersteps from the latest checkpoint to ``target_step`` for
    shard ``failed`` alone, on ``pg``'s device. The messages at step t are
    its own regenerated A_s(failed -> failed, t) (the plain dense
    contribution) combined with the peers' logged A_s(i -> failed, t), in
    ascending i. Returns (values_row, active_row), each ``(P,)``."""
    from repro_torch.core.engine import _combine_scatter, _gen_messages

    dev, comb = pg.device, program.combiner
    v, a, start = ckpt.restore_shard(failed, device=dev)
    v, a = v[None].to(program.value_dtype), a[None]
    row = lambda t: t[failed][None]  # (1, ...) view of this shard's row
    sp, dp, w = (pg.src_pos[failed, failed][None], pg.dst_pos[failed, failed][None],
                 pg.eweight[failed, failed][None])
    degree, vmask = row(pg.degree), row(pg.vmask)
    ctx = ShardContext(
        shard=torch.full((1, 1), failed, device=dev), n_shards=pg.n_shards,
        n_vertices=pg.n_vertices, P=pg.P, degree=degree, vmask=vmask,
        old_ids=row(pg.old_ids), gids=row(pg.gids),
    )
    for t in range(start, target_step):
        msg, aact = _gen_messages(program, v, degree, sp, w, a, t)
        A_r, cnt = _combine_scatter(program, pg.P, msg, dp, aact)
        for pA, pc in log.load_for_dest(t, failed, pg.n_shards, failed):
            A_r = comb.combine(A_r, torch.from_numpy(pA).to(dev)[None])
            cnt = cnt + torch.from_numpy(pc).to(dev)[None]
        has_msg = (cnt > 0) & vmask
        nv, na = program.apply(v, degree, A_r, has_msg, a, t, ctx)
        v, a = nv.to(program.value_dtype), na & vmask
    return v[0], a[0]
