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

On a mesh (``GraphDEngine(..., mesh=)``, one process a shard) a
``Checkpointer`` and a ``MessageLog`` are made on every rank with
``mesh=``: rank r writes ``shard-{r}.npz`` alone, rank 0 publishes each
checkpoint once every rank has written (the same files and manifest as one
process writes), and a shard is recovered from them in one process.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time

import numpy as np
import torch

from repro_torch.convert import numpy_dtype
from repro_torch.core.api import ShardContext, VertexProgram
from repro_torch.device import resolve_device
from repro_torch.graph.partition import PartitionedGraph

_STEP_DIR = re.compile(r"^step-(\d+)$")


def _lead(mesh) -> bool:
    """Whether this process does the one-process work: always off a mesh,
    rank 0 on one."""
    return mesh is None or mesh.rank == 0


def _first_shard(mesh) -> int:
    """The shard of the first row this process writes."""
    return 0 if mesh is None else mesh.rank


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    """Shard-file checkpoints with an atomic manifest.

    With ``mesh=`` (a ``core.collectives.ProcessMesh``, made on every rank
    of a mesh over one shared directory) each rank writes its own shard's
    file and reads it back: rank 0 alone sweeps stale temporaries here and
    publishes each checkpoint (manifest, rename, collection of old ones)
    once every rank has written, between two barriers."""

    def __init__(self, directory: str, every: int = 5, keep: int = 2, *,
                 mesh=None):
        self.dir = directory
        self.every = every
        self.keep = keep
        self.mesh = mesh
        #: seconds spent in :meth:`save` (barriers included on a mesh)
        self.save_seconds = 0.0
        os.makedirs(directory, exist_ok=True)
        # a crash between makedirs(tmp) and the atomic rename in save()
        # leaves a .tmp-step-* behind; sweep them so they can't pile up (on
        # a mesh, before any rank may write into one)
        if _lead(mesh):
            for name in os.listdir(directory):
                if name.startswith(".tmp-step-"):
                    shutil.rmtree(os.path.join(directory, name),
                                  ignore_errors=True)
        if mesh is not None:
            mesh.barrier()

    # -- write ---------------------------------------------------------------
    def maybe_save(self, step: int, values, active, meta=None) -> bool:
        """Save if ``step`` is on the cadence; True iff a checkpoint landed
        (the engine drops message logs only after a durable save)."""
        if self.every and step % self.every == 0:
            self.save(step, values, active, meta=meta)
            return True
        return False

    def save(self, step: int, values, active, meta=None):
        """``meta`` (JSON-able) is recorded in the manifest; the streamed
        engine passes the edge-stream store's signature so that recovery
        can refuse vertex state written against other edge streams. On a
        mesh, ``values``/``active`` are this rank's rows."""
        t0 = time.perf_counter()
        vals = _numpy(values)
        act = _numpy(active)
        tmp = os.path.join(self.dir, f".tmp-step-{step:06d}")
        final = os.path.join(self.dir, f"step-{step:06d}")
        os.makedirs(tmp, exist_ok=True)
        first = _first_shard(self.mesh)
        for i in range(vals.shape[0]):
            np.savez(os.path.join(tmp, f"shard-{first + i}.npz"),
                     values=vals[i], active=act[i])
        if self.mesh is not None:
            self.mesh.barrier()  # every rank's shard is written
        if _lead(self.mesh):
            n_shards = (vals.shape[0] if self.mesh is None
                        else self.mesh.world_size)
            manifest = dict(step=step, n_shards=int(n_shards),
                            P=int(vals.shape[1]), dtype=str(vals.dtype),
                            meta=meta)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())  # recovery trusts any step dir it can
                # see; the manifest must be durable before the rename
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()
        if self.mesh is not None:
            self.mesh.barrier()  # published: every rank sees it
        self.save_seconds += time.perf_counter() - t0

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

    def restore(self, step: int | None = None, expected_meta=None,
                device=None):
        """(values, active, step) as ``(n, P)`` tensors on ``device`` (on a
        mesh, this rank's ``(1, P)`` row, after the manifest's shard count
        is checked against the mesh's). When ``expected_meta`` is given
        and the checkpoint recorded a (non-null) meta, the two must match:
        a checkpoint written against other edge streams is unusable state,
        not a silent wrong answer."""
        device = resolve_device(device)
        d, step = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        got = manifest.get("meta")
        if expected_meta is not None and got is not None and got != expected_meta:
            raise ValueError(
                f"checkpoint step-{step:06d} was written against different "
                f"edge streams: manifest meta {got} != expected {expected_meta}"
            )
        shards = range(manifest["n_shards"])
        if self.mesh is not None:
            if manifest["n_shards"] != self.mesh.world_size:
                raise ValueError(
                    f"checkpoint step-{step:06d} holds "
                    f"{manifest['n_shards']} shards and the mesh has "
                    f"{self.mesh.world_size} ranks")
            shards = [self.mesh.rank]
        vals, acts = [], []
        for i in shards:
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
    """Per-superstep outgoing-message logs (the persisted OMSs of [19]).

    With ``mesh=`` (made on every rank of a mesh over one shared directory)
    each rank writes its own shard's file, and rank 0 alone drops old
    steps."""

    def __init__(self, directory: str, *, mesh=None):
        self.dir = directory
        self.mesh = mesh
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, A_s_all, cnt_all):
        """A_s_all: (n_src, n_dest, P) combined outgoing buffers (on a mesh,
        this rank's (1, n_dest, P)); cnt_all their message counts."""
        A = _numpy(A_s_all)
        C = _numpy(cnt_all)
        d = os.path.join(self.dir, f"step-{step:06d}")
        os.makedirs(d, exist_ok=True)
        first = _first_shard(self.mesh)
        for i in range(A.shape[0]):
            np.savez(os.path.join(d, f"shard-{first + i}.npz"), A_s=A[i],
                     cnt=C[i])

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
        """§3.4: drop message logs once a newer checkpoint is durable (on a
        mesh, rank 0 does, after the checkpoint's last barrier: every rank
        has written every step it drops)."""
        if not _lead(self.mesh):
            return
        for name in sorted(os.listdir(self.dir)):
            m = _STEP_DIR.match(name)
            if m and int(m.group(1)) < step:
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)


class RunFileMessageLog(MessageLog):
    """Message logs backed by the ``streams.msgstore`` run files: the
    persisted OMSs of the paper, usable by ``mode="streamed"`` because they
    are written incrementally (never an (n, n, P) buffer).

    Two content shapes share one on-disk format (a ``MessageRunStore`` per
    superstep under ``step-NNNNNN/``), the JAX package's:

    * combiner path: one sorted run per (src->dest) group holding the
      *combined* A_s as sparse ``(dst_pos, msg, cnt)`` triples, appended by
      :meth:`save_group` as the streamed fold finishes each group, or by
      the pipelined engine's channel sender, whose inbox store IS this
      log's per-step store;
    * combiner-less path: the engine's raw OMS spill store for the
      superstep is created under this directory (``open_step``): the runs
      the external merge consumes ARE the log.

    The engine calls :meth:`configure` with the program geometry; a log
    reopened for recovery reads it back from the per-step run indexes.
    """

    def __init__(self, directory: str):
        super().__init__(directory)
        self._n_shards = None
        self._P = None
        self._msg_dtype = None
        self._e0 = 0
        self._combined = True
        self._compress = False
        self._compress_payload = False
        self._open_stores: dict[int, object] = {}

    def configure(self, n_shards: int, P: int, msg_dtype, e0=0,
                  combined: bool = True, compress: bool = False,
                  compress_payload=False):
        self._n_shards = int(n_shards)
        self._P = int(P)
        self._msg_dtype = np.dtype(msg_dtype)
        self._e0 = e0
        self._combined = bool(combined)
        self._compress = bool(compress)
        self._compress_payload = compress_payload or False

    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step-{step:06d}")

    def open_step(self, step: int):
        """Fresh (truncated) per-step run store for the engine to spill
        into; re-running a crashed superstep starts its OMS over."""
        from repro_torch.streams.msgstore import MessageRunStore

        store = MessageRunStore(
            self.step_dir(step), self._n_shards, self._P, self._msg_dtype,
            with_counts=self._combined, compress=self._compress,
            compress_payload=self._compress_payload,
        )
        self._open_stores[step] = store
        return store

    def _store_for(self, step: int):
        from repro_torch.streams.msgstore import MessageRunStore

        store = self._open_stores.get(step)
        if store is None:
            store = MessageRunStore.open(self.step_dir(step))
            self._open_stores[step] = store
        return store

    # -- writes (combiner path) ----------------------------------------------
    def save_group(self, step: int, src: int, dest: int, A_s, cnt):
        """Persist one combined outgoing buffer A_s(src->dest) as a sparse
        sorted run; positions with no messages are dropped (they hold the
        combiner identity by construction)."""
        if self._n_shards is None:
            raise ValueError(
                "RunFileMessageLog is unconfigured; the engine calls "
                "configure() from its constructor — do the same before "
                "logging directly (the combiner identity e0 cannot be "
                "guessed: densifying with the wrong one corrupts recovery)"
            )
        store = self._open_stores.get(step)
        if store is None:
            store = self.open_step(step)
        store.append_combined(dest, _numpy(A_s), _numpy(cnt), tag=src)

    def save(self, step: int, A_s_all, cnt_all):
        """The in-memory logged step's dense (n_src, n_dest, P) buffers,
        fanned out into per-group runs."""
        A = _numpy(A_s_all)
        C = _numpy(cnt_all)
        for i in range(A.shape[0]):
            for k in range(A.shape[1]):
                self.save_group(step, i, k, A[i, k], C[i, k])
        self.close_step(step)  # publish the index once per superstep

    # -- reads ----------------------------------------------------------------
    def load_for_dest(self, step: int, dest: int, n_shards: int,
                      skip_shard: int):
        """Densify the logged runs back into (A_s, cnt) pairs per surviving
        source shard (groups that skip() pruned contributed the identity
        and have no run)."""
        store = self._store_for(step)
        if not store.with_counts:
            raise ValueError(
                "this log holds raw combiner-less OMS runs; dense (A_s, cnt)"
                " reads only apply to combined logs — recover with "
                "recover_shard_streamed, which merge-streams the runs"
            )
        e0 = self._e0 if self._e0 is not None else 0
        return [
            store.read_combined(dest, seg, e0)
            for seg in store.runs(dest) if seg.tag != skip_shard
        ]

    def close_step(self, step: int):
        """Publish the step's run index once, release the write handles,
        and forget the in-memory store; later reads reopen it from the
        saved index."""
        store = self._open_stores.pop(step, None)
        if store is not None:
            store.save_index()
            store.close()

    def gc_before(self, step: int):
        for s in list(self._open_stores):
            if s < step:
                self._open_stores.pop(s).close()
        super().gc_before(step)


def recover_shard_streamed(pg: PartitionedGraph, program: VertexProgram,
                           failed: int, ckpt: Checkpointer,
                           log: RunFileMessageLog, store, target_step: int):
    """Single-shard fast recovery for ``mode="streamed"`` ([19] / §3.4).

    Only shard ``failed`` recomputes, on ``pg``'s device: its rows reload
    from the latest checkpoint and supersteps replay forward. The messages
    at step t are the peers' logged OMSs for destination ``failed`` plus the
    shard's own (failed->failed) contribution, regenerated by streaming that
    one edge group back off disk (``store``, a ``streams.EdgeStreamStore``);
    no other group is read.

    With a combiner the logged runs are densified and combined with the
    regenerated group in ascending source order, the live engine's transmit
    order; without one the peers' sorted runs are merge-streamed with the
    regenerated runs through the engine's own apply_list slicing. Returns
    (values_row, active_row), each ``(P,)``."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.engine import GraphDEngine, _host_copy
    from repro_torch.streams.msgstore import MessageRunStore

    dev = pg.device
    eng = GraphDEngine(pg, program, EngineConfig(mode="streamed"),
                       device=dev, stream_store=store, message_log=log)
    pg, comb = eng.pg, program.combiner
    v_j, a_j, start = ckpt.restore_shard(failed, device=dev)
    v_j = v_j.to(program.value_dtype)
    n, P = pg.n_shards, pg.P
    reader, stager = eng._stream_reader, eng._stager
    row = (pg.degree[failed], pg.vmask[failed], pg.old_ids[failed],
           pg.gids[failed])

    for t in range(start, target_step):
        prefix = np.concatenate(
            [[0], np.cumsum(a_j.cpu().numpy().astype(np.int64))])
        own_ids = store.active_blocks(failed, failed, prefix)
        own_schedule = [(failed, failed, own_ids)] if own_ids.size else []
        if comb is not None:
            # regenerate the failed shard's own combined group A_s(j->j)
            # chunk by chunk, the live fold's sequence
            own_A = comb.identity((P,), program.msg_dtype, dev)
            own_cnt = torch.zeros(P, dtype=torch.int32, device=dev)
            for chunk in reader.stream(own_schedule):
                if not stager.room(chunk.sp.size):
                    eng._stream_fold(own_A, own_cnt, v_j, pg.degree[failed],
                                     a_j, *stager.take(), t)
                stager.add(chunk.sp, chunk.dp, chunk.w)
            if stager.pending:
                eng._stream_fold(own_A, own_cnt, v_j, pg.degree[failed], a_j,
                                 *stager.take(), t)
            # digest the peers' logged groups AND the regenerated own group
            # in ascending source order, the live engine's transmit order
            store_t = log._store_for(t)
            parts = [
                (seg.tag, *(torch.from_numpy(x).to(dev) for x in
                            store_t.read_combined(failed, seg, comb.e0)))
                for seg in store_t.runs(failed) if seg.tag != failed
            ]
            parts.append((failed, own_A, own_cnt))
            parts.sort(key=lambda p: p[0])
            A_r = comb.identity((P,), program.msg_dtype, dev)
            cnt = torch.zeros(P, dtype=torch.int32, device=dev)
            for _, pA, pc in parts:
                A_r = comb.combine(A_r, pA)
                cnt = cnt + pc
            v_j, a_j, *_ = eng._stream_apply(v_j, *row, A_r, cnt, a_j, t,
                                             failed)
        else:
            # rebuild a merge-ready store: peers' logged runs (re-chunked: a
            # chunk of a sorted run is a sorted run) + regenerated own runs
            logged = log._store_for(t)
            tmp = MessageRunStore(
                os.path.join(eng.msg_spill_dir, f"recover-{t:06d}"), n, P,
                numpy_dtype(program.msg_dtype),
            )
            try:
                peer_segs: dict[int, list] = {}
                for seg in logged.runs(failed):
                    if seg.tag != failed:
                        peer_segs.setdefault(seg.tag, []).append(seg)
                # ascending source order, the live spill's run-table order,
                # so the merge's equal-dp tie-breaking replays exactly
                for tag in sorted(set(peer_segs) | {failed}):
                    if tag == failed:
                        # regenerated own messages, never trusted from disk
                        for chunk in reader.stream(own_schedule):
                            msg, dp, valid = eng._stream_msgs(
                                v_j, pg.degree[failed], a_j,
                                *stager.put(chunk.sp, chunk.dp, chunk.w), t)
                            tmp.append_raw(failed, _host_copy(dp),
                                           _host_copy(msg), _host_copy(valid),
                                           tag=failed)
                    else:
                        for seg in peer_segs[tag]:
                            for part in logged.iter_run(failed, seg,
                                                        eng.msg_read_chunk):
                                tmp.append_run(failed, part[0], part[1],
                                               tag=tag)
                    # re-collapse so the final merge holds one cursor per
                    # source, not one per copied chunk
                    tmp.compact_tag(failed, tag, eng.msg_merge_fanin,
                                    eng.msg_read_chunk)
                v_j, a_j, _ = eng._apply_list_merged(tmp, failed, v_j, a_j, t)
            finally:
                tmp.delete()
    return v_j, a_j


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
