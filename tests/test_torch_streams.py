"""The port's streams layer against the JAX package's, on the CPU: edge
stores, message-run stores and codec blobs written by either package open in
the other, byte for byte; the reader's staging-buffer contract; and
streamed checkpoints, run-file message logs and single-shard recovery that
cross between the packages."""

import filecmp
import importlib
import os

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import checkpoint as ref_ckpt
from repro.graph import partition_graph_streamed as ref_streamed
from repro.graph import rmat_graph as ref_rmat
from repro.streams import codec as ref_codec
from repro.streams.msgstore import MessageRunStore as RefRunStore
from repro.streams.store import EdgeStreamStore as RefStore
from repro_torch.core import checkpoint as port_ckpt
from repro_torch.core.engine import _ChunkStager
from repro_torch.graph import partition_graph_streamed, rmat_graph
from repro_torch.streams import codec
from repro_torch.streams.msgstore import MessageRunStore
from repro_torch.streams.reader import StreamReader
from repro_torch.streams.schedule import plan_stream_schedule
from repro_torch.streams.store import EdgeStreamStore

# the shapes here are tiny: one intra-op thread keeps torch's idle
# OpenMP workers from competing with the other test processes
torch.set_num_threads(1)

N_SHARDS = 3
EDGE_BLOCK = 32
FLAVOURS = {"plain": dict(), "compressed": dict(compress=True),
            "payload": dict(compress=True, compress_payload=True)}
STORE_FILES = ("sp.bin", "dp.bin", "w.bin", "manifest.json")


def _graphs(scale=7, seed=4):
    return (ref_rmat(scale=scale, edge_factor=6, seed=seed, weights="uniform"),
            rmat_graph(scale=scale, edge_factor=6, seed=seed,
                       weights="uniform"))


def _spill_both(tmp_path, flavour="plain", scale=7, seed=4):
    g_ref, g = _graphs(scale, seed)
    kw = FLAVOURS[flavour]
    pg_ref, rmap, st_ref = ref_streamed(
        g_ref, N_SHARDS, str(tmp_path / "ref"), edge_block=EDGE_BLOCK, **kw)
    pg, _, st = partition_graph_streamed(
        g, N_SHARDS, str(tmp_path / "port"), edge_block=EDGE_BLOCK,
        device="cpu", **kw)
    return g, rmap, pg_ref, st_ref, pg, st


# --------------------------------------------------------------------------
# edge stores
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_edge_store_files_identical(tmp_path, flavour):
    """Each package's spill of the same graph: identical channel files and
    manifest byte for byte, ``blocks.npz`` equal array by array, identical
    ``signature()``."""
    *_, st_ref, _, st = _spill_both(tmp_path, flavour)
    for name in STORE_FILES:
        assert filecmp.cmp(os.path.join(st_ref.dir, name),
                           os.path.join(st.dir, name), shallow=False), name
    with np.load(os.path.join(st_ref.dir, "blocks.npz")) as a, \
            np.load(os.path.join(st.dir, "blocks.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert st.signature() == st_ref.signature()
    assert st.disk_bytes() == st_ref.disk_bytes()


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_edge_store_opens_in_other_package(tmp_path, flavour, writer):
    """A store spilled by one package, opened by the other (whole and as an
    owner view): the same blocks, skip() metadata and signature."""
    *_, st_ref, _, st = _spill_both(tmp_path, flavour)
    wrote = st_ref if writer == "ref" else st
    reader_cls = EdgeStreamStore if writer == "ref" else RefStore
    other = reader_cls.open(wrote.dir)
    assert other.signature() == wrote.signature()
    assert np.array_equal(other.blk_lo, wrote.blk_lo)
    assert np.array_equal(other.blk_hi, wrote.blk_hi)
    for i in range(N_SHARDS):
        view = reader_cls.open(wrote.dir, owner=i)
        for k in range(N_SHARDS):
            for a, b, c in zip(other.group_edges(i, k),
                               wrote.group_edges(i, k),
                               view.group_edges(i, k)):
                assert np.array_equal(a, b) and np.array_equal(a, c)
            ids = np.arange(0, wrote.geom.n_blocks, 2)
            out = [np.empty((len(ids) + 1, EDGE_BLOCK), dt)
                   for dt in (np.int32, np.int32, np.float32)]
            want = [np.empty_like(x) for x in out]
            assert (other.read_blocks(i, k, ids, *out)
                    == wrote.read_blocks(i, k, ids, *want))
            for a, b in zip(out, want):
                assert np.array_equal(a, b)


def test_spill_partition_matches_partition_graph_streamed(tmp_path):
    """spill_partition of an in-memory partition gives the store (and the
    vertex-only partition) that partition_graph_streamed gives."""
    from repro_torch.graph import partition_graph, spill_partition

    _, g = _graphs()
    pg_full, _ = partition_graph(g, N_SHARDS, edge_block=EDGE_BLOCK,
                                 device="cpu")
    pg_v, st = spill_partition(pg_full, str(tmp_path / "a"))
    pg_s, _, st2 = partition_graph_streamed(
        g, N_SHARDS, str(tmp_path / "b"), edge_block=EDGE_BLOCK, device="cpu")
    assert st.signature() == st2.signature()
    for name in STORE_FILES:
        assert filecmp.cmp(os.path.join(st.dir, name),
                           os.path.join(st2.dir, name), shallow=False)
    for f in ("degree", "vmask", "old_ids", "gids"):
        assert torch.equal(getattr(pg_v, f), getattr(pg_s, f))
    assert pg_s.src_pos.numel() == 0 and pg_s.eweight.numel() == 0


# --------------------------------------------------------------------------
# message-run stores and codecs
# --------------------------------------------------------------------------

def _fill_run_store(cls, directory, with_counts, compress, payload, P=50):
    """The same appends, compactions and index publish on either package's
    MessageRunStore; returns the store."""
    rng = np.random.default_rng(7)
    store = cls(directory, N_SHARDS, P, np.float32 if payload != "bf16"
                else np.float32, with_counts=with_counts, compress=compress,
                compress_payload=payload)
    for dest in range(N_SHARDS):
        for tag in range(N_SHARDS):
            for _ in range(3):
                if with_counts:
                    cnt = rng.integers(0, 3, P).astype(np.int32)
                    A = rng.standard_normal(P).astype(np.float32)
                    store.append_combined(dest, A, cnt, tag=tag)
                else:
                    m = 40
                    dp = rng.integers(0, P, m).astype(np.int32)
                    msg = rng.standard_normal(m).astype(np.float32)
                    valid = rng.random(m) < 0.8
                    store.append_raw(dest, dp, msg, valid, tag=tag)
            if not with_counts:
                store.compact_tag(dest, tag, fanin=2, read_chunk=16)
    store.save_index()
    store.close()
    return store


RUN_CASES = [(wc, comp, pay) for wc in (False, True) for comp in (False, True)
             for pay in (False, "lossless")]


@pytest.mark.parametrize("with_counts,compress,payload", RUN_CASES)
def test_message_run_store_crosses_packages(tmp_path, with_counts, compress,
                                            payload):
    """Run stores written by both packages are byte-identical (data files
    and index); each opens in the other package with the same runs, counts
    and merged slices."""
    ref = _fill_run_store(RefRunStore, str(tmp_path / "ref"), with_counts,
                          compress, payload)
    port = _fill_run_store(MessageRunStore, str(tmp_path / "port"),
                           with_counts, compress, payload)
    names = sorted(os.listdir(ref.dir))
    assert names == sorted(os.listdir(port.dir))
    for name in names:
        assert filecmp.cmp(os.path.join(ref.dir, name),
                           os.path.join(port.dir, name), shallow=False), name
    for a, b in ((MessageRunStore.open(ref.dir), ref),
                 (RefRunStore.open(port.dir), port)):
        for dest in range(N_SHARDS):
            assert ([s.__dict__ for s in a.runs(dest)]
                    == [s.__dict__ for s in b.runs(dest)])
            assert np.array_equal(a.dest_counts(dest), b.dest_counts(dest))
            if with_counts:
                for sa, sb in zip(a.runs(dest), b.runs(dest)):
                    for x, y in zip(a.read_combined(dest, sa, 0.0),
                                    b.read_combined(dest, sb, 0.0)):
                        assert np.array_equal(x, y)
            else:
                got = list(a.merged_slices(dest, 256, 16))
                want = list(b.merged_slices(dest, 256, 16))
                assert len(got) == len(want)
                for sa, sb in zip(got, want):
                    for x, y in zip(sa, sb):
                        assert np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["varint", "lossless", "bf16"])
def test_codec_blobs_identical_and_cross_decode(kind):
    rng = np.random.default_rng(11)
    if kind == "varint":
        vals = np.sort(rng.integers(-5, 10**6, 3000)).astype(np.int64)
        enc = codec.encode_varint_delta(vals)
        assert enc == ref_codec.encode_varint_delta(vals)
        assert np.array_equal(ref_codec.decode_varint_delta(enc), vals)
        assert np.array_equal(codec.decode_varint_delta(enc), vals)
        return
    vals = rng.standard_normal(5000).astype(np.float32)
    enc = codec.encode_payload(vals, kind)
    assert enc == ref_codec.encode_payload(vals, kind)
    a = codec.decode_payload(enc, np.float32, vals.size, kind)
    b = ref_codec.decode_payload(enc, np.float32, vals.size, kind)
    assert np.array_equal(a, b)
    if kind == "lossless":
        assert np.array_equal(a, vals)


# --------------------------------------------------------------------------
# the reader's staging buffers
# --------------------------------------------------------------------------

def test_staged_chunk_folded_after_reader_advances(tmp_path):
    """A yielded chunk is valid only until the reader advances: a tensor
    that aliases it (``torch.from_numpy``) is overwritten by the next
    staged chunk, while the engine's batched single-chunk groups, folded
    only after the reader has moved on, still give each group's own
    result."""
    _, _, _, _, pg, st = _spill_both(tmp_path)
    active = np.ones((N_SHARDS, pg.P), bool)
    sched, _, _ = plan_stream_schedule(st, active)
    reader = StreamReader(st, chunk_blocks=1, depth=1)
    it = reader.stream(sched)
    first = next(it)
    alias, kept = torch.from_numpy(first.sp), np.array(first.sp)
    for _ in range(3):  # the pool holds depth + 1 = 2 buffers
        next(it)
    it.close()
    assert not np.array_equal(alias.numpy(), kept)  # the buffer was reused

    prog = tc.PageRank(3)
    nb = st.geom.n_blocks
    cfg = lambda G: tc.EngineConfig(
        mode="streamed", stream=tc.StreamConfig(chunk_blocks=nb, depth=1,
                                                group_batch=G))
    results = {}
    for G in (1, 4):
        eng = tc.GraphDEngine(pg, prog, cfg(G), device="cpu", stream_store=st)
        eng.io_history = [type(reader.stats)()]
        v, a = eng.init()
        got = []
        eng._fold_groups(v, a, 0, sched,
                         lambda i, k, A, c: got.append((i, k, A.clone(),
                                                        c.clone())))
        results[G] = got
    assert [x[:2] for x in results[1]] == [x[:2] for x in results[4]]
    for (i, k, A1, c1), (_, _, A4, c4) in zip(results[1], results[4]):
        assert torch.equal(A1, A4) and torch.equal(c1, c4), (i, k)
        sp, dp, w = (torch.from_numpy(x.reshape(-1))
                     for x in st.group_edges(i, k))
        A = torch.zeros(pg.P)
        c = torch.zeros(pg.P, dtype=torch.int32)
        eng._stream_fold(A, c, v[i], pg.degree[i], a[i], sp, dp, w, 0)
        assert torch.equal(A, A1) and torch.equal(c, c1), (i, k)


def test_chunk_stager_gathers_copies():
    """The stager copies each chunk in at add(), so the reader may recycle
    its buffer at once; take() gives the chunks added since the last take,
    in order; a chunk that does not fit is refused."""
    stager = _ChunkStager(torch.device("cpu"), slots=16, ring=2)
    sp = np.arange(8, dtype=np.int32)
    dp = np.full(8, 3, np.int32)
    w = np.linspace(0, 1, 8, dtype=np.float32)
    stager.add(sp, dp, w)
    sp[:] = -7  # the reader recycles its buffer
    stager.add(sp, dp, w * 2)
    assert not stager.room(1)
    with pytest.raises(ValueError, match="overflows"):
        stager.add(sp, dp, w)
    tsp, tdp, tw = stager.take()
    assert tsp.tolist() == list(range(8)) + [-7] * 8
    assert tdp.tolist() == [3] * 16 and tw.dtype == torch.float32
    assert np.array_equal(tw.numpy(), np.concatenate([w, w * 2]))
    assert stager.pending == 0 and stager.room(16)


@pytest.mark.parametrize("chunk_blocks,group_batch", [(2, 4), (8, 1)])
def test_engine_stager_holds_what_the_plan_names(tmp_path, chunk_blocks,
                                                 group_batch):
    """After a streamed run the engine's fold stager holds exactly the host
    bytes ``plan.fold_stager_bytes`` (named by ``explain()``) gives."""
    port_plan = importlib.import_module("repro_torch.core.plan")
    *_, pg, st = _spill_both(tmp_path)
    cfg = tc.EngineConfig(mode="streamed", stream=tc.StreamConfig(
        chunk_blocks=chunk_blocks, group_batch=group_batch))
    eng = tc.GraphDEngine(pg, tc.PageRank(3), cfg, device="cpu",
                          stream_store=st)
    eng.run()
    assert eng._stager.nbytes == port_plan.fold_stager_bytes(chunk_blocks, group_batch,
                                               EDGE_BLOCK)


# --------------------------------------------------------------------------
# streamed checkpoints, run-file logs and recovery across the packages
# --------------------------------------------------------------------------

def _streamed(pkg, pg, prog, store, **kw):
    cfg = pkg.EngineConfig(mode="streamed")
    if pkg is tc:
        return tc.GraphDEngine(pg, prog, cfg, device="cpu", stream_store=store,
                               **kw)
    return rc.GraphDEngine(pg, prog, config=cfg, stream_store=store, **kw)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_streamed_checkpoint_crosses_packages(tmp_path, writer):
    """A streamed run's checkpoint (its manifest carries the store's
    signature) restores in the other package against that package's own
    spill of the same graph; a checkpoint from another graph's store is
    refused by both."""
    _, _, pg_ref, st_ref, pg, st = _spill_both(tmp_path)
    ckdir = str(tmp_path / "ck")
    if writer == "ref":
        ck = ref_ckpt.Checkpointer(ckdir, every=2)
        (v, a), _ = _streamed(rc, pg_ref, rc.HashMin(), st_ref).run(
            max_supersteps=2, checkpointer=ck)
    else:
        ck = port_ckpt.Checkpointer(ckdir, every=2)
        (v, a), _ = _streamed(tc, pg, tc.HashMin(), st).run(
            max_supersteps=2, checkpointer=ck)
    v, a = np.asarray(v), np.asarray(a)
    rv, ra, step = port_ckpt.Checkpointer(ckdir).restore(
        expected_meta=st.signature(), device="cpu")
    assert step == 2 and np.array_equal(rv.numpy(), v)
    assert np.array_equal(ra.numpy(), a)
    jv, ja, jstep = ref_ckpt.Checkpointer(ckdir).restore(
        expected_meta=st_ref.signature())
    assert jstep == 2 and np.array_equal(np.asarray(jv), v)
    # another graph's store: both packages refuse the checkpoint
    _, g2 = _graphs(seed=9)
    _, _, other = partition_graph_streamed(
        g2, N_SHARDS, str(tmp_path / "other"), edge_block=EDGE_BLOCK,
        device="cpu")
    assert other.signature() != st.signature()
    with pytest.raises(ValueError, match="different edge streams"):
        port_ckpt.Checkpointer(ckdir).restore(
            expected_meta=other.signature(), device="cpu")
    with pytest.raises(ValueError, match="different edge streams"):
        ref_ckpt.Checkpointer(ckdir).restore(expected_meta=other.signature())
    with pytest.raises(ValueError, match="different edge streams"):
        _streamed(tc, pg, tc.HashMin(), other.__class__.open(other.dir)) \
            .run(checkpointer=port_ckpt.Checkpointer(ckdir))


#: name -> (reference program, port program, checkpoint cadence); each
#: cadence leaves supersteps after the last checkpoint to replay
RECOVER_CASES = {
    "pagerank": (lambda: rc.PageRank(6), lambda: tc.PageRank(6), 4),
    "hashmin": (rc.HashMin, tc.HashMin, 3),
    "distinct": (lambda: rc.DistinctInLabels(n_groups=7, rounds=4),
                 lambda: tc.DistinctInLabels(n_groups=7, rounds=4), 3),
}


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("name", list(RECOVER_CASES))
def test_streamed_recovery_crosses_packages(tmp_path, name, writer):
    """A logged streamed run (checkpoints + RunFileMessageLog) by one
    package; both packages' recover_shard_streamed replay one shard from it
    to the live run's row."""
    ref_prog, port_prog, every = RECOVER_CASES[name]
    _, _, pg_ref, st_ref, pg, st = _spill_both(tmp_path)
    ck_dir, log_dir = str(tmp_path / "ck"), str(tmp_path / "logs")
    if writer == "ref":
        ck = ref_ckpt.Checkpointer(ck_dir, every=every)
        eng = _streamed(rc, pg_ref, ref_prog(), st_ref,
                        message_log=ref_ckpt.RunFileMessageLog(log_dir))
    else:
        ck = port_ckpt.Checkpointer(ck_dir, every=every)
        eng = _streamed(tc, pg, port_prog(), st,
                        message_log=port_ckpt.RunFileMessageLog(log_dir))
    ck.save(0, *eng.init())
    (v, a), hist = eng.run(checkpointer=ck)
    v, a = np.asarray(v), np.asarray(a)
    target = len(hist)
    assert target - ck.latest() >= 1  # something to replay
    failed = 1
    pv, pa = port_ckpt.recover_shard_streamed(
        pg, port_prog(), failed, port_ckpt.Checkpointer(ck_dir),
        port_ckpt.RunFileMessageLog(log_dir), st, target)
    jv, ja = ref_ckpt.recover_shard_streamed(
        pg_ref, ref_prog(), failed, ref_ckpt.Checkpointer(ck_dir),
        ref_ckpt.RunFileMessageLog(log_dir), st_ref, target)
    for got, gota in ((pv.numpy(), pa.numpy()),
                      (np.asarray(jv), np.asarray(ja))):
        if name == "pagerank":
            assert np.abs(got - v[failed]).max() < 1e-6
        else:
            assert np.array_equal(got, v[failed])
        assert np.array_equal(gota, a[failed])


@pytest.mark.parametrize("capacity_blocks", [0, 1, 5, 40])
def test_residency_decisions_match_reference(tmp_path, capacity_blocks):
    """The port's hot-block cache (a heap in place of the reference's scan
    for the coldest block, and a pass-through at capacity 0) admits, hits
    and evicts exactly as the JAX package's on a random access stream, and
    fills the same staging rows."""
    from repro.streams.residency import BlockResidency as RefResidency
    from repro_torch.streams.residency import BlockResidency

    *_, st_ref, _, st = _spill_both(tmp_path)
    cap = capacity_blocks * st.block_bytes()
    ref, port = RefResidency(st_ref, cap), BlockResidency(st, cap)
    rng = np.random.default_rng(capacity_blocks)
    nb = st.geom.n_blocks
    # a skewed stream: a few hot blocks and a cold tail
    for _ in range(300):
        i, k = (int(x) for x in rng.integers(0, N_SHARDS, 2))
        ids = np.unique(np.minimum(rng.zipf(1.5, rng.integers(1, 6)) - 1,
                                   nb - 1)).astype(np.int64)
        bufs = [[np.empty((6, EDGE_BLOCK), dt)
                 for dt in (np.int32, np.int32, np.float32)]
                for _ in range(2)]
        got = port.read_blocks(st, i, k, ids, *bufs[0])
        want = ref.read_blocks(st_ref, i, k, ids, *bufs[1])
        assert got == want
        for a, b in zip(*bufs):
            assert np.array_equal(a, b)
        assert port.counters() == ref.counters()
        assert list(port._cache) == list(ref._cache)
    assert port.stats.admissions == ref.stats.admissions
    if capacity_blocks in (1, 5):
        assert ref.stats.evictions > 0  # the stream churned the cache
