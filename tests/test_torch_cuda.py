"""The port's kernels on the card against their plain versions, the
engine's kernel backend against its torch backend on the card, the other
in-memory modes and the recovery layer on the card against the CPU, and the
flat skip() prefix at a size where n*P passes 2^24.

These tests need a CUDA device and skip without one. They import neither
jax nor the JAX package, so they run on the GPU machine as they are:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    BFS, SSSP, Checkpointer, DistinctInLabels, EngineConfig, GraphDEngine,
    HashMin, LabelSpread, MessageLog, PageRank, SecondMinLabel, recover_shard,
)
from repro_torch.core.engine import _active_prefix
from repro_torch.graph import Graph, partition_graph, rmat_graph
from repro_torch.kernels import ops
from repro_torch.kernels.digest import digest, digest_plain
from repro_torch.kernels.edge_combine import (
    COMBINERS, edge_combine, edge_combine_plain, pair_counts,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph():
    g = rmat_graph(scale=10, edge_factor=8, seed=3, weights="uniform")
    return partition_graph(g, 4, edge_block=64, device="cpu")


@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("msg_kind,combiner,dtype", [
    ("div_deg", "sum", torch.float32), ("add_w", "min", torch.float32),
    ("add_1", "max", torch.float32), ("deg", "sum", torch.float32),
    ("copy", "min", torch.int32), ("copy", "max", torch.int32),
])
def test_edge_combine_kernel_matches_plain(cuda, graph, msg_kind, combiner,
                                           dtype, density):
    pg, _ = graph
    n, NB, B, P = pg.n_shards, pg.n_blocks, pg.edge_block, pg.P
    rng = np.random.default_rng(8)
    values = rng.random((n, P), dtype=np.float32)
    values = torch.from_numpy(values if dtype == torch.float32
                              else (values * 2**30).astype(np.int32))
    active = torch.from_numpy(rng.random((n, P)) < density) & pg.vmask
    dest = torch.arange(n, dtype=torch.int32).roll(1)
    keep = ops.skip_keep_mask(pg.blk_lo[torch.arange(n), dest.long()],
                              pg.blk_hi[torch.arange(n), dest.long()],
                              _active_prefix(active))
    ids, n_keep = ops.compact_blocks(keep)
    blocks = lambda a: a.view(n, n, NB, B)
    args = [values, pg.degree, active, blocks(pg.src_pos), blocks(pg.dst_pos),
            blocks(pg.eweight), dest, ids, n_keep]
    kw = dict(msg_kind=msg_kind, combiner=combiner)
    before = edge_combine.launches
    A_k, c_k = edge_combine(*[a.to(cuda) for a in args], **kw)
    torch.cuda.synchronize()
    assert edge_combine.launches == before + 1
    A_p, c_p = edge_combine_plain(*args, **kw)
    if combiner == "sum":
        torch.testing.assert_close(A_k.cpu(), A_p, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(A_k.cpu(), A_p)
    assert torch.equal(c_k.cpu(), c_p)


def _blocks_args(pg, values, active, dest, n_keep=None):
    """edge_combine's arguments for ``pg`` with every block of each group
    kept (``n_keep`` overrides how many)."""
    n, NB, B = pg.n_shards, pg.n_blocks, pg.edge_block
    blocks = lambda a: a.view(n, n, NB, B)
    ids = torch.arange(NB, dtype=torch.int32).repeat(n, 1)
    if n_keep is None:
        n_keep = torch.full((n,), NB, dtype=torch.int32)
    return [values, pg.degree, active, blocks(pg.src_pos), blocks(pg.dst_pos),
            blocks(pg.eweight), dest, ids, n_keep]


def _check_kernel(cuda, args, msg_kind, combiner):
    kw = dict(msg_kind=msg_kind, combiner=combiner)
    A_k, c_k = edge_combine(*[a.to(cuda) for a in args], **kw)
    torch.cuda.synchronize()
    A_p, c_p = edge_combine_plain(*args, **kw)
    if combiner == "sum" and A_p.dtype == torch.float32:
        torch.testing.assert_close(A_k.cpu(), A_p, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(A_k.cpu(), A_p)
    assert torch.equal(c_k.cpu(), c_p)
    return c_p


@pytest.mark.parametrize("msg_kind,combiner,dtype", [
    ("div_deg", "sum", torch.float32), ("add_w", "min", torch.float32),
    ("copy", "max", torch.int32),
])
def test_edge_combine_star_into_one_destination(cuda, msg_kind, combiner,
                                                dtype):
    """Every edge into vertex 0: all of a group's atomics on one address."""
    V = 4000
    src = np.arange(1, V, dtype=np.int64)
    g = Graph(src=src, dst=np.zeros(V - 1, dtype=np.int64),
              weight=np.linspace(0.5, 2, V - 1).astype(np.float32),
              directed=True, vertex_ids=np.arange(V, dtype=np.int64))
    pg, rmap = partition_graph(g, 2, edge_block=64, device="cpu")
    n, P = pg.n_shards, pg.P
    rng = np.random.default_rng(5)
    values = torch.from_numpy(rng.random((n, P), dtype=np.float32))
    if dtype == torch.int32:
        values = (values * 2**30).to(torch.int32)
    hub = int(rmap.to_new(np.array([0]))[0])
    dest = torch.full((n,), hub % n, dtype=torch.int32)
    cnt = _check_kernel(cuda, _blocks_args(pg, values, pg.vmask.clone(), dest),
                        msg_kind, combiner)
    assert int(cnt.sum()) == V - 1 == int(cnt[:, hub // n].sum())


def _synthetic(n, P, NB, BLK, seed, span):
    """A partition-like layout: group (i, k) holds a random number of edges
    whose sources, sorted, spread over ``span`` positions per block, to
    random destinations; padding slots are sp = -1, dp = 0, w = 0."""
    rng = np.random.default_rng(seed)
    sp = np.full((n, n, NB, BLK), -1, np.int32)
    dp = np.zeros((n, n, NB, BLK), np.int32)
    w = np.zeros((n, n, NB, BLK), np.float32)
    for i in range(n):
        for k in range(n):
            for b in range(NB):
                m = int(rng.integers(0, BLK + 1))
                lo = int(rng.integers(0, P - span))
                sp[i, k, b, :m] = np.sort(rng.integers(lo, lo + span, m))
                dp[i, k, b, :m] = rng.integers(0, P, m)
                w[i, k, b, :m] = rng.random(m)
    degree = rng.integers(0, 50, (n, P)).astype(np.int32)
    return [torch.from_numpy(a) for a in (sp, dp, w, degree)]


@pytest.mark.parametrize("BLK", [64, 36, 30])
@pytest.mark.parametrize("span", [40, 60000])
@pytest.mark.parametrize("msg_kind,combiner,dtype", [
    ("div_deg", "sum", torch.float32), ("add_w", "min", torch.float32),
    ("copy", "max", torch.int32),
])
def test_edge_combine_synthetic_blocks(cuda, BLK, span, msg_kind, combiner,
                                       dtype):
    """Blocks whose sources lie in a narrow range (span 40) or spread over
    most of the shard (span 60000); edge blocks of 64, 36 and 30 slots
    (fewer than a CTA's threads, so most threads find no slot); kept blocks
    in a random order; and a shard that keeps no block beside shards that
    keep some."""
    n, P, NB = 3, 70000, 5
    sp, dp, w, degree = _synthetic(n, P, NB, BLK, seed=BLK + span, span=span)
    rng = np.random.default_rng(span)
    values = torch.from_numpy(rng.random((n, P), dtype=np.float32))
    if dtype == torch.int32:
        values = (values * 2**30).to(torch.int32)
    active = torch.from_numpy(rng.random((n, P)) < 0.7)
    dest = torch.tensor([1, 2, 0], dtype=torch.int32)
    ids = torch.from_numpy(np.stack([rng.permutation(NB) for _ in range(n)])
                           .astype(np.int32))
    n_keep = torch.tensor([NB, 0, 3], dtype=torch.int32)
    cnt = _check_kernel(cuda, [values, degree, active, sp, dp, w, dest, ids,
                               n_keep], msg_kind, combiner)
    assert int(cnt[1].sum()) == 0 and int(cnt[0].sum()) > 0


def test_edge_combine_wide_groups_take_two_atomics(cuda):
    """At E_cap >= 2^24 a float sum keeps two atomics (pair_counts); the
    shape picks the path, and both give the plain version's result."""
    n, P, BLK = 1, 5000, 4096
    assert pair_counts(torch.float32, "sum", (2**24 - 1) // BLK * BLK)
    assert not pair_counts(torch.float32, "sum", 2**24)
    for NB in (2**24 // BLK - 1, 2**24 // BLK):
        sp, dp, w, degree = _synthetic(n, P, 6, BLK, seed=NB, span=P // 2)
        pad = lambda x, v: torch.cat(
            [x, torch.full((n, n, NB - 6, BLK), v, dtype=x.dtype)], dim=2)
        rng = np.random.default_rng(NB)
        values = torch.from_numpy(rng.random((n, P), dtype=np.float32))
        ids = torch.arange(NB, dtype=torch.int32)[None]
        _check_kernel(cuda, [values, degree, torch.ones((n, P), dtype=bool),
                             pad(sp, -1), pad(dp, 0), pad(w, 0.0),
                             torch.zeros(1, dtype=torch.int32), ids,
                             torch.tensor([NB], dtype=torch.int32)],
                      "div_deg", "sum")


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_digest_kernel_matches_plain(cuda, combiner, dtype):
    rng = np.random.default_rng(3)
    a, r = (torch.from_numpy(rng.standard_normal((8, 1000)).astype(np.float32)
                             * 1000).to(dtype) for _ in "ar")
    c, rc = (torch.from_numpy(rng.integers(0, 9, (8, 1000)).astype(np.int32))
             for _ in "ab")
    before = digest.launches
    got = digest(*(x.to(cuda) for x in (a, c, r, rc)), combiner=combiner)
    assert digest.launches == before + 1
    want = digest_plain(a, c, r, rc, combiner=combiner)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("N", [1, 7, 4099, 1 << 16])
@pytest.mark.parametrize("offset", [0, 1])
def test_digest_odd_lengths_extremes_and_unaligned(cuda, N, offset):
    """Lengths that are not a multiple of the kernel's block, int32 values
    at the min and max identities, and buffers that start off a 16-byte
    boundary."""
    rng = np.random.default_rng(N + offset)
    lim = np.array([2**31 - 1, -(2**31)], dtype=np.int32)
    a, r = (torch.from_numpy(rng.choice(lim, N + offset)) for _ in "ar")
    c, rc = (torch.from_numpy(rng.integers(0, 9, N + offset).astype(np.int32))
             for _ in "cr")
    for comb in COMBINERS:
        got = digest(*(x.to(cuda)[offset:] for x in (a, c, r, rc)),
                     combiner=comb)
        want = digest_plain(*(x[offset:] for x in (a, c, r, rc)),
                            combiner=comb)
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)


def test_wrappers_reject_cpu_cuda_mix(cuda, graph):
    pg, _ = graph
    n, NB, B = pg.n_shards, pg.n_blocks, pg.edge_block
    blocks = lambda a: a.view(n, n, NB, B)
    with pytest.raises(ValueError, match="contiguous on cuda"):
        edge_combine(torch.zeros((n, pg.P), device=cuda), pg.degree,
                     pg.vmask, blocks(pg.src_pos), blocks(pg.dst_pos),
                     blocks(pg.eweight), torch.zeros(n, dtype=torch.int32),
                     torch.zeros((n, NB), dtype=torch.int32),
                     torch.zeros(n, dtype=torch.int32), msg_kind="copy",
                     combiner="min")


@pytest.mark.parametrize("name", ["pagerank", "hashmin", "sssp", "bfs",
                                  "labelspread"])
def test_kernel_backend_matches_torch_backend_on_card(cuda, graph, name):
    pg, rmap = graph
    src = int(rmap.to_new(np.array([0]))[0])
    make = dict(pagerank=lambda: PageRank(10), hashmin=HashMin,
                sssp=lambda: SSSP(src), bfs=lambda: BFS(src),
                labelspread=LabelSpread)[name]
    runs = {}
    for backend in ("kernel", "torch"):
        eng = GraphDEngine(pg, make(), EngineConfig(backend=backend))
        assert eng.pg.device.type == "cuda"
        runs[backend] = eng.run()
    (vk, ak), hk = runs["kernel"]
    (vt, at), ht = runs["torch"]
    if name == "pagerank":
        assert float((vk - vt).abs().max()) < 1e-5
    else:
        assert torch.equal(vk, vt)
    assert torch.equal(ak, at)
    assert [(h.n_active, h.n_msgs) for h in hk] == \
        [(h.n_active, h.n_msgs) for h in ht]


MODE_CASES = [(m, p) for m in ("basic", "basic_sc", "recoded_compact",
                               "logged")
              for p in ("pagerank", "hashmin", "sssp")
              if not (m == "recoded_compact" and p == "hashmin")]
MODE_CASES += [("basic", "distinct"), ("basic", "secondmin")]


@pytest.mark.parametrize("mode,name", MODE_CASES)
def test_modes_on_card_match_cpu(cuda, graph, mode, name, tmp_path):
    """Each in-memory mode on the card against the same mode on the CPU:
    exact for the int, MIN and MAX programs; PageRank within 1e-6, and
    within recoded_compact's 2e-2 relative bar there (float sums land in
    another order on the card, and the bf16 wire can round a sum that
    differs in its last bit to the other side)."""
    pg, rmap = graph
    src = int(rmap.to_new(np.array([0]))[0])
    make = dict(pagerank=lambda: PageRank(8), hashmin=HashMin,
                sssp=lambda: SSSP(src),
                distinct=lambda: DistinctInLabels(n_groups=8, rounds=2),
                secondmin=SecondMinLabel)[name]
    runs = {}
    for dev in ("cuda", "cpu"):
        log = (MessageLog(str(tmp_path / dev)) if mode == "logged" else None)
        cfg = EngineConfig(mode="recoded" if mode == "logged" else mode,
                           backend="torch")
        eng = GraphDEngine(pg, make(), cfg, device=dev, message_log=log)
        assert eng.pg.device.type == dev
        runs[dev] = eng.run()
    (vg, ag), hg = runs["cuda"]
    (vc, ac), hc = runs["cpu"]
    vg, ag = vg.cpu(), ag.cpu()
    if name == "pagerank" and mode == "recoded_compact":
        assert float(((vg - vc).abs() / vc.abs().clamp(min=1e-9)).max()) < 2e-2
    elif name == "pagerank":
        assert float((vg - vc).abs().max()) < 1e-6
    else:
        assert torch.equal(vg, vc)
        assert [(h.n_active, h.n_msgs) for h in hg] == \
            [(h.n_active, h.n_msgs) for h in hc]
    assert torch.equal(ag, ac)


def test_checkpoint_restores_onto_card_and_recovers(cuda, graph, tmp_path):
    """restore(device="cuda") puts the state on the card; a run resumed
    from it and a shard recovered from the log match the live run."""
    pg, _ = graph
    ck = Checkpointer(str(tmp_path / "ckpt"), every=3)
    ml = MessageLog(str(tmp_path / "logs"))
    eng = GraphDEngine(pg, HashMin(), device="cuda", message_log=ml)
    ck.save(0, *eng.init())
    (v, a), hist = eng.run(checkpointer=ck)
    rv, ra, step = ck.restore(device="cuda")
    assert rv.device.type == "cuda" and ra.device.type == "cuda"
    assert step == ck.latest()
    (v2, _), h2 = GraphDEngine(pg, HashMin(), device="cuda").run(
        checkpointer=ck)
    assert h2[0].restored_from == step and torch.equal(v2, v)
    vj, aj = recover_shard(eng.pg, HashMin(), failed=1, ckpt=ck, log=ml,
                           target_step=len(hist))
    assert vj.device.type == "cuda"
    assert torch.equal(vj, v[1]) and torch.equal(aj, a[1])


def test_flat_prefix_matches_rowwise_on_card(cuda):
    """At the main path's (8, 2_100_072) bitmap, where n*P passes 2^24:
    the flat scan equals the row-wise one, row by row, and skip()'s keep
    mask on it equals the test on the row-wise prefix."""
    n, P = 8, 2_100_072
    assert n * P > 2**24
    gen = torch.Generator(device=cuda).manual_seed(0)
    active = torch.rand((n, P), generator=gen, device=cuda) < 0.3
    active[2] = True
    active[3] = False
    flat = _active_prefix(active)
    rows = torch.cat([torch.zeros((n, 1), dtype=torch.int32, device=cuda),
                      active.cumsum(1, dtype=torch.int32)], 1)
    starts = flat[torch.arange(n, device=cuda) * P][:, None]
    got = torch.stack([flat[i * P: (i + 1) * P + 1] for i in range(n)])
    assert torch.equal(got - starts, rows)
    lo = torch.randint(0, P, (n, 4096), generator=gen, device=cuda,
                       dtype=torch.int32)
    hi = (lo + torch.randint(0, 600, (n, 4096), generator=gen, device=cuda,
                             dtype=torch.int32)).clamp(max=P - 1)
    lo[:, 0], hi[:, 0] = 0, P - 1
    lo[:, 1], hi[:, 1] = P, -1
    keep = ops.skip_keep_mask(lo, hi, flat)
    want = (hi >= 0) & ((rows.gather(1, (hi.long() + 1).clamp(0, P))
                         - rows.gather(1, lo.long().clamp(0, P))) > 0)
    assert torch.equal(keep, want)
    assert not keep[:, 1].any() and not keep[3].any() and keep[2, 0]


# --------------------------------------------------------------------------
# the out-of-core streamed mode on the card
# --------------------------------------------------------------------------

STREAMED_CASES = {
    "streamed": dict(),
    "full-duplex": dict(channel=dict(pipeline=True)),
    "half-duplex": dict(channel=dict(pipeline=True, full_duplex=False)),
    "semi-external": dict(stream=dict(cache_bytes=1 << 16)),
    "chunk-256": dict(stream=dict(chunk_blocks=256)),
}


@pytest.mark.parametrize("variant", list(STREAMED_CASES))
@pytest.mark.parametrize("name", ["pagerank", "hashmin", "sssp"])
def test_streamed_on_card_matches_recoded(cuda, graph, tmp_path, name,
                                          variant):
    """A streamed run on the card equals the in-memory recoded run (kernel
    backend) of the same graph: Hash-Min and SSSP exactly, PageRank within
    1e-5 of its largest value; superstep stats and halt step equal. No
    edge tensor of the streamed partition lies on the card."""
    from repro_torch.core import ChannelConfig, StreamConfig
    from repro_torch.graph import spill_partition

    pg, rmap = graph
    src = int(rmap.to_new(np.array([0]))[0])
    prog = {"pagerank": lambda: PageRank(6), "hashmin": HashMin,
            "sssp": lambda: SSSP(src)}[name]
    pgs, store = spill_partition(pg.to(cuda), str(tmp_path / "s"))
    assert all(getattr(pgs, f).numel() == 0
               for f in ("src_pos", "dst_pos", "eweight", "blk_lo", "blk_hi"))
    kw = STREAMED_CASES[variant]
    cfg = EngineConfig(mode="streamed",
                       stream=StreamConfig(**kw.get("stream", {})),
                       channel=ChannelConfig(**kw.get("channel", {})))
    (v, a), hist = GraphDEngine(pgs, prog(), cfg,
                                stream_store=store).run()
    (rv, ra), rhist = GraphDEngine(pg.to(cuda), prog()).run()
    assert v.device.type == "cuda"
    assert [(h.n_active, h.n_msgs) for h in hist] == \
        [(h.n_active, h.n_msgs) for h in rhist]
    assert torch.equal(a, ra)
    if name == "pagerank":
        assert float((v - rv).abs().max()) < 1e-5 * float(rv.abs().max())
    else:
        assert torch.equal(v, rv)


def test_pinned_stager_never_reads_recycled_buffer(cuda):
    """The pinned, non-blocking staging path: the card is held busy so that
    every copy is still pending when put() returns; the source arrays (the
    reader's recycled buffers) and, ring after ring, the pinned buffers are
    overwritten at once, and every staged chunk still arrives intact."""
    from repro_torch.core.engine import _ChunkStager

    stager = _ChunkStager(cuda, ring=2)
    rng = np.random.default_rng(5)
    sp = np.empty(4096, np.int32)
    dp = np.empty(4096, np.int32)
    w = np.empty(4096, np.float32)
    want, got = [], []
    torch.cuda._sleep(50_000_000)  # ~25 ms of a busy card
    for _ in range(7):
        sp[:] = rng.integers(-1, 1 << 20, sp.size)
        dp[:] = rng.integers(0, 1 << 20, dp.size)
        w[:] = rng.random(w.size, dtype=np.float32)
        want.append((sp.copy(), dp.copy(), w.copy()))
        got.append(stager.put(sp, dp, w))
        sp[:] = -7  # the reader recycles its buffer at once
        dp[:] = -7
        w[:] = -7.0
    torch.cuda.synchronize()
    for (a, b, c), (x, y, z) in zip(want, got):
        assert np.array_equal(x.cpu().numpy(), a)
        assert np.array_equal(y.cpu().numpy(), b)
        assert np.array_equal(z.cpu().numpy(), c)


def test_streamed_job_and_recovery_on_card(cuda, tmp_path):
    """GraphDJob under a budget that forces mode='streamed', on the card:
    its values equal the in-memory job's, and single-shard recovery from the
    run-file log equals the live row."""
    from repro_torch.core import GraphDJob, MemoryBudget, plan

    g = rmat_graph(scale=9, edge_factor=8, seed=2)
    loose = plan(HashMin(), g, MemoryBudget(n_shards=3), edge_block=32)
    budget = MemoryBudget(ram_per_shard=loose.alternatives[0].ram_total - 1,
                          n_shards=3)
    with GraphDJob(HashMin(), g, budget=budget, edge_block=32,
                   checkpoint_every=2, workdir=str(tmp_path / "j")) as job:
        assert job.plan.mode == "streamed" and job.engine.device.type == "cuda"
        res = job.run()
        vj, aj = job.recover_shard(1)
        assert vj.device.type == "cuda"
        assert torch.equal(vj, job._state[0][1])
        assert torch.equal(aj, job._state[1][1])
    with GraphDJob(HashMin(), g, budget=MemoryBudget(n_shards=3),
                   edge_block=32, workdir=str(tmp_path / "m")) as job:
        assert job.plan.mode == "recoded"
        assert job.run().values == res.values
