"""The port's kernels on the card against their plain versions, the
engine's kernel backend against its torch backend on the card, the other
in-memory modes and the recovery layer on the card against the CPU, the
flat skip() prefix at a size where n*P passes 2^24, the multi-process
launch on the card over both transports, the torch backend's ordered float
sums (``kernels/run_sum``) bit for bit against the CPU, and the mesh.

These tests need a CUDA device and skip without one. They import neither
jax nor the JAX package, so they run on the GPU machine as they are:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import (
    BFS, SSSP, Checkpointer, DistinctInLabels, EngineConfig, GraphDEngine,
    HashMin, LabelSpread, MessageLog, PageRank, SecondMinLabel, recover_shard,
)
from repro_torch.core.engine import (
    PRESORTED, _active_prefix, _combine_scatter, _combine_sort,
)
from repro_torch.graph import Graph, partition_graph, rmat_graph
from repro_torch.kernels import ops
from repro_torch.kernels.digest import digest, digest_plain
from repro_torch.kernels.edge_combine import (
    COMBINERS, edge_combine, edge_combine_plain, pair_counts,
)
from repro_torch.kernels.run_sum import run_sum, run_sum_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph():
    g = rmat_graph(scale=10, edge_factor=8, seed=3, weights="uniform")
    return partition_graph(g, 4, edge_block=64, device="cpu")


def _runs(seed, rows, E, n_out, hub_share, skip_share=0.0):
    """Keys (some skipped) with hubs far longer than a warp's chunk, values
    of mixed magnitudes, and the stable order of the keys in each row."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, n_out, (rows, E))
    key[rng.random((rows, E)) < hub_share] = 0
    key[rng.random((rows, E)) < skip_share] = -1
    key = np.where(key >= 0, key + np.arange(rows)[:, None] * n_out, -1)
    val = (rng.standard_normal((rows, E))
           * 10.0 ** rng.integers(-4, 5, (rows, E))).astype(np.float32)
    perm = np.argsort(key, axis=-1, kind="stable")
    return torch.from_numpy(key), torch.from_numpy(val), torch.from_numpy(perm)


@pytest.mark.parametrize("perm_dtype", [None, torch.int32, torch.int64])
@pytest.mark.parametrize("rows,E,n_out,hub_share", [
    (1, 1, 1, 0.0), (1, 300, 7, 0.0), (3, 5000, 2000, 0.0),
    (2, 200_000, 50_000, 0.5), (8, 70_000, 3_000, 0.2)])
def test_run_sum_kernel_equals_the_cpu(cuda, perm_dtype, rows, E, n_out,
                                       hub_share):
    """The kernel on the card against its plain version on the CPU, bit for
    bit: short runs, runs spanning many warps' chunks (a hub of 100,000
    values), skipped keys, positions read directly or through an int32 or
    int64 permutation."""
    key, val, perm = _runs(rows, rows, E, n_out, hub_share, 0.1)
    if perm_dtype is None:  # positions already in order
        key, val, perm = key.gather(1, perm), val.gather(1, perm), None
    else:
        perm = perm.to(perm_dtype)
    want = run_sum_plain(key, val, rows * n_out, perm)
    before = run_sum.launches
    got = run_sum(key.to(cuda), val.to(cuda), rows * n_out,
                  None if perm is None else perm.to(cuda))
    torch.cuda.synchronize()
    assert run_sum.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("caller", ["dense", "per-call", "basic_sc",
                                    "basic"])
def test_combine_scatter_on_card_equals_cpu(cuda, caller):
    """_combine_scatter's float sum on the card gives the CPU's bits for
    each caller's inputs, with hub destinations of 30,000 messages; twice
    on the card, the same bits."""
    rng = np.random.default_rng(11)
    rows, E, P = 4, 60_000, 5_000
    dp = rng.integers(0, P, (rows, E)).astype(np.int32)
    dp[rng.random((rows, E)) < 0.5] = 3
    msg = (rng.standard_normal((rows, E))
           * 10.0 ** rng.integers(-4, 5, (rows, E))).astype(np.float32)
    aact = rng.random((rows, E)) < 0.8
    msg = np.where(aact, msg, np.float32(0))
    prog = PageRank(1)

    def call(dev):
        m, d, a = (torch.from_numpy(x).to(dev) for x in (msg, dp, aact))
        if caller == "dense":
            order = torch.sort(d, dim=-1, stable=True).indices.int()
            return _combine_scatter(prog, P, m, d, a, order)
        if caller == "per-call":
            return _combine_scatter(prog, P, m, d, a)
        if caller == "basic_sc":
            return _combine_sort(prog, P, m, d, a)
        sdp, order = torch.sort(torch.where(a, d, P), dim=-1, stable=True)
        valid = sdp < P
        slot = order // (E // 4) * P + torch.where(valid, sdp, 0)
        return _combine_scatter(prog, 4 * P, m.gather(1, order), slot,
                                valid, PRESORTED)

    A_cpu, c_cpu = call("cpu")
    A1, c1 = call(cuda)
    A2, _ = call(cuda)
    assert torch.equal(A1.cpu().view(torch.int32), A_cpu.view(torch.int32))
    assert torch.equal(A2, A1) and torch.equal(c1.cpu(), c_cpu)


@pytest.mark.parametrize("mode", ["recoded", "basic", "basic_sc",
                                  "recoded_compact"])
def test_torch_backend_is_reproducible_on_card(cuda, graph, mode):
    """Two emulated PageRank runs of one mode on the card are identical,
    bit for bit (recoded_compact's bf16 wire included), and the run
    launched the ordered sum."""
    pg, _ = graph
    before = run_sum.launches
    runs = [GraphDEngine(pg, PageRank(6), EngineConfig(
        mode=mode, backend="torch"), device="cuda").run()
        for _ in range(2)]
    (v1, a1), h1 = runs[0]
    (v2, a2), h2 = runs[1]
    assert torch.equal(v1, v2) and torch.equal(a1, a2)
    assert [h.agg for h in h1] == [h.agg for h in h2]
    assert run_sum.launches > before


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


@pytest.mark.parametrize("name", ["hashmin", "pagerank"])
def test_processes_job_on_card_matches_threads(cuda, tmp_path, name):
    """GraphDJob(launch="processes") on the card: three worker processes,
    each on the card, against the threads launch of the same plan (Hash-Min
    exactly; PageRank within 1e-6 of its largest value, the fold's float
    atomics being unordered on the card); then kill -9 of worker 1 in
    superstep 2 respawns it alone to the undisturbed result."""
    import copy

    from repro_torch.core import GraphDJob, MemoryBudget, plan

    g = rmat_graph(scale=9, edge_factor=8, seed=2)
    prog = HashMin if name == "hashmin" else (lambda: PageRank(4))
    p = plan(prog(), g, MemoryBudget(n_shards=3), edge_block=32,
             launch="processes")
    runs = {}
    for launch in ("threads", "processes"):
        with GraphDJob(prog(), g, plan=copy.deepcopy(p), launch=launch,
                       workdir=str(tmp_path / launch)) as job:
            res = job.run()
            runs[launch] = (res, job._state)
    (rt, (vt, at)), (rp, (vp, ap)) = runs["threads"], runs["processes"]
    assert vp.device.type == "cuda"
    assert [(h.n_active, h.n_msgs) for h in rp.history] == \
           [(h.n_active, h.n_msgs) for h in rt.history]
    assert torch.equal(ap, at)
    if name == "hashmin":
        assert torch.equal(vp, vt)
    else:
        assert float((vp - vt).abs().max()) < 1e-6 * float(vt.abs().max())
        return
    with GraphDJob(HashMin(), g, plan=copy.deepcopy(p), launch="processes",
                   checkpoint_every=2, workdir=str(tmp_path / "drill"),
                   launch_opts={"kill": {"shard": 1, "step": 2}}) as job:
        res = job.run()
        assert job._last_run_recoveries == 1
        assert torch.equal(job._state[0], vt)
        assert res.values == rt.values


@pytest.mark.parametrize("case", ["against_files", "coord_kill"])
def test_socket_transport_on_card(cuda, tmp_path, case):
    """GraphDJob(launch="processes", transport="sockets") on the card:
    three worker processes on the card and a coordinator process, against
    the file transport's run of the same plan (Hash-Min exactly, PageRank
    within 1e-6 of its largest value); then kill -9 of the coordinator in
    superstep 1's barrier, which costs one coordinator respawn, no worker
    respawn, and no change to the Hash-Min result."""
    import copy

    from repro_torch.core import GraphDJob, MemoryBudget, plan

    g = rmat_graph(scale=9, edge_factor=8, seed=2)
    p = plan(HashMin(), g, MemoryBudget(n_shards=3), edge_block=32,
             launch="processes")
    socks = {"transport": "sockets"}
    if case == "against_files":
        for name, prog in (("hashmin", HashMin),
                           ("pagerank", lambda: PageRank(4))):
            out = {}
            for label, opts in (("files", None), ("sockets", socks)):
                with GraphDJob(prog(), g, plan=plan(
                        prog(), g, MemoryBudget(n_shards=3), edge_block=32,
                        launch="processes"), launch="processes",
                        launch_opts=opts,
                        workdir=str(tmp_path / name / label)) as job:
                    res = job.run()
                    out[label] = (res, job._state)
                    if label == "sockets":
                        assert job._last_run_net["net_wire_bytes"] > 0
                        assert not os.path.exists(os.path.join(
                            job._dir("procs", job._tag), "announce"))
            (rf, (vf, af)), (rs, (vs, as_)) = out["files"], out["sockets"]
            assert vs.device.type == "cuda"
            assert [(h.n_active, h.n_msgs) for h in rs.history] == \
                   [(h.n_active, h.n_msgs) for h in rf.history]
            assert torch.equal(as_, af)
            if name == "hashmin":
                assert torch.equal(vs, vf)
            else:
                assert float((vs - vf).abs().max()) < \
                    1e-6 * float(vf.abs().max())
        return
    with GraphDJob(HashMin(), g, plan=copy.deepcopy(p),
                   workdir=str(tmp_path / "ref")) as ref:
        r_ref = ref.run()
    with GraphDJob(HashMin(), g, plan=copy.deepcopy(p), launch="processes",
                   checkpoint_every=2, workdir=str(tmp_path / "drill"),
                   launch_opts={**socks, "coord_kill": {
                       "step": 1, "after_arrivals": 1}}) as job:
        res = job.run()
        assert job._last_run_coord_restarts == 1
        assert job._last_run_recoveries == 0
        assert res.values == r_ref.values
        assert [(h.n_active, h.n_msgs) for h in res.history] == \
               [(h.n_active, h.n_msgs) for h in r_ref.history]


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_mesh_on_card(cuda, tmp_path, backend):
    """GraphDEngine(mesh=) on the card through launch.mesh: gloo with two
    ranks on one card (through host buffers), NCCL with one rank a GPU
    where there are two GPUs or more. Against the emulated run on the card:
    Hash-Min exactly, the kernel backend's PageRank within 1e-5 of its
    largest value (edge_combine's float atomics are unordered); the torch
    backend's recoded_compact and logged PageRank (a message log and a
    checkpoint every 2, resumed from it after) bit for bit, and the files
    the ranks wrote equal the emulated run's. Both kernels launch on every
    rank, edge_combine n times and digest n-1 times a superstep."""
    from repro_torch.launch.mesh import CaseFiles, run_mesh_cases, visible_gpus

    gpus = visible_gpus()
    if backend == "nccl" and len(gpus) < 2:
        pytest.skip(f"NCCL runs one rank a GPU, and this machine shows "
                    f"{len(gpus)} GPU: the mesh needs two")
    n = 2
    g = rmat_graph(scale=10, edge_factor=8, seed=3, weights="uniform")
    pg, _ = partition_graph(g, n, edge_block=64)
    torch_cfg = EngineConfig(backend="torch")
    mesh_files = CaseFiles(log=str(tmp_path / "m-log"),
                           ckpt=str(tmp_path / "m-ckpt"), every=2)
    cases = [(PageRank(4), EngineConfig(backend="kernel")),
             (HashMin(), EngineConfig(backend="kernel")),
             (PageRank(4), EngineConfig(mode="recoded_compact",
                                        backend="torch")),
             (PageRank(5), torch_cfg, mesh_files),
             (PageRank(5), torch_cfg, mesh_files)]
    run = run_mesh_cases(pg, cases, backend=backend,
                         gpus=gpus[:1] if backend == "gloo" else gpus[:n],
                         workdir=str(tmp_path / "mesh"), timeout=300)
    emu_log = MessageLog(str(tmp_path / "e-log"))
    emu_ck = Checkpointer(str(tmp_path / "e-ckpt"), every=2)
    for i, (case, res) in enumerate(zip(cases, run.results)):
        prog, cfg = case[0], case[1]
        logged = len(case) > 2
        (v, a), hist = GraphDEngine(
            pg, prog, cfg, message_log=emu_log if logged else None).run(
                checkpointer=emu_ck if logged else None)
        assert [(h.n_active, h.n_msgs) for h in res.history] == \
            [(h.n_active, h.n_msgs) for h in hist]
        assert torch.equal(res.active, a.cpu())
        if isinstance(prog, HashMin) or cfg.backend == "torch":
            assert torch.equal(res.values, v.cpu()), i
        else:
            gap = float((res.values - v.cpu()).abs().max())
            assert gap < 1e-5 * float(v.abs().max())
        steps = len(hist)
        for r in res.ranks:
            if cfg.backend == "kernel":
                assert r["launches"]["edge_combine"] == n * steps
                assert r["launches"]["digest"] == (n - 1) * steps
                assert r["bytes"]["ring"] == (n - 1) * pg.P * 8 * steps
            else:
                assert r["launches"]["run_sum"] > 0
                per = 3 if cfg.mode == "recoded_compact" else 8
                assert r["bytes"]["all_to_all"] == n * pg.P * per * steps
            assert (r["bytes"]["staged"] > 0) == (backend == "gloo")
    resumed = run.results[-1]
    assert resumed.history[0].restored_from == 4
    for sub in ("log", "ckpt"):
        for d, _, fs in os.walk(str(tmp_path / f"e-{sub}")):
            for f in fs:
                rel = os.path.relpath(os.path.join(d, f),
                                      str(tmp_path / f"e-{sub}"))
                mine = os.path.join(str(tmp_path / f"m-{sub}"), rel)
                if f.endswith(".npz"):
                    with np.load(os.path.join(d, f)) as x, \
                            np.load(mine) as y:
                        for k in x.files:
                            np.testing.assert_array_equal(x[k], y[k])
