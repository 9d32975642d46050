"""The port's kernels on the card against their plain versions, the
engine's kernel backend against its torch backend on the card, the other
in-memory modes and the recovery layer on the card against the CPU, the
flat skip() prefix at a size where n*P passes 2^24, the multi-process
launch on the card over both transports, the torch backend's ordered float
sums (``kernels/run_sum``, and its accumulating form under the streamed
fold and ``segment_sum``) bit for bit against the CPU, the mesh, LM
serving (one full-width gemma3-12b pattern group in float32 against the
CPU, greedy decoding run twice, the ring past the window), and LM training
at reduced size (microbatches and int8 compression on the card against
the CPU, a checkpoint's resume against the run it broke, two runs with
the same bits).

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
from repro_torch.core import segment_sum
from repro_torch.core.engine import (
    PRESORTED, StreamKernels, _active_prefix, _combine_scatter,
    _combine_sort,
)
from repro_torch.graph import Graph, partition_graph, rmat_graph
from repro_torch.kernels import ops
from repro_torch.kernels.digest import digest, digest_plain
from repro_torch.kernels.edge_combine import (
    COMBINERS, edge_combine, edge_combine_plain, pair_counts,
)
from repro_torch.kernels import run_sum as run_sum_mod
from repro_torch.kernels.run_sum import mark, run_sum, run_sum_plain


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


@pytest.mark.parametrize("perm_dtype", [None, torch.int32])
@pytest.mark.parametrize("rows,E,n_out,hub_share", [
    (1, 300, 7, 0.0), (2, 200_000, 50_000, 0.5), (8, 70_000, 3_000, 0.2)])
def test_run_sum_accumulating_kernel_equals_the_cpu(cuda, perm_dtype, rows,
                                                    E, n_out, hub_share):
    """The accumulating form (each run's chain from out[k]) on the card
    against its plain version on the CPU, bit for bit; keys with no run
    keep their value."""
    key, val, perm = _runs(rows + 7, rows, E, n_out, hub_share, 0.1)
    if perm_dtype is None:
        key, val, perm = key.gather(1, perm), val.gather(1, perm), None
    else:
        perm = perm.to(perm_dtype)
    rng = np.random.default_rng(rows)
    start = torch.from_numpy((rng.standard_normal(rows * n_out) * 10.0 **
                              rng.integers(-4, 5, rows * n_out)
                              ).astype(np.float32))
    want = run_sum_plain(key, val, rows * n_out, perm, out=start.clone())
    before = run_sum.launches
    out = start.to(cuda)
    got = run_sum(key.to(cuda), val.to(cuda), rows * n_out,
                  None if perm is None else perm.to(cuda), out=out)
    torch.cuda.synchronize()
    assert got is out and run_sum.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _laid_out(rows, E, runs, seed):
    """Row-local keys and values whose positions, read through a random
    permutation of each row, stand in the given runs: ``runs(r)`` lists row
    r's (key, length) in position order, a key of -1 for skipped
    positions, the rest of the row skipped. Values mix magnitudes with
    -0.0, +-inf, NaN and subnormals."""
    rng = np.random.default_rng(seed)
    seq = np.full((rows, E), -1, np.int64)
    for r in range(rows):
        at = 0
        for k, n in runs(r):
            seq[r, at:at + n] = k
            at += n
        assert at <= E
    perm = np.stack([rng.permutation(E) for _ in range(rows)])
    key = np.empty_like(seq)
    np.put_along_axis(key, perm, seq, -1)
    val = (rng.standard_normal((rows, E))
           * 10.0 ** rng.integers(-4, 5, (rows, E))).astype(np.float32)
    special = np.array([-0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39,
                        1.2e-38], np.float32)
    pick = rng.random((rows, E)) < 0.001
    val[pick] = rng.choice(special, int(pick.sum()))
    return key, val, perm


def _same_bits(got, want):
    """Equal bits, but where the CPU's sum is NaN: there the card's add
    returns its canonical NaN and the CPU's keeps an operand's payload, so
    NaN stands for NaN."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _hub_among_short(r):
    rng = np.random.default_rng(r)
    runs, k = [], 0
    for _ in range(3000):
        runs.append((k, int(rng.integers(1, 4))))
        k += 1
    runs.insert(1700, (k, 30_000))
    return runs


#: run layouts of the card's run_sum tests, given the kernel's tile T (the
#: positions a block adds before it carries a run on, read from the built
#: kernel): (rows, E, n_out, runs)
RUN_CASES = {
    # one run over many tiles: 100,000 positions of one key
    "one long run": lambda T: (1, 100_500, 10,
                               lambda r: [(-1, 200), (3, 100_000)]),
    "hub among short runs": lambda T: (2, 45_000, 3_100, _hub_among_short),
    # runs of a tile's length and one off it, from a tile's first position
    # (and ending on a tile's last), and ones over two tiles
    "a tile long, and one off": lambda T: (3, 12 * T, 40, lambda r: [
        (k, n) for k, n in enumerate(
            [T, T - 1, 1, T + 1, 2 * T - 1, 1, 2 * T, 2 * T + 1, T - 2,
             3])]),
    # a run from just before a tile's end to the row's end, two tiles on
    "across a tile to the row's end": lambda T: (2, 3 * T + 17, 50, lambda r: [
        (1, T - 60), (2, 1), (3, 2 * T + 76)]),
    "several hubs in each of 8 rows": lambda T: (8, 30_000, 300, lambda r: [
        (k, 1_200 + 499 * ((k + r) % 5) if k % 40 == 3 else 1 + k % 3)
        for k in range(300)]),
    "skipped keys before and after": lambda T: (2, 20_000, 200, lambda r: [
        (-1, 3_000)] + [(k, 1 + 50 * (k % 4)) for k in range(150)]
        + [(-1, 1_000)]),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
@pytest.mark.parametrize("keys", ["flat int64", "row-local int32",
                                  "row-local int32, runs marked"])
@pytest.mark.parametrize("perm_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("accumulate", [False, True])
def test_run_sum_kernel_runs_long_and_short(cuda, case, keys, perm_dtype,
                                            accumulate):
    """The kernel against its plain version on the CPU, bit for bit, on
    runs within a tile and runs carried from tile to tile: one run of
    100,000 values, a 30,000-value hub among runs of 1-3, runs of a tile's
    length and one off it from a tile's first position and over two tiles,
    a run from just before a tile's end to its row's end, several hubs in
    every one of 8 rows, skipped keys before and after the runs, and values
    with -0.0, +-inf, NaN and subnormals; flat and row-local keys, the
    latter also with their runs marked in the permutation's sign bit (keys
    read a run), both permutation types, both forms; one launch a call."""
    rows, E, n_out, runs = RUN_CASES[case](run_sum_mod.tile())
    key, val, perm = _laid_out(rows, E, runs, seed=len(case))
    stride = None
    if keys == "flat int64":
        key = np.where(key >= 0, key + np.arange(rows)[:, None] * n_out, -1)
    else:
        key, stride = key.astype(np.int32), n_out
    key, val = torch.from_numpy(key), torch.from_numpy(val)
    perm = torch.from_numpy(perm).to(perm_dtype)
    marked = keys.endswith("marked")
    if marked:
        perm = mark(perm, key)
    start = None
    if accumulate:
        rng = np.random.default_rng(rows)
        start = torch.from_numpy((rng.standard_normal(rows * n_out)
                                  * 10.0 ** rng.integers(-4, 5, rows * n_out)
                                  ).astype(np.float32))
        start[::97] = -0.0
    want = run_sum_plain(key, val, rows * n_out, perm,
                         None if start is None else start.clone(), stride,
                         marked)
    before = run_sum.launches
    got = run_sum(key.to(cuda), val.to(cuda), rows * n_out, perm.to(cuda),
                  None if start is None else start.to(cuda), stride, marked)
    torch.cuda.synchronize()
    assert run_sum.launches == before + 1
    _same_bits(got, want)


def test_streamed_fold_and_segment_sum_on_card_equal_cpu(cuda):
    """StreamKernels.fold of one group over three staged calls into one
    accumulator, with a hub destination of ~45,000 messages, and
    segment_sum over sorted runs: the card's bits are the CPU's, twice."""
    rng = np.random.default_rng(21)
    P, slots = 4_000, 30_000
    prog = PageRank(1)
    kern = StreamKernels(prog, 1, P, P)
    values = (rng.standard_normal(P)
              * 10.0 ** rng.integers(-4, 5, P)).astype(np.float32)
    degree = rng.integers(1, 9, P).astype(np.int32)
    active = rng.random(P) < 0.8
    chunks = []
    for _ in range(3):
        dp = rng.integers(0, P, slots).astype(np.int32)
        dp[rng.random(slots) < 0.5] = 7
        chunks.append((rng.integers(-1, P, slots).astype(np.int32), dp,
                       rng.random(slots).astype(np.float32)))
    dst = np.sort(np.where(rng.random((3, slots)) < 0.1, P, np.where(
        rng.random((3, slots)) < 0.4, 5, rng.integers(0, P, (3, slots)))),
        axis=-1).astype(np.int32)
    msg = (rng.standard_normal((3, slots))
           * 10.0 ** rng.integers(-4, 5, (3, slots))).astype(np.float32)

    def run(dev):
        t = lambda x: torch.from_numpy(x).to(dev)
        A = torch.zeros(P, device=dev)
        cnt = torch.zeros(P, dtype=torch.int32, device=dev)
        for sp, dp, w in chunks:
            kern.fold(A, cnt, t(values), t(degree), t(active), t(sp), t(dp),
                      t(w), 1)
        return A.cpu(), cnt.cpu(), segment_sum(t(dst), t(msg), P).cpu()

    before = run_sum.launches
    cpu, card, again = run("cpu"), run(cuda), run(cuda)
    assert run_sum.launches == before + 8  # 3 folds and a segment_sum, twice
    for a, b, c in zip(cpu, card, again):
        assert torch.equal(b.view(torch.int32), a.view(torch.int32))
        assert torch.equal(c.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("variant", ["streamed", "full-duplex",
                                     "chunk-256"])
def test_streamed_pagerank_on_card_is_reproducible(cuda, graph, tmp_path,
                                                   variant):
    """Two streamed PageRank runs on the card are identical, bit for bit:
    the fold adds each destination's messages in the stated order
    (run_sum launched), multi-chunk groups folded over several calls."""
    from repro_torch.core import ChannelConfig, StreamConfig
    from repro_torch.graph import spill_partition

    pg, _ = graph
    pgs, store = spill_partition(pg.to(cuda), str(tmp_path / "s"))
    kw = STREAMED_CASES[variant]
    cfg = EngineConfig(mode="streamed",
                       stream=StreamConfig(**kw.get("stream", {})),
                       channel=ChannelConfig(**kw.get("channel", {})))
    before = run_sum.launches
    runs = [GraphDEngine(pgs, PageRank(6), cfg, device=cuda,
                         stream_store=store).run() for _ in range(2)]
    (v1, a1), h1 = runs[0]
    (v2, a2), h2 = runs[1]
    assert v1.device.type == "cuda"
    assert torch.equal(v1, v2) and torch.equal(a1, a2)
    assert [h.agg for h in h1] == [h.agg for h in h2]
    assert run_sum.launches > before


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


# ---------------------------------------------------------------------------
# LM serving (no kernel of its own): the card against the CPU and itself
# ---------------------------------------------------------------------------

def _lm_logits(model, tokens, S, dec, device):
    """Logits of a prefill over ``tokens[:, :S]`` and of ``dec`` decode
    steps fed the next tokens, on fresh caches, stacked (1 + dec, B, V)."""
    from repro_torch.serving.cache import make_caches
    from repro_torch.serving.engine import decode_step, prefill

    caches = make_caches(model.cfg, tokens.shape[0], S + dec, device=device)
    out = [prefill(model, tokens[:, :S], caches)]
    for p in range(S, S + dec):
        out.append(decode_step(model, caches, tokens[:, p:p + 1], p))
    return torch.stack(out)


def test_lm_one_pattern_group_float32_card_equals_cpu(cuda):
    """Smoke phase 16(a): gemma3-12b's first pattern group (5 local layers,
    1 global) at full width and vocab in float32, TF32 off; a prefill of 16
    and 4 decode steps on the card within 1e-4 of the largest |logit| of
    the same weights on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import Transformer, init_params

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config("gemma3-12b").with_groups(1),
                              dtype=torch.float32)
    card = init_params(cfg, 0, cuda)
    host = Transformer(cfg, {k: v.cpu() for k, v in card.state_dict().items()})
    toks = synthetic_batch(cfg, 0, 20, 2, device="cpu")["tokens"]
    got = _lm_logits(card, toks.to(cuda), 16, 4, cuda).cpu()
    want = _lm_logits(host, toks, 16, 4, "cpu")
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_lm_bf16_greedy_twice_identical_on_card(cuda):
    """Two greedy runs of a full-width gemma3-12b pattern group in bf16,
    past the window: the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.cache import make_caches
    from repro_torch.serving.engine import greedy_generate

    cfg = get_config("gemma3-12b").with_groups(1)
    model = init_params(cfg, 1, cuda)
    prompt = synthetic_batch(cfg, 0, 1030, 2, device=cuda)["tokens"]
    runs = [greedy_generate(model, prompt,
                            make_caches(cfg, 2, 1030 + 8, device=cuda), 8)
            for _ in range(2)]
    assert runs[0].shape == (2, 8) and runs[0].dtype == torch.int32
    assert torch.equal(runs[0], runs[1])


def test_lm_ring_decode_matches_forward_on_card(cuda):
    """A reduced gemma3 with its window set to 8 and a 13-token prompt
    (past the window, not a multiple of it), float32: the prefill and six
    decode steps against ``forward`` over the same tokens on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import init_params

    cfg = get_config("gemma3-12b").reduced()
    cfg = dataclasses.replace(cfg, dtype=torch.float32, pattern=tuple(
        dataclasses.replace(s, window=8) if s.window else s
        for s in cfg.pattern))
    model = init_params(cfg, 2, cuda)
    toks = synthetic_batch(cfg, 0, 13 + 6, 2, device=cuda)["tokens"]
    got = _lm_logits(model, toks, 13, 6, cuda)
    want = model(toks)[:, 12:].transpose(0, 1)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ---------------------------------------------------------------------------
# LM training (no kernel of its own): the card against the CPU and itself
# ---------------------------------------------------------------------------

def _train(cfg, device, steps, microbatches=1, seed=0, model=None,
           opt=None, first=0):
    """``steps`` AdamW steps (lr 1e-3 after one warmup step) of a model
    from ``seed`` (or of ``model``/``opt``) on the batches of steps
    ``first``.. (B = 4, S = 16): the model, its state, the last metrics."""
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train import init_train_state, make_train_step

    if model is None:
        model = init_params(cfg, seed, device)
        opt = init_train_state(cfg, model)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=30), microbatches)
    for s in range(first, first + steps):
        model, opt, m = step(model, opt, synthetic_batch(cfg, s, 16, 4,
                                                         device=device))
    return model, opt, m


def _to(model, device):
    from repro_torch.models.transformer import Transformer

    return Transformer(model.cfg, {k: v.to(device, copy=True) for k, v in
                                   model.state_dict().items()})


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "minitron-4b"])
def test_train_microbatches_and_compress_on_card_match_cpu(cuda, name):
    """Reduced, float32, ``microbatches=2`` and ``grad_compress``: two
    steps on the card against the same weights on the CPU. The loss and
    grad_norm within rtol 1e-4; mu within 1e-2 of its leaf's largest |mu|
    (a quantization code at a rounding boundary may differ, moving mu by
    (1 - b1)/127 of the largest |g|), the weights within 2·lr a step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.training.train import init_train_state

    cfg = dataclasses.replace(get_config(name).reduced(), dtype=torch.float32,
                              grad_compress=True)
    card = init_params(cfg, 4, cuda)
    host = _to(card, "cpu")
    card, copt, cm = _train(cfg, cuda, 2, 2, model=card,
                            opt=init_train_state(cfg, card))
    host, hopt, hm = _train(cfg, "cpu", 2, 2, model=host,
                            opt=init_train_state(cfg, host))
    for key in ("loss", "grad_norm"):
        assert float(cm[key]) == pytest.approx(float(hm[key]), rel=1e-4)
    for k, v in hopt["mu"].items():
        assert float((copt["mu"][k].cpu() - v).abs().max()) <= 1e-2 * float(
            v.abs().max()), k
    for (k, p), q in zip(card.named_parameters(), host.parameters()):
        assert float((p.detach().cpu() - q).abs().max()) <= 2 * 1e-3 * 2, k


def test_train_checkpoint_resume_on_card_equals_uninterrupted(cuda, tmp_path):
    """bf16, compressed: 2 steps, save, restore into a model from another
    seed on the card, 2 more steps: the bits of 4 steps without a break."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import restore_train_ckpt, save_train_ckpt
    from repro_torch.models.transformer import init_params
    from repro_torch.training.train import init_train_state

    cfg = dataclasses.replace(get_config("minitron-4b").reduced(),
                              grad_compress=True)
    whole, wopt, wm = _train(cfg, cuda, 4)
    first, fopt, _ = _train(cfg, cuda, 2)
    save_train_ckpt(str(tmp_path), 2, first, fopt)
    later = init_params(cfg, 7, cuda)
    n, later, lopt = restore_train_ckpt(str(tmp_path), later,
                                        init_train_state(cfg, later))
    assert n == 2 and lopt["step"].device == later.embed.device
    later, lopt, lm = _train(cfg, cuda, 2, model=later, opt=lopt, first=n)
    assert torch.equal(wm["loss"], lm["loss"])
    assert all(torch.equal(a, b) for a, b in zip(whole.parameters(),
                                                 later.parameters()))
    for m in ("mu", "nu", "err"):
        assert all(torch.equal(wopt[m][k], lopt[m][k]) for k in wopt[m])


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "hymba-1.5b",
                                  "minitron-4b", "whisper-large-v3"])
def test_train_twice_identical_on_card(cuda, name):
    """Reduced, bf16, remat on: two 3-step runs from one seed give the same
    loss and weight bits (the embedding's backward adds in a fixed order,
    the MoE combine adds a token's copies in order)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(name).reduced(), remat=True)
    runs = [_train(cfg, cuda, 3) for _ in range(2)]
    (m0, _, a), (m1, _, b) = runs
    assert torch.isfinite(a["loss"]) and torch.equal(a["loss"], b["loss"])
    assert all(torch.equal(p, q) for p, q in zip(m0.parameters(),
                                                 m1.parameters()))


# ---------------------------------------------------------------------------
# the LM train step on a (data, model) process mesh (launch/lm_mesh.py)
# ---------------------------------------------------------------------------

def _lm_mesh_case(dtype):
    """Reduced minitron-4b, weights from numpy seed 0, its batch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import param_shapes

    cfg = dataclasses.replace(get_config("minitron-4b").reduced(),
                              dtype=dtype)
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy((rng.standard_normal(s) * 0.02).astype(
        np.float32)).to(dtype) for k, s in param_shapes(cfg).items()}
    return cfg, params, synthetic_batch(cfg, 0, 32, 8, device="cpu")


def _lm_mesh_close(got, want):
    """float32 bars (tests/test_torch_train.py's): the loss within rtol
    1e-6, each gradient leaf within 1e-5 of its largest |g|, each weight
    within 2 · lr of the other run's."""
    assert got.grads_metrics["loss"] == pytest.approx(
        want.grads_metrics["loss"], rel=1e-6)
    for k, g in want.grads.items():
        top = float(g.abs().max())
        assert float((got.grads[k] - g).abs().max()) <= 1e-5 * top, k
    lr = want.metrics[0]["lr"]
    for k, w in want.params.items():
        assert float((got.params[k] - w).abs().max()) <= 2 * lr, k


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_lm_mesh_gloo_on_card_matches_the_cpu_grid(cuda, shape):
    """The autograd collectives (the FSDP gather and its reduce-scatter
    over 'data'; the tensor-parallel pair, the vocab-parallel embedding
    and softmax over 'model') under gloo ×2 on one card, through host
    buffers, against the same grid on the CPU, float32."""
    from repro_torch.launch.lm_mesh import run_train_mesh
    from repro_torch.launch.mesh import visible_gpus

    cfg, params, batch = _lm_mesh_case(torch.float32)
    kw = dict(keep=("params", "grads"), timeout=300)
    cpu = run_train_mesh(cfg, params, None, batch, shape, device="cpu", **kw)
    card = run_train_mesh(cfg, params, None, batch, shape, device="cuda",
                          backend="gloo", gpus=visible_gpus()[:1], **kw)
    _lm_mesh_close(card, cpu)
    assert all(r["bytes"]["staged"] > 0 for r in card.ranks)
    assert all(r["bytes"]["staged"] == 0 for r in cpu.ranks)


def test_lm_mesh_kinds_gloo_on_card_match_the_cpu_grid(cuda):
    """The other layer kinds at (2, 4) under gloo ×8 on one card against
    the same grid on the CPU, float32: reduced deepseek-v2-lite (MLA, the
    experts over 'model' with the global capacity at a capacity factor of
    1.0, which drops copies; shared experts) and mamba2 (SSM heads, whole
    ``in_proj`` gathered over 'model'). Each MoE layer's dropped copies
    equal the CPU grid's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch.lm_mesh import TrainCase, run_train_mesh_cases
    from repro_torch.launch.mesh import visible_gpus
    from repro_torch.models.transformer import param_dtype, param_shapes

    cases = []
    for arch in ("deepseek-v2-lite-16b", "mamba2-2.7b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype=torch.float32, capacity_factor=1.0)
        rng = np.random.default_rng(0)
        params = {k: torch.from_numpy((rng.standard_normal(s) * 0.02).astype(
            np.float32)).to(param_dtype(cfg, k))
            for k, s in param_shapes(cfg).items()}
        cases.append(TrainCase(cfg, params, synthetic_batch(
            cfg, 0, 32, 8, device="cpu"), keep=("params", "grads")))
    cpu = run_train_mesh_cases(cases, (2, 4), device="cpu", timeout=300)
    card = run_train_mesh_cases(cases, (2, 4), device="cuda",
                                backend="gloo", gpus=visible_gpus()[:1],
                                timeout=300)
    for got, want in zip(card.results, cpu.results):
        _lm_mesh_close(got, want)
        assert got.metrics[0].get("dropped") == want.metrics[0].get(
            "dropped")
        assert all(r["bytes"]["staged"] > 0 for r in got.ranks)
    assert sum(card.results[0].metrics[0]["dropped"]) > 0


def test_lm_mesh_nccl_one_rank_equals_one_process(cuda):
    """run_train_mesh under NCCL at (1, 1), bf16: the one-process step on
    the card, bit for bit (a one-rank grid runs its arithmetic)."""
    from repro_torch.launch.lm_mesh import run_train_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.training.train import init_train_state, make_train_step

    cfg, params, batch = _lm_mesh_case(torch.bfloat16)
    model = Transformer(cfg, {k: v.cuda() for k, v in params.items()})
    model, _, m = make_train_step(cfg, _adamw())(
        model, init_train_state(cfg, model),
        {k: v.cuda() for k, v in batch.items()})
    res = run_train_mesh(cfg, params, None, batch, (1, 1), device="cuda",
                         backend="nccl", opt_cfg=_adamw(), keep=("params",),
                         timeout=300)
    assert res.metrics[0]["loss"] == float(m["loss"])
    for k, p in model.named_parameters():
        assert torch.equal(res.params[k], p.cpu()), k


def test_lm_mesh_nccl_two_ranks(cuda):
    """NCCL with one rank a GPU at (1, 2) against the CPU grid's float32
    step (it needs two GPUs)."""
    from repro_torch.launch.lm_mesh import run_train_mesh
    from repro_torch.launch.mesh import visible_gpus

    gpus = visible_gpus()
    if len(gpus) < 2:
        pytest.skip(f"NCCL runs one rank a GPU, and this machine shows "
                    f"{len(gpus)} GPU: (1, 2) needs two")
    cfg, params, batch = _lm_mesh_case(torch.float32)
    kw = dict(keep=("params", "grads"), timeout=300)
    cpu = run_train_mesh(cfg, params, None, batch, (1, 2), device="cpu", **kw)
    card = run_train_mesh(cfg, params, None, batch, (1, 2), device="cuda",
                          backend="nccl", gpus=gpus[:2], **kw)
    _lm_mesh_close(card, cpu)
    assert all(r["bytes"]["staged"] == 0 for r in card.ranks)


def _adamw():
    from repro_torch.training.optimizer import AdamWConfig

    return AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=30)
