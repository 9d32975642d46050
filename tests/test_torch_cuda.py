"""The port's kernels on the card against their plain versions, and the
engine's kernel backend against its torch backend on the card.

These tests need a CUDA device and skip without one. They import neither
jax nor the JAX package, so they run on the GPU machine as they are:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    BFS, SSSP, EngineConfig, GraphDEngine, HashMin, LabelSpread, PageRank,
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
