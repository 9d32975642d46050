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
from repro_torch.graph import partition_graph, rmat_graph
from repro_torch.kernels import ops
from repro_torch.kernels.digest import digest, digest_plain
from repro_torch.kernels.edge_combine import (
    COMBINERS, edge_combine, edge_combine_plain,
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
