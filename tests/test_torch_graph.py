"""The port's graph substrate against the JAX package's: the same seeds give
the same graphs, recodings and partitions, array for array; the port imports
neither jax nor repro; its entry points run on CUDA unless told otherwise."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.graph as rg
import repro_torch.graph as tg
from repro.graph.partition import block_ranges as ref_block_ranges
from repro_torch import convert
from repro_torch.graph.partition import PartitionedGraph

# the shapes here are tiny: one intra-op thread keeps torch's idle
# OpenMP workers from competing with the other test processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

GENERATORS = [
    ("rmat", dict(scale=7, edge_factor=8, seed=3)),
    ("rmat", dict(scale=9, edge_factor=16, seed=0, weights="uniform")),
    ("rmat", dict(scale=8, seed=5, sparse_ids=True)),
    ("rmat", dict(scale=8, seed=2, directed=False, weights="uniform")),
    ("rmat", dict(scale=17, edge_factor=16, seed=1, weights="uniform")),
    ("erdos_renyi", dict(n=300, avg_degree=6.0, seed=4)),
    ("erdos_renyi", dict(n=200, avg_degree=3.0, seed=9, directed=False)),
    ("chain", dict(n=50)),
    ("star", dict(n=40)),
]


def _pair(kind, kw):
    name = f"{kind}_graph"
    return getattr(rg, name)(**kw), getattr(tg, name)(**kw)


@pytest.mark.parametrize("kind,kw", GENERATORS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(GENERATORS)])
def test_generators_identical(kind, kw):
    a, b = _pair(kind, kw)
    for f in ("src", "dst", "weight", "vertex_ids"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.directed == b.directed


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("sparse", [False, True])
def test_recode_identical(n, sparse):
    a, b = _pair("rmat", dict(scale=8, seed=6, sparse_ids=sparse))
    ra, rb = rg.recode_ids(a.vertex_ids, n), tg.recode_ids(b.vertex_ids, n)
    assert ra.max_positions == rb.max_positions
    for f in ("old_sorted", "new_for_old_sorted", "old_for_new"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    np.testing.assert_array_equal(ra.to_new(a.src), rb.to_new(b.src))
    np.testing.assert_array_equal(ra.to_old(ra.to_new(a.dst)),
                                  rb.to_old(rb.to_new(b.dst)))


def test_recode_unknown_id_raises():
    rmap = tg.recode_ids(np.arange(10), 2)
    with pytest.raises(KeyError):
        rmap.to_new(np.array([10]))
    with pytest.raises(KeyError):
        tg.recode_ids(np.array([3, 7, 9]), 2).to_new(np.array([4]))


def _assert_partitions_equal(ref, port: PartitionedGraph):
    for f in convert.STATIC:
        assert getattr(ref, f) == getattr(port, f), f
    for f in PartitionedGraph.TENSORS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(port, f).numpy(), err_msg=f)


@pytest.mark.parametrize("n", [1, 2, 4, 7])
@pytest.mark.parametrize("graph", [
    ("rmat", dict(scale=8, edge_factor=8, seed=3, weights="uniform")),
    ("rmat", dict(scale=7, seed=11, sparse_ids=True)),
    ("chain", dict(n=64)),
], ids=["rmat", "rmat-sparse-ids", "chain"])
def test_partition_identical(n, graph):
    a, b = _pair(*graph)
    ref, _ = rg.partition_graph(a, n_shards=n, edge_block=32, vertex_pad=8)
    port, _ = tg.partition_graph(b, n_shards=n, edge_block=32, vertex_pad=8,
                                 device="cpu")
    _assert_partitions_equal(ref, port)
    assert port.device == torch.device("cpu")


def test_block_ranges_identical():
    rng = np.random.default_rng(0)
    sp = rng.integers(-1, 50, size=(3, 3, 6, 16)).astype(np.int32)
    sp[0, 1, 2] = -1  # an empty block
    for a, b in zip(ref_block_ranges(sp, 50), tg.block_ranges(sp, 50)):
        np.testing.assert_array_equal(a, b)


def test_drop_edges_keeps_vertices():
    g = tg.rmat_graph(scale=6, seed=1)
    pg, _ = tg.partition_graph(g, 3, edge_block=16, device="cpu")
    v = tg.drop_edges(pg)
    assert v.src_pos.shape == (3, 3, 0) and v.blk_hi.shape == (3, 3, 0)
    assert torch.equal(v.degree, pg.degree) and v.E_cap == pg.E_cap


def test_convert_round_trip():
    g = rg.rmat_graph(scale=7, seed=4, weights="uniform")
    ref, _ = rg.partition_graph(g, n_shards=3, edge_block=32)
    arrays = {f: np.asarray(getattr(ref, f)) for f in PartitionedGraph.TENSORS}
    static = {f: getattr(ref, f) for f in convert.STATIC}
    port = convert.partition_from_arrays(arrays, static, device="cpu")
    _assert_partitions_equal(ref, port)
    assert port.old_ids.dtype == torch.int64
    values, active = convert.state_from_arrays(
        np.arange(6, dtype=np.int32).reshape(2, 3),
        np.array([[1, 0, 1], [0, 0, 1]]), device="cpu")
    assert values.dtype == torch.int32 and active.dtype == torch.bool
    assert active.tolist() == [[True, False, True], [False, False, True]]


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, device=None raises; device='cpu' runs."""
    from repro_torch.core import GraphDEngine, PageRank

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tg.rmat_graph(scale=5, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.partition_graph(g, 2)
    pg, _ = tg.partition_graph(g, 2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphDEngine(pg, PageRank(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_arrays(np.zeros((2, 2)), np.zeros((2, 2)))
    GraphDEngine(pg, PageRank(2), device="cpu").run()


def _port_modules():
    mods = []
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), os.path.dirname(PORT))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__")
                            else mod)
    return sorted(mods)


def test_port_imports_neither_jax_nor_repro():
    """Import every module of the port in a fresh interpreter; neither jax
    nor the JAX package may be loaded by it, directly or transitively."""
    mods = _port_modules()
    assert "repro_torch.core.engine" in mods and "repro_torch.kernels.digest" in mods
    assert {"repro_torch.examples.quickstart",
            "repro_torch.examples.graph_analytics"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro\.|"
                     r"from\s+repro\s+import|import\s+repro\b(?!_))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(PORT):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as fh:
            hits += [f"{path}: {m.group(0).strip()}"
                     for m in pat.finditer(fh.read())]
    assert not hits, hits
