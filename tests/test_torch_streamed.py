"""The port's out-of-core ``streamed`` mode against the JAX package's, on
the CPU: the twin of tests/test_equivalence.py's matrix (8 algorithms x the
6 streamed variants, then the semi-external cache budgets). Each port run is
held against the JAX package's run of the same variant and against the
port's own in-memory ``basic`` run: integer, MIN and MAX programs exactly
(values, active bitmaps, message counts, halt step); PageRank within 1e-6
(tests/test_engine.py:99, the reference's cross-mode bar)."""

import os

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.graph import partition_graph_streamed as ref_streamed
from repro.graph import rmat_graph as ref_rmat
from repro_torch.graph import (
    partition_graph, partition_graph_streamed, rmat_graph,
)

# the shapes here are tiny: one intra-op thread keeps torch's idle
# OpenMP workers from competing with the other test processes
torch.set_num_threads(1)

EDGE_BLOCK = 32
N_SHARDS = 3
PAGERANK_TOL = 1e-6  # tests/test_engine.py:99, across modes


def _src(g, rmap):
    return int(rmap.to_new(np.array([int(g.vertex_ids[0])]))[0])


#: name -> (reference factory, port factory); each takes (g, rmap)
ALGORITHMS = {
    "pagerank": (lambda g, r: rc.PageRank(supersteps=5),
                 lambda g, r: tc.PageRank(supersteps=5)),
    "hashmin": (lambda g, r: rc.HashMin(), lambda g, r: tc.HashMin()),
    "sssp": (lambda g, r: rc.SSSP(_src(g, r)),
             lambda g, r: tc.SSSP(_src(g, r))),
    "bfs": (lambda g, r: rc.BFS(_src(g, r)), lambda g, r: tc.BFS(_src(g, r))),
    "degreesum": (lambda g, r: rc.DegreeSum(), lambda g, r: tc.DegreeSum()),
    "labelspread": (lambda g, r: rc.LabelSpread(),
                    lambda g, r: tc.LabelSpread()),
    "distinct": (lambda g, r: rc.DistinctInLabels(n_groups=8, rounds=2),
                 lambda g, r: tc.DistinctInLabels(n_groups=8, rounds=2)),
    "secondmin": (lambda g, r: rc.SecondMinLabel(),
                  lambda g, r: tc.SecondMinLabel()),
}

#: tests/test_equivalence.py's STREAMED_VARIANTS
STREAMED_VARIANTS = {
    "streamed": dict(),
    "pipelined": dict(pipeline=True, full_duplex=False),
    "full-duplex": dict(pipeline=True),
    "pipelined-compressed": dict(pipeline=True, compress=True),
    "payload-compressed": dict(pipeline=True, compress=True,
                               compress_payload=True),
    "payload-auto": dict(pipeline=True, compress=True,
                         compress_payload="auto"),
}
SEMI_EXTERNAL_BUDGET_BLOCKS = (0, 2, None)  # None -> whole graph / n_shards


def _config(pkg, cache_bytes=0, **channel):
    return pkg.EngineConfig(
        mode="streamed",
        stream=pkg.StreamConfig(chunk_blocks=2, cache_bytes=cache_bytes),
        channel=pkg.ChannelConfig(**channel),
    )


def _store_kind(kwargs):
    if kwargs.get("compress_payload"):
        return 2
    return 1 if kwargs.get("compress") else 0


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """One RMAT graph, partitioned and spilled by each package in the three
    store flavours (plain, position-compressed, fully compressed)."""
    d = str(tmp_path_factory.mktemp("streamed"))
    g_ref = ref_rmat(scale=6, edge_factor=6, seed=5, weights="uniform")
    g = rmat_graph(scale=6, edge_factor=6, seed=5, weights="uniform")
    flavours = [dict(), dict(compress=True),
                dict(compress=True, compress_payload=True)]
    ref_stores, port_stores = [], []
    for j, kw in enumerate(flavours):
        pgs_ref, rmap, st = ref_streamed(
            g_ref, N_SHARDS, os.path.join(d, f"ref{j}"),
            edge_block=EDGE_BLOCK, **kw)
        ref_stores.append(st)
        pgs, _, st = partition_graph_streamed(
            g, N_SHARDS, os.path.join(d, f"port{j}"), edge_block=EDGE_BLOCK,
            device="cpu", **kw)
        port_stores.append(st)
    pg, _ = partition_graph(g, N_SHARDS, edge_block=EDGE_BLOCK, device="cpu")
    return dict(g=g, rmap=rmap, pgs_ref=pgs_ref, pgs=pgs, pg=pg,
                ref_stores=ref_stores, port_stores=port_stores, cache={})


def _summary(values, active, hist):
    return (np.asarray(values), np.asarray(active), len(hist),
            [r.n_active for r in hist], [r.n_msgs for r in hist])


def _run_ref(graphs, name, kwargs, cache_bytes=0):
    key = ("ref", name, tuple(sorted(kwargs.items())), cache_bytes)
    if key not in graphs["cache"]:
        prog = ALGORITHMS[name][0](graphs["g"], graphs["rmap"])
        eng = rc.GraphDEngine(
            graphs["pgs_ref"], prog, config=_config(rc, cache_bytes, **kwargs),
            stream_store=graphs["ref_stores"][_store_kind(kwargs)])
        (v, a), hist = eng.run(max_supersteps=60)
        graphs["cache"][key] = _summary(v, a, hist)
    return graphs["cache"][key]


def _run_port(graphs, name, kwargs, cache_bytes=0):
    prog = ALGORITHMS[name][1](graphs["g"], graphs["rmap"])
    eng = tc.GraphDEngine(
        graphs["pgs"], prog, _config(tc, cache_bytes, **kwargs),
        device="cpu", stream_store=graphs["port_stores"][_store_kind(kwargs)])
    (v, a), hist = eng.run(max_supersteps=60)
    return _summary(v.numpy(), a.numpy(), hist), hist


def _run_basic(graphs, name):
    key = ("basic", name)
    if key not in graphs["cache"]:
        prog = ALGORITHMS[name][1](graphs["g"], graphs["rmap"])
        eng = tc.GraphDEngine(graphs["pg"], prog,
                              tc.EngineConfig(mode="basic"), device="cpu")
        (v, a), hist = eng.run(max_supersteps=60)
        graphs["cache"][key] = _summary(v.numpy(), a.numpy(), hist)
    return graphs["cache"][key]


def _assert_same(got, want, name, what):
    v, a, steps, act, msgs = got
    rv, ra, rsteps, ract, rmsgs = want
    assert steps == rsteps, (name, what, "halt step")
    assert act == ract, (name, what, "active trajectory")
    assert msgs == rmsgs, (name, what, "message counts")
    assert np.array_equal(a, ra), (name, what, "active bitmap")
    if name == "pagerank":
        assert np.abs(v - rv).max() < PAGERANK_TOL, (name, what, "values")
    else:
        assert np.array_equal(v, rv), (name, what, "values")


@pytest.mark.parametrize("variant", list(STREAMED_VARIANTS))
@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_matrix_streamed_variant_matches_reference(graphs, name, variant):
    kwargs = STREAMED_VARIANTS[variant]
    got, _ = _run_port(graphs, name, kwargs)
    _assert_same(got, _run_ref(graphs, name, kwargs), name,
                 f"{variant} vs the JAX package")
    _assert_same(got, _run_basic(graphs, name), name,
                 f"{variant} vs the port's basic run")


@pytest.mark.parametrize("blocks", SEMI_EXTERNAL_BUDGET_BLOCKS,
                         ids=["budget0", "budget2", "fits"])
@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_matrix_semi_external_matches_reference(graphs, name, blocks):
    """A hot-block cache budget changes only WHERE a block is read from:
    the results equal the JAX package's run at the same budget and the
    port's uncached run, and the residency counters are the JAX
    package's."""
    store = graphs["port_stores"][0]
    if blocks is None:  # the engine caps capacity at cache * n_shards
        cache = -(-store.nonempty_blocks() * store.block_bytes() // N_SHARDS)
    else:
        cache = blocks * store.block_bytes()
    got, hist = _run_port(graphs, name, {}, cache)
    _assert_same(got, _run_ref(graphs, name, {}, cache), name,
                 f"cache {cache} vs the JAX package")
    plain, _ = _run_port(graphs, name, {})
    v, a, *rest = got
    assert np.array_equal(v, plain[0]) and rest == list(plain[2:]), (
        name, cache, "cached vs uncached")
    if blocks == 0:
        assert sum(r.cache_hits for r in hist) == 0
    if blocks is None:
        assert sum(r.blocks_read for r in hist) <= store.nonempty_blocks()


def test_residency_counters_match_reference(graphs):
    """blocks_read, cache_hits, cache_evictions and blocks_skipped of every
    superstep equal the JAX package's at an eviction-churning budget."""
    store = graphs["ref_stores"][0]
    cache = 2 * store.block_bytes()
    fields = ("blocks_read", "cache_hits", "cache_evictions",
              "blocks_skipped", "n_active", "n_msgs")
    prog = ALGORITHMS["sssp"][0](graphs["g"], graphs["rmap"])
    _, want = rc.GraphDEngine(graphs["pgs_ref"], prog,
                              config=_config(rc, cache),
                              stream_store=store).run()
    _, got = _run_port(graphs, "sssp", {}, cache)
    assert ([[getattr(r, f) for f in fields] for r in got]
            == [[getattr(r, f) for f in fields] for r in want])


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_stream_kernels_init_matches_init_spmd(graphs, name):
    """StreamKernels.init (one shard's row, as a worker process builds it)
    equals the engine's init over all shards."""
    from repro_torch.core.engine import init_spmd

    pgs = graphs["pgs"]
    prog = ALGORITHMS[name][1](graphs["g"], graphs["rmap"])
    kern = tc.StreamKernels(prog, pgs.n_shards, pgs.n_vertices, pgs.P)
    v, a = init_spmd(prog, pgs)
    for i in range(pgs.n_shards):
        vi, ai = kern.init(i, pgs.degree[i], pgs.vmask[i], pgs.old_ids[i],
                           pgs.gids[i])
        assert torch.equal(vi, v[i]) and torch.equal(ai, a[i])


def test_streamed_engine_refuses_what_it_cannot_run(graphs, tmp_path):
    """The JAX package's error paths: no store, a plain MessageLog, a store
    of another geometry, a vertex-only partition in an in-memory mode, a
    lossy wire codec for int messages or behind a log."""
    pgs, store = graphs["pgs"], graphs["port_stores"][0]
    cfg = tc.EngineConfig(mode="streamed")
    with pytest.raises(ValueError, match="needs stream_store"):
        tc.GraphDEngine(pgs, tc.HashMin(), cfg, device="cpu")
    with pytest.raises(ValueError, match="RunFileMessageLog"):
        tc.GraphDEngine(pgs, tc.HashMin(), cfg, device="cpu",
                        stream_store=store,
                        message_log=tc.MessageLog(str(tmp_path / "l")))
    _, _, two_shards = partition_graph_streamed(
        graphs["g"], 2, str(tmp_path / "two"), edge_block=EDGE_BLOCK,
        device="cpu")
    with pytest.raises(ValueError, match="geometry does not match"):
        tc.GraphDEngine(pgs, tc.HashMin(), cfg, device="cpu",
                        stream_store=two_shards)
    with pytest.raises(ValueError, match="vertex-only"):
        tc.GraphDEngine(pgs, tc.HashMin(), device="cpu")
    with pytest.raises(ValueError, match="lossless scheme"):
        tc.GraphDEngine(pgs, tc.HashMin(), _config(
            tc, pipeline=True, compress_payload="bf16"), device="cpu",
            stream_store=store)
    with pytest.raises(ValueError, match="message log"):
        tc.GraphDEngine(pgs, tc.PageRank(2), _config(
            tc, pipeline=True, compress_payload="bf16"), device="cpu",
            stream_store=store,
            message_log=tc.RunFileMessageLog(str(tmp_path / "rl")))
