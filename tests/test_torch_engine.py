"""The port's recoded superstep engine against the JAX package's, on the CPU:
the same inputs through both, superstep by superstep."""

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.graph import chain_graph, partition_graph, rmat_graph
from repro_torch import convert
from repro_torch.graph.partition import PartitionedGraph

# the shapes here are tiny: one intra-op thread keeps torch's idle
# OpenMP workers from competing with the other test processes
torch.set_num_threads(1)

BACKENDS = ["torch", "kernel"]


def _graph(scale=8, seed=3, ef=8):
    return rmat_graph(scale=scale, edge_factor=ef, seed=seed, weights="uniform")


def _port_pg(pg):
    """The JAX package's partition, carried across to the port."""
    arrays = {f: np.asarray(getattr(pg, f)) for f in PartitionedGraph.TENSORS}
    static = {f: getattr(pg, f) for f in convert.STATIC}
    return convert.partition_from_arrays(arrays, static, device="cpu")


def _run_ref(pg, prog, **cfg):
    eng = rc.GraphDEngine(pg, prog, config=rc.EngineConfig(**cfg))
    (v, a), hist = eng.run()
    return eng, np.asarray(v), np.asarray(a), hist


def _run_port(tpg, prog, backend, **cfg):
    eng = tc.GraphDEngine(tpg, prog, tc.EngineConfig(backend=backend, **cfg),
                          device="cpu")
    (v, a), hist = eng.run()
    return eng, v.numpy(), a.numpy(), hist


def _steps(hist):
    return [(h.n_active, h.n_msgs) for h in hist]


# --------------------------------------------------------------------------
# PageRank: float SUM, held to the reference's own slack
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_pagerank_matches_reference(n):
    pg, _ = partition_graph(_graph(), n_shards=n, edge_block=32)
    tpg = _port_pg(pg)
    _, v_ref, a_ref, h_ref = _run_ref(pg, rc.PageRank(10))
    out = {}
    for be in BACKENDS:
        _, v, a, hist = _run_port(tpg, tc.PageRank(10), be)
        assert np.abs(v.astype(np.float64) - v_ref).max() < 1e-5
        np.testing.assert_array_equal(a, a_ref)
        assert _steps(hist) == _steps(h_ref) and len(hist) == 10
        np.testing.assert_allclose([h.agg for h in hist],
                                   [h.agg for h in h_ref], rtol=1e-5)
        out[be] = v
    assert np.abs(out["torch"].astype(np.float64) - out["kernel"]).max() < 1e-6


def test_pagerank_matches_pallas_backend():
    pg, _ = partition_graph(_graph(scale=7), n_shards=4, edge_block=64,
                            vertex_pad=32)
    _, v_pal, _, _ = _run_ref(pg, rc.PageRank(10), backend="pallas",
                              kernel_windows=32)
    for be in BACKENDS:
        _, v, _, _ = _run_port(_port_pg(pg), tc.PageRank(10), be)
        assert np.abs(v.astype(np.float64) - v_pal).max() < 1e-5


# --------------------------------------------------------------------------
# integer, MIN and MAX programs: exact, superstep by superstep
# --------------------------------------------------------------------------

def _source(rmap, g):
    return int(rmap.to_new(np.array([int(g.vertex_ids[0])]))[0])


PROGRAMS = {
    "hashmin": (lambda s: rc.HashMin(), lambda s: tc.HashMin()),
    "sssp": (lambda s: rc.SSSP(s), lambda s: tc.SSSP(s)),
    "bfs": (lambda s: rc.BFS(s), lambda s: tc.BFS(s)),
    "degreesum": (lambda s: rc.DegreeSum(), lambda s: tc.DegreeSum()),
    "labelspread": (lambda s: rc.LabelSpread(), lambda s: tc.LabelSpread()),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [1, 4, 7])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_exact_programs_match_reference(name, n, backend):
    g = _graph(scale=8, seed=13, ef=4)  # ef 4 leaves unreached vertices
    pg, rmap = partition_graph(g, n_shards=n, edge_block=32)
    ref_prog, port_prog = PROGRAMS[name]
    src = _source(rmap, g)
    ref_eng, v_ref, a_ref, h_ref = _run_ref(pg, ref_prog(src))
    eng, v, a, hist = _run_port(_port_pg(pg), port_prog(src), backend)
    assert v.dtype == v_ref.dtype
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(a, a_ref)
    assert _steps(hist) == _steps(h_ref)
    assert eng.gather_values(torch.from_numpy(v)) == \
        ref_eng.gather_values(v_ref)
    if name in ("sssp", "bfs"):
        real = np.asarray(pg.vmask)
        assert np.isinf(v[real]).any()  # unreached stay inf, not 1e30


def test_port_partition_runs_like_carried_partition():
    """The port's own partition_graph and a carried-across one give the
    same run (the graph tests pin the arrays; this pins the pipeline)."""
    import repro_torch.graph as tg

    g_ref, g_port = _graph(seed=21), tg.rmat_graph(
        scale=8, edge_factor=8, seed=21, weights="uniform")
    pg, rmap = partition_graph(g_ref, n_shards=3, edge_block=32)
    tpg, trmap = tg.partition_graph(g_port, 3, edge_block=32, device="cpu")
    src = _source(rmap, g_ref)
    assert src == _source(trmap, g_port)
    runs = [_run_port(p, tc.SSSP(src), "kernel") for p in (tpg, _port_pg(pg))]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert _steps(runs[0][3]) == _steps(runs[1][3])


def test_hashmin_matches_pallas_backend():
    pg, _ = partition_graph(_graph(scale=7), n_shards=4, edge_block=64,
                            vertex_pad=32)
    _, v_pal, _, h_pal = _run_ref(pg, rc.HashMin(), backend="pallas",
                                  kernel_windows=32)
    _, v, _, hist = _run_port(_port_pg(pg), tc.HashMin(), "kernel")
    np.testing.assert_array_equal(v, v_pal)
    assert _steps(hist) == _steps(h_pal)


# --------------------------------------------------------------------------
# sparse dispatch and the halt step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_dispatch_on_chain(backend):
    """A chain keeps one vertex active: after the first superstep the
    frontier density drops under adapt_threshold and the run dispatches
    sparse; results and halt step stay the reference's."""
    g = chain_graph(200)
    pg, rmap = partition_graph(g, n_shards=4, edge_block=8)
    src = _source(rmap, g)
    _, v_ref, a_ref, h_ref = _run_ref(pg, rc.SSSP(src))
    _, v, a, hist = _run_port(_port_pg(pg), tc.SSSP(src), backend)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(a, a_ref)
    assert _steps(hist) == _steps(h_ref)
    assert [h.mode for h in hist] == [h.mode for h in h_ref]
    assert "sparse" in [h.mode for h in hist]
    assert len(hist) == len(h_ref) == 200


def test_sparse_and_dense_steps_agree():
    """With room for every block (sparse_cap_frac=1), the sparse gather
    equals the dense scan at any frontier."""
    g = _graph(scale=8, seed=5)
    pg, rmap = partition_graph(g, n_shards=4, edge_block=16)
    tpg = _port_pg(pg)
    eng = tc.GraphDEngine(tpg, tc.BFS(_source(rmap, g)),
                          tc.EngineConfig(backend="torch", sparse_cap_frac=1.0),
                          device="cpu")
    v, a = eng.init()
    for s in range(3):
        dense = eng.step(v, a, s, sparse=False)
        sparse = eng.step(v, a, s, sparse=True)
        assert torch.equal(dense[0], sparse[0])
        assert torch.equal(dense[1], sparse[1])
        v, a = dense[0], dense[1]


def test_run_respects_max_supersteps_and_state():
    pg, _ = partition_graph(_graph(), n_shards=2, edge_block=32)
    tpg = _port_pg(pg)
    eng = tc.GraphDEngine(tpg, tc.HashMin(), device="cpu")
    (v2, a2), hist = eng.run(max_supersteps=2)
    assert len(hist) == 2
    (v, _), rest = eng.run(state=(v2, a2), start_step=2)
    (v_all, _), full = eng.run()
    assert torch.equal(v, v_all)
    assert [h.step for h in rest] == [h.step for h in full[2:]]


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

@pytest.mark.parametrize("launch,slice_", [("processes", "slice 4")])
def test_later_modes_name_their_slice(launch, slice_):
    """The streamed mode, which slice 3 ported, finalizes to the torch
    backend; the multi-process launch over the socket transport, which
    slice 4 ported (4a the file transport, 4b the sockets), builds its
    processes job with the options as given."""
    cfg = tc.EngineConfig(mode="streamed").finalize()
    assert (cfg.mode, cfg.backend) == ("streamed", "torch")
    with pytest.raises(tc.ConfigError, match="needs mode='recoded'"):
        tc.EngineConfig(mode="streamed", backend="kernel").finalize()
    with tc.GraphDJob(tc.PageRank(2), _graph(scale=5), launch=launch,
                      launch_opts={"transport": "sockets"},
                      device="cpu") as job:
        assert job.launch == launch == "processes"
        assert job.launch_opts == {"transport": "sockets"}
        assert job.plan.mode == "streamed" and job.plan.launch == launch


def test_slice2_modes_finalize_and_run():
    """The three modes that slice 2 ported finalize to the torch backend
    and run PageRank to the recoded run's result."""
    pg, _ = partition_graph(_graph(scale=6), n_shards=3, edge_block=32)
    tpg = _port_pg(pg)
    _, v_rec, _, _ = _run_port(tpg, tc.PageRank(4), None)
    for mode in ("basic", "basic_sc", "recoded_compact"):
        cfg = tc.EngineConfig(mode=mode).finalize()
        assert (cfg.mode, cfg.backend) == (mode, "torch")
        _, v, _, hist = _run_port(tpg, tc.PageRank(4), None, mode=mode)
        assert len(hist) == 4
        assert np.abs(v - v_rec).max() <= 2e-2 * np.abs(v_rec).max()


@pytest.mark.parametrize("bad", [dict(mode="nope"), dict(backend="pallas"),
                                 dict(sparse_cap_frac=0.0),
                                 dict(adapt_threshold=1.5)])
def test_config_rejects(bad):
    with pytest.raises(tc.ConfigError):
        tc.EngineConfig(**bad).finalize()


def test_engine_rejects_programs_it_cannot_run():
    pg, _ = partition_graph(_graph(scale=6), n_shards=2, edge_block=32)
    tpg = _port_pg(pg)

    class NoKind(tc.PageRank):
        msg_kind = None

    class NoCombiner(tc.PageRank):
        combiner = None

    # by default a program the kernels cannot compute runs on the torch
    # backend; asked for the kernels, it is refused at construction
    assert tc.GraphDEngine(tpg, NoKind(), device="cpu").backend == "torch"
    with pytest.raises(ValueError, match="msg_kind"):
        tc.GraphDEngine(tpg, NoKind(), tc.EngineConfig(backend="kernel"),
                        device="cpu")
    tc.GraphDEngine(tpg, NoKind(), tc.EngineConfig(backend="torch"),
                    device="cpu")
    with pytest.raises(ValueError, match="combiner"):
        tc.GraphDEngine(tpg, NoCombiner(), device="cpu")


@pytest.mark.parametrize("name", ["SUM", "MIN", "MAX", "IMIN", "IMAX"])
def test_combiner_matches_reference(name):
    """identity/scatter/combine/reduce of each combiner, on the same data."""
    import jax.numpy as jnp
    from repro.core import api as ref_api

    ref, port = getattr(ref_api, name), getattr(tc, name)
    is_int = name.startswith("I")
    rng = np.random.default_rng(len(name))
    msgs = (rng.integers(-1000, 1000, 50).astype(np.int32) if is_int
            else rng.standard_normal(50).astype(np.float32))
    idx = rng.integers(0, 8, 50)
    dt_np = np.int32 if is_int else np.float32
    dt_t = torch.int32 if is_int else torch.float32
    want = ref.scatter(ref.identity((8,), dt_np), jnp.asarray(idx),
                       jnp.asarray(msgs))
    got = port.scatter(port.identity((8,), dt_t, "cpu"),
                       torch.from_numpy(idx), torch.from_numpy(msgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    stack = msgs.reshape(5, 10)
    np.testing.assert_allclose(port.reduce(torch.from_numpy(stack), 0).numpy(),
                               np.asarray(ref.reduce(jnp.asarray(stack), 0)),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        port.combine(torch.from_numpy(stack[0]), torch.from_numpy(stack[1])).numpy(),
        np.asarray(ref.combine(jnp.asarray(stack[0]), jnp.asarray(stack[1]))))
