"""The port's in-memory modes against the JAX package's, on the CPU: recoded,
basic (with and without a combiner), basic_sc, recoded_compact and the
logged step, the segment helpers of the message-list path, the flat skip()
prefix, and the config's rejections."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as rc
import repro_torch.core as tc
from repro.core import api as ref_api
from repro.core.checkpoint import MessageLog as RefMessageLog
from repro.core.engine import _active_prefix as ref_prefix
from repro.core.engine import _block_active as ref_block_active
from repro.graph import partition_graph, rmat_graph
from repro_torch import convert
from repro_torch.core.engine import _active_prefix, _block_active
from repro_torch.graph import Graph
from repro_torch.graph import partition_graph as port_partition_graph
from repro_torch.graph.partition import PartitionedGraph, drop_edges
from repro_torch.kernels import ops

# the shapes here are tiny: one intra-op thread keeps torch's idle
# OpenMP workers from competing with the other test processes
torch.set_num_threads(1)

MODES = ["recoded", "basic", "basic_sc", "recoded_compact", "logged"]
PAGERANK_TOL = 1e-6  # tests/test_engine.py:99, across modes
COMPACT_RTOL = 2e-2  # tests/test_engine.py:238, one bf16 rounding a message


def _graph(scale=7, seed=13, ef=6):
    return rmat_graph(scale=scale, edge_factor=ef, seed=seed, weights="uniform")


def _port_pg(pg):
    arrays = {f: np.asarray(getattr(pg, f)) for f in PartitionedGraph.TENSORS}
    static = {f: getattr(pg, f) for f in convert.STATIC}
    return convert.partition_from_arrays(arrays, static, device="cpu")


def _source(rmap, g):
    return int(rmap.to_new(np.array([int(g.vertex_ids[0])]))[0])


#: name -> (reference factory, port factory, modes that accept it)
FLOAT_MODES = tuple(MODES)
INT_MODES = ("recoded", "basic", "basic_sc", "logged")
PROGRAMS = {
    "pagerank": (lambda s: rc.PageRank(6), lambda s: tc.PageRank(6),
                 FLOAT_MODES),
    "hashmin": (lambda s: rc.HashMin(), lambda s: tc.HashMin(), INT_MODES),
    "sssp": (lambda s: rc.SSSP(s), lambda s: tc.SSSP(s), FLOAT_MODES),
    "bfs": (lambda s: rc.BFS(s), lambda s: tc.BFS(s), FLOAT_MODES),
    "degreesum": (lambda s: rc.DegreeSum(), lambda s: tc.DegreeSum(),
                  FLOAT_MODES),
    "labelspread": (lambda s: rc.LabelSpread(), lambda s: tc.LabelSpread(),
                    INT_MODES),
    "distinct": (lambda s: rc.DistinctInLabels(n_groups=8, rounds=2),
                 lambda s: tc.DistinctInLabels(n_groups=8, rounds=2),
                 ("basic",)),
    "secondmin": (lambda s: rc.SecondMinLabel(), lambda s: tc.SecondMinLabel(),
                  ("basic",)),
}
CASES = [(name, mode) for name, (_, _, modes) in PROGRAMS.items()
         for mode in modes]


def _run_ref(pg, prog, mode, log_dir=None):
    if mode == "logged":
        eng = rc.GraphDEngine(pg, prog, message_log=RefMessageLog(log_dir))
    else:
        eng = rc.GraphDEngine(pg, prog, config=rc.EngineConfig(mode=mode))
    (v, a), hist = eng.run()
    return np.asarray(v), np.asarray(a), hist


def _run_port(tpg, prog, mode, log_dir=None):
    if mode == "logged":
        eng = tc.GraphDEngine(tpg, prog, tc.EngineConfig(backend="torch"),
                              device="cpu", message_log=tc.MessageLog(log_dir))
    else:
        eng = tc.GraphDEngine(tpg, prog, tc.EngineConfig(mode=mode),
                              device="cpu")
    (v, a), hist = eng.run()
    return v.numpy(), a.numpy(), hist


def _steps(hist):
    return [(h.n_active, h.n_msgs) for h in hist]


def _load_log(d, step, n):
    out = []
    for i in range(n):
        with np.load(f"{d}/step-{step:06d}/shard-{i}.npz") as z:
            out.append((z["A_s"], z["cnt"]))
    return out


# --------------------------------------------------------------------------
# each port mode against the same JAX mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("name,mode", CASES)
def test_mode_matches_reference(name, mode, n, tmp_path):
    g = _graph()
    pg, rmap = partition_graph(g, n_shards=n, edge_block=32)
    ref_f, port_f, _ = PROGRAMS[name]
    src = _source(rmap, g)
    v_ref, a_ref, h_ref = _run_ref(pg, ref_f(src), mode,
                                   str(tmp_path / "ref"))
    v, a, hist = _run_port(_port_pg(pg), port_f(src), mode,
                           str(tmp_path / "port"))
    assert v.dtype == v_ref.dtype
    if name == "pagerank":
        tol = (PAGERANK_TOL * np.abs(v_ref).max() if mode == "recoded_compact"
               else PAGERANK_TOL)
        assert np.abs(v.astype(np.float64) - v_ref).max() < tol
    else:
        np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(a, a_ref)
    assert _steps(hist) == _steps(h_ref)
    if mode == "logged":  # the logged buffers themselves
        for s in range(len(hist)):
            for (A, c), (A_r, c_r) in zip(_load_log(tmp_path / "port", s, n),
                                          _load_log(tmp_path / "ref", s, n)):
                np.testing.assert_array_equal(c, c_r)
                if name == "pagerank":
                    assert np.abs(A.astype(np.float64) - A_r).max() \
                        < PAGERANK_TOL
                else:
                    np.testing.assert_array_equal(A, A_r)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_port_modes_agree_among_themselves(n, tmp_path):
    """The port's modes against its own recoded run: exact for the int,
    MIN and MAX programs, PageRank within 1e-6, recoded_compact within the
    reference's 2e-2 relative bar (PageRank; its wire rounds the others)."""
    g = _graph(seed=5)
    pg, rmap = partition_graph(g, n_shards=n, edge_block=32)
    tpg = _port_pg(pg)
    src = _source(rmap, g)
    for name in ("pagerank", "hashmin", "sssp", "labelspread"):
        _, port_f, modes = PROGRAMS[name]
        v0, a0, h0 = _run_port(tpg, port_f(src), "recoded")
        for mode in modes:
            v, a, hist = _run_port(tpg, port_f(src), mode,
                                   str(tmp_path / f"{name}-{mode}"))
            if mode == "recoded_compact":
                if name == "pagerank":
                    rel = np.abs(v - v0) / np.maximum(np.abs(v0), 1e-9)
                    assert rel.max() < COMPACT_RTOL
                continue
            if name == "pagerank":
                assert np.abs(v - v0).max() < PAGERANK_TOL
            else:
                np.testing.assert_array_equal(v, v0)
            np.testing.assert_array_equal(a, a0)
            assert _steps(hist) == _steps(h0)


def test_sparse_dispatch_under_basic_sc():
    """basic_sc takes skip()'s sparse path as recoded does, with the same
    results and dispatch as the reference."""
    from repro.graph import chain_graph

    g = chain_graph(120)
    pg, rmap = partition_graph(g, n_shards=4, edge_block=8)
    src = _source(rmap, g)
    v_ref, a_ref, h_ref = _run_ref(pg, rc.SSSP(src), "basic_sc")
    v, a, hist = _run_port(_port_pg(pg), tc.SSSP(src), "basic_sc")
    np.testing.assert_array_equal(v, v_ref)
    assert _steps(hist) == _steps(h_ref)
    assert [h.mode for h in hist] == [h.mode for h in h_ref]
    assert "sparse" in [h.mode for h in hist]


def test_combinerless_programs_against_numpy():
    """DistinctInLabels and SecondMinLabel under basic, against a plain
    loop over each vertex's in-edges."""
    g = _graph(scale=6, seed=2)
    pg, _ = partition_graph(g, n_shards=3, edge_block=32)
    tpg = _port_pg(pg)
    n, P = pg.n_shards, pg.P
    gids = np.asarray(pg.gids)
    sp, dp = np.asarray(pg.src_pos), np.asarray(pg.dst_pos)
    ins = {}  # dst gid -> list of src gids
    for i in range(n):
        for k in range(n):
            for s_, d_ in zip(sp[i, k], dp[i, k]):
                if s_ >= 0:
                    ins.setdefault(int(gids[k, d_]), []).append(
                        int(gids[i, s_]))
    v, _, _ = _run_port(tpg, tc.DistinctInLabels(n_groups=8), "basic")
    v2, _, _ = _run_port(tpg, tc.SecondMinLabel(), "basic")
    S = tc.SecondMinLabel.SENTINEL
    for gid in gids[np.asarray(pg.vmask)]:
        srcs = ins.get(int(gid), [])
        assert v[gid % n, gid // n] == len({s_ % 8 for s_ in srcs})
        uniq = sorted(set(srcs))
        assert v2[gid % n, gid // n] == (uniq[1] if len(uniq) > 1 else S)


# --------------------------------------------------------------------------
# config and rejections
# --------------------------------------------------------------------------

def _small_tpg():
    pg, _ = partition_graph(_graph(scale=5), n_shards=2, edge_block=32)
    return _port_pg(pg)


def test_rejects_int_messages_under_recoded_compact():
    with pytest.raises(ValueError, match="float messages"):
        tc.GraphDEngine(_small_tpg(), tc.HashMin(),
                        tc.EngineConfig(mode="recoded_compact"), device="cpu")


@pytest.mark.parametrize("mode", ["recoded", "basic_sc", "recoded_compact"])
def test_rejects_combinerless_program_outside_basic(mode):
    with pytest.raises(ValueError, match="combiner"):
        tc.GraphDEngine(_small_tpg(), tc.DistinctInLabels(),
                        tc.EngineConfig(mode=mode, backend="torch"),
                        device="cpu")


@pytest.mark.parametrize("mode", ["basic", "basic_sc", "recoded_compact"])
def test_rejects_kernel_backend_outside_recoded(mode):
    with pytest.raises(tc.ConfigError, match="recoded"):
        tc.EngineConfig(mode=mode, backend="kernel").finalize()


@pytest.mark.parametrize("mode", ["recoded", "basic", "basic_sc",
                                  "recoded_compact"])
def test_rejects_vertex_only_partition(mode):
    with pytest.raises(ValueError, match="vertex-only"):
        tc.GraphDEngine(drop_edges(_small_tpg()), tc.PageRank(2),
                        tc.EngineConfig(mode=mode), device="cpu")


def test_rejects_message_log_without_combiner(tmp_path):
    with pytest.raises(ValueError, match="combiner"):
        tc.GraphDEngine(_small_tpg(), tc.SecondMinLabel(),
                        tc.EngineConfig(mode="basic"), device="cpu",
                        message_log=tc.MessageLog(str(tmp_path)))


def test_default_backend_follows_mode():
    assert tc.EngineConfig().finalize().backend == "kernel"
    assert tc.EngineConfig(mode="basic").finalize().backend == "torch"
    cfg = tc.EngineConfig(mode="basic_sc")
    assert cfg.finalize().backend == "torch" and cfg.backend is None


# --------------------------------------------------------------------------
# segment helpers against repro.core.api
# --------------------------------------------------------------------------

def _sorted_lists(rng, rows, M, P, n_payloads, pad_frac):
    """(rows, M) destination-sorted lists: dst in [0, P) or P for padding,
    payloads from a pool of ``n_payloads`` values."""
    dst = rng.integers(0, P, (rows, M))
    dst[rng.random((rows, M)) < pad_frac] = P
    msg = rng.integers(-5, 5, (rows, M)) * 1000 + rng.integers(
        0, n_payloads, (rows, M))
    order = np.argsort(dst, axis=1, kind="stable")
    return (np.take_along_axis(dst, order, 1).astype(np.int32),
            np.take_along_axis(msg, order, 1).astype(np.int32))


SEGMENT_CASES = {
    "mixed": dict(M=64, P=16, n_payloads=4, pad_frac=0.2),
    "duplicates": dict(M=64, P=4, n_payloads=2, pad_frac=0.0),
    "all_padding": dict(M=32, P=8, n_payloads=3, pad_frac=1.0),
    "empty_rows": dict(M=0, P=8, n_payloads=3, pad_frac=0.0),
    "one_payload": dict(M=40, P=6, n_payloads=1, pad_frac=0.1),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_helpers_match_reference(case):
    kw = SEGMENT_CASES[case]
    rng = np.random.default_rng(len(case))
    dst, msg = _sorted_lists(rng, 3, **kw)
    if case == "one_payload":
        msg[:] = 7  # a single distinct payload: second-min is the sentinel
    P, S = kw["P"], tc.SecondMinLabel.SENTINEL
    td, tm = torch.from_numpy(dst), torch.from_numpy(msg)
    got = dict(
        distinct=tc.segment_count_distinct(td, tm, P),
        sum=tc.segment_sum(td, tm, P),
        second=tc.segment_second_min(td, tm, P, S),
    )
    for r in range(dst.shape[0]):
        jd, jm = jnp.asarray(dst[r]), jnp.asarray(msg[r])
        want = dict(
            distinct=ref_api.segment_count_distinct(jd, jm, P),
            sum=ref_api.segment_sum(jd, jm, P),
            second=ref_api.segment_second_min(jd, jm, P, S),
        )
        for k in want:
            np.testing.assert_array_equal(got[k][r].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    if case == "one_payload":
        assert (got["second"] == S).all()
    if case in ("all_padding", "empty_rows"):
        assert (got["distinct"] == 0).all() and (got["second"] == S).all()


# --------------------------------------------------------------------------
# the flat skip() prefix
# --------------------------------------------------------------------------

def _bitmap_rows(rng, n, P):
    """Rows of every kind next to each other: random, all active, all idle."""
    kinds = [rng.random(P) < 0.1, np.ones(P, bool), np.zeros(P, bool),
             rng.random(P) < 0.5]
    return np.stack([kinds[i % len(kinds)] for i in range(n)])


@pytest.mark.parametrize("n,P", [(1, 8), (4, 24), (5, 40), (8, 16)])
def test_flat_prefix_keep_mask_matches_reference(n, P):
    rng = np.random.default_rng(n * P)
    active = _bitmap_rows(rng, n, P)
    NB = 12
    lo = rng.integers(0, P, (n, NB))
    hi = np.minimum(lo + rng.integers(0, P // 2, (n, NB)), P - 1)
    lo[:, 0], hi[:, 0] = 0, P - 1  # a whole row
    lo[:, 1], hi[:, 1] = 0, 0  # the row's first position
    lo[:, 2], hi[:, 2] = P - 1, P - 1  # its last
    lo[:, 3], hi[:, 3] = P, -1  # an empty block
    lo[:, 4], hi[:, 4] = P, -1
    lo, hi = lo.astype(np.int32), hi.astype(np.int32)
    prefix = _active_prefix(torch.from_numpy(active))
    assert prefix.shape == (n * P + 1,) and prefix.dtype == torch.int32
    assert int(prefix[-1]) == int(active.sum())
    keep = ops.skip_keep_mask(torch.from_numpy(lo), torch.from_numpy(hi),
                              prefix)
    by_engine = _block_active(prefix, torch.from_numpy(lo[:, None]),
                              torch.from_numpy(hi[:, None]))
    for i in range(n):
        want = np.asarray(ref_block_active(
            _JaxP(P), ref_prefix(jnp.asarray(active[i])), jnp.asarray(lo[i]),
            jnp.asarray(hi[i])))
        np.testing.assert_array_equal(keep[i].numpy(), want)
        np.testing.assert_array_equal(by_engine[i, 0].numpy(), want)
        assert not keep[i, 3:5].any()  # an empty block is never kept


class _JaxP:
    """The one field of a partition that the reference's _block_active reads."""

    def __init__(self, P):
        self.P = P


# --------------------------------------------------------------------------
# port twin of tests/test_properties.py::test_property_modes_agree_on_random_graphs
# --------------------------------------------------------------------------

@given(
    st.lists(st.tuples(st.integers(0, 60), st.integers(0, 60)),
             min_size=1, max_size=150),
    st.integers(1, 5),
)
@settings(max_examples=15, derandomize=True, database=None, deadline=None)
def test_property_modes_agree_on_random_graphs(edges, n):
    """All exchange modes compute identical HashMin fixpoints, each engine
    built through the port's EngineConfig."""
    src = np.array([e[0] for e in edges], dtype=np.int64)
    dst = np.array([e[1] for e in edges], dtype=np.int64)
    keep = src != dst
    if not keep.any():
        return
    g = Graph(src=src[keep], dst=dst[keep], weight=None, directed=False)
    pg, _ = port_partition_graph(g, n, edge_block=8, device="cpu")
    outs = []
    for mode in ["recoded", "basic", "basic_sc"]:
        eng = tc.GraphDEngine(pg, tc.HashMin(), tc.EngineConfig(mode=mode),
                              device="cpu")
        (vals, _), _ = eng.run()
        outs.append(eng.gather_values(vals))
    assert outs[0] == outs[1] == outs[2]
