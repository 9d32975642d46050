"""The port's combiners and its default backend against the JAX package's,
on the CPU.

* The reference's combiner matrix (``tests/test_combiners.py``) for all six
  combiners, each held to ``repro.core.api``'s on the same numpy inputs: OR
  compared as booleans, the rest exactly.
* An OR reachability program, written once against each package, through
  every mode and path the combiner protocol runs: values, active sets,
  message counts and halt step equal to the reference's.
* The default backend: a program the kernels cannot compute (no
  ``msg_kind``, or OR) runs on the torch backend by default and is refused
  at construction when asked for the kernels; the shipped combiner programs
  keep the kernels.
"""

import copy
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import api as ref_api
from repro.core import checkpoint as ref_ckpt
from repro.core.plan import GraphMeta as RefMeta
from repro.core.plan import plan as ref_plan
from repro.graph import partition_graph
from repro.graph import partition_graph_streamed as ref_streamed
from repro.graph import rmat_graph as ref_rmat
from repro_torch import convert
from repro_torch.core import api as port_api
from repro_torch.core import checkpoint as port_ckpt
from repro_torch.core.plan import GraphMeta, plan as make_plan
from repro_torch.graph import partition_graph_streamed, rmat_graph
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.launch.mesh import run_mesh
from torch_or_reach import Reach

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
N_SHARDS, EDGE_BLOCK = 4, 32
GRAPH = dict(scale=9, edge_factor=8, seed=3)

COMBINERS = ["sum", "min", "max", "or", "imin", "imax"]
REF = {"sum": ref_api.SUM, "min": ref_api.MIN, "max": ref_api.MAX,
       "or": ref_api.OR, "imin": ref_api.IMIN, "imax": ref_api.IMAX}
PORT = {"sum": tc.SUM, "min": tc.MIN, "max": tc.MAX, "or": tc.OR,
        "imin": tc.IMIN, "imax": tc.IMAX}
INT = ("imin", "imax")


def _norm(name, x):
    """Each combiner's natural domain: OR is the boolean semiring."""
    a = np.asarray(x)
    return a.astype(bool) if name == "or" else a


def _sample(name, rng, size):
    """The reference's samples (``tests/test_combiners.py``): 0/1 for OR,
    small integers otherwise, in int32 for the integer combiners."""
    if name == "or":
        return rng.integers(0, 2, size=size).astype(np.float32)
    x = rng.integers(-50, 50, size=size)
    return x.astype(np.int32 if name in INT else np.float32)


def _both(name, fn, *arrays):
    """``fn(combiner, *arrays)`` in each package: (port, reference) as numpy."""
    got = fn(PORT[name], *(torch.from_numpy(np.asarray(a)) for a in arrays))
    want = fn(REF[name], *(jnp.asarray(a) for a in arrays))
    return _norm(name, got.numpy()), _norm(name, want)


# --------------------------------------------------------------------------
# the combiner matrix, each against repro.core.api
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", COMBINERS)
def test_commutative(name):
    rng = np.random.default_rng(0)
    a, b = _sample(name, rng, 64), _sample(name, rng, 64)
    ab, want = _both(name, lambda c, x, y: c.combine(x, y), a, b)
    ba, _ = _both(name, lambda c, x, y: c.combine(x, y), b, a)
    np.testing.assert_array_equal(ab, ba)
    np.testing.assert_array_equal(ab, want)


@pytest.mark.parametrize("name", COMBINERS)
def test_associative(name):
    rng = np.random.default_rng(1)
    a, b, c = (_sample(name, rng, 64) for _ in range(3))
    lhs, want = _both(name, lambda k, x, y, z: k.combine(k.combine(x, y), z),
                      a, b, c)
    rhs, _ = _both(name, lambda k, x, y, z: k.combine(x, k.combine(y, z)),
                   a, b, c)
    np.testing.assert_array_equal(lhs, rhs)
    np.testing.assert_array_equal(lhs, want)


@pytest.mark.parametrize("name", COMBINERS)
def test_identity(name):
    dtype = np.int32 if name in INT + ("or",) else np.float32
    rng = np.random.default_rng(2)
    a = _sample(name, rng, 64).astype(dtype)
    e0 = np.full((64,), PORT[name].e0, dtype)
    assert PORT[name].e0 == REF[name].e0
    for x, y in ((a, e0), (e0, a)):
        got, want = _both(name, lambda c, p, q: c.combine(p, q), x, y)
        np.testing.assert_array_equal(got, _norm(name, a))
        np.testing.assert_array_equal(got, want)
    ident = PORT[name].identity((8,), torch.from_numpy(a).dtype, "cpu")
    np.testing.assert_array_equal(
        ident.numpy(), np.asarray(REF[name].identity((8,), dtype)))


@pytest.mark.parametrize("name", COMBINERS)
def test_exhaustive_small_domain(name):
    """Associativity over the whole small domain, not only samples."""
    dom = [0.0, 1.0] if name == "or" else [-2.0, 0.0, 3.0]
    dtype = np.int32 if name in INT else np.float32
    for x, y, z in itertools.product(dom, repeat=3):
        a, b, c = (np.array([v], dtype) for v in (x, y, z))
        lhs, want = _both(
            name, lambda k, p, q, r: k.combine(k.combine(p, q), r), a, b, c)
        rhs, _ = _both(
            name, lambda k, p, q, r: k.combine(p, k.combine(q, r)), a, b, c)
        np.testing.assert_array_equal(lhs, rhs)
        np.testing.assert_array_equal(lhs, want)


@pytest.mark.parametrize("seed", [0, 7, 23])
@pytest.mark.parametrize("name", COMBINERS)
def test_scatter_reduce_agree(name, seed):
    """identity + scatter (the A_s path) == reduce over stacked one-slot
    buffers (the exchange's digest), and each equals the reference's."""
    rng = np.random.default_rng(seed)
    P, M = 16, 80
    idx = rng.integers(0, P, size=M).astype(np.int64)
    msgs = _sample(name, rng, M)
    port, ref = PORT[name], REF[name]
    tdt = torch.from_numpy(msgs).dtype
    scattered = port.scatter(port.identity((P,), tdt, "cpu"),
                             torch.from_numpy(idx), torch.from_numpy(msgs))
    stack = np.full((M, P), port.e0, dtype=msgs.dtype)
    stack[np.arange(M), idx] = msgs
    reduced = port.reduce(torch.from_numpy(stack), 0)
    want_s = ref.scatter(ref.identity((P,), msgs.dtype), jnp.asarray(idx),
                         jnp.asarray(msgs))
    want_r = ref.reduce(jnp.asarray(stack), 0)
    np.testing.assert_array_equal(_norm(name, scattered.numpy()),
                                  _norm(name, reduced.numpy()))
    np.testing.assert_array_equal(_norm(name, scattered.numpy()),
                                  _norm(name, want_s))
    np.testing.assert_array_equal(_norm(name, reduced.numpy()),
                                  _norm(name, want_r))
    assert scattered.dtype == reduced.dtype == tdt


@pytest.mark.parametrize("name", COMBINERS)
def test_scatter_of_identity_is_noop(name):
    """Padded edge slots scatter e0: they must change nothing."""
    port = PORT[name]
    tdt = torch.int32 if name in INT else torch.float32
    target = port.identity((8,), tdt, "cpu")
    out = port.scatter(target.clone(), torch.zeros(32, dtype=torch.int64),
                       torch.full((32,), port.e0, dtype=tdt))
    assert torch.equal(out, target)


def test_or_keeps_the_message_dtype():
    """A ring accumulator stays what it was: combine casts the logical or
    back to the message dtype, 0/1."""
    a = torch.tensor([0.0, 1.0, 0.0, 1.0])
    b = torch.tensor([0.0, 0.0, 1.0, 1.0])
    out = tc.OR.combine(a, b)
    assert out.dtype == torch.float32
    assert out.tolist() == [0.0, 1.0, 1.0, 1.0]
    assert "OR" in tc.__all__ and tc.OR is port_api.OR


# --------------------------------------------------------------------------
# an OR program through every mode, against the reference's
# --------------------------------------------------------------------------

def _ref_reach(msg_dtype):
    class RefReach(ref_api.VertexProgram):
        combiner = ref_api.OR

        def __init__(self, source):
            self.source = int(source)
            self.msg_dtype = msg_dtype

        def init(self, ctx):
            flag = (ctx.new_ids == self.source).astype(jnp.float32)
            return flag, flag > 0

        def message(self, value, degree, weight, step):
            return value

        def apply(self, value, degree, msg, has_msg, active, step, ctx):
            got = has_msg & (msg.astype(jnp.float32) > 0) & (value == 0)
            return jnp.where(got, 1.0, value), got

    return RefReach


#: The reference's ring (``recoded`` and ``basic_sc``) carries its
#: accumulator through ``lax.fori_loop``, which refuses the bool that
#: ``jnp.logical_or`` returns for float32 messages; it runs OR there only
#: with bool messages, and ``recoded_compact`` only with float ones. Its
#: twin takes the message dtype that each mode accepts; the port's keeps
#: float32 everywhere.
REF_BOOL_MODES = ("recoded", "basic_sc")


def _ref_program(mode, source):
    dt = jnp.bool_ if mode in REF_BOOL_MODES else jnp.float32
    return _ref_reach(dt)(source)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("or")
    g_ref, g = ref_rmat(**GRAPH), rmat_graph(**GRAPH)
    pg, rmap = partition_graph(g_ref, N_SHARDS, edge_block=EDGE_BLOCK)
    arrays = {f: np.asarray(getattr(pg, f)) for f in PartitionedGraph.TENSORS}
    static = {f: getattr(pg, f) for f in convert.STATIC}
    tpg = convert.partition_from_arrays(arrays, static, device="cpu")
    pgs_ref, _, st_ref = ref_streamed(g_ref, N_SHARDS, str(d / "ref"),
                                      edge_block=EDGE_BLOCK)
    pgs, _, st = partition_graph_streamed(g, N_SHARDS, str(d / "port"),
                                          edge_block=EDGE_BLOCK, device="cpu")
    src = int(rmap.to_new(np.array([int(g.vertex_ids[0])]))[0])
    return dict(g_ref=g_ref, g=g, pg=pg, tpg=tpg, pgs_ref=pgs_ref,
                st_ref=st_ref, pgs=pgs, st=st, src=src)


def _streamed_cfg(pkg, pipeline):
    return pkg.EngineConfig(mode="streamed",
                            stream=pkg.StreamConfig(chunk_blocks=2),
                            channel=pkg.ChannelConfig(pipeline=pipeline))


def _run(pkg, s, mode, log_dir=None):
    src = s["src"]
    prog = Reach(src) if pkg is tc else _ref_program(mode, src)
    kw = dict(device="cpu") if pkg is tc else {}
    if mode.startswith("streamed"):
        cfg = _streamed_cfg(pkg, mode == "streamed-fd")
        pg = s["pgs"] if pkg is tc else s["pgs_ref"]
        kw["stream_store"] = s["st"] if pkg is tc else s["st_ref"]
    elif mode == "logged":
        cfg = pkg.EngineConfig()
        pg = s["tpg"] if pkg is tc else s["pg"]
        kw["message_log"] = (port_ckpt if pkg is tc else ref_ckpt).MessageLog(
            log_dir)
    else:
        cfg = pkg.EngineConfig(mode=mode)
        pg = s["tpg"] if pkg is tc else s["pg"]
    if pkg is tc:
        eng = tc.GraphDEngine(pg, prog, cfg, **kw)
        assert eng.backend == "torch"
    else:
        eng = rc.GraphDEngine(pg, prog, config=cfg, **kw)
    (v, a), hist = eng.run()
    return _summary(v, a, hist)


def _summary(values, active, hist):
    return dict(values=np.asarray(values), active=np.asarray(active),
                steps=len(hist), n_msgs=[int(h.n_msgs) for h in hist],
                n_active=[int(h.n_active) for h in hist])


def _assert_same(got, want):
    assert got["values"].dtype == np.float32
    np.testing.assert_array_equal(got["values"], want["values"])
    np.testing.assert_array_equal(got["active"], want["active"])
    assert got["steps"] == want["steps"]
    assert got["n_msgs"] == want["n_msgs"]
    assert got["n_active"] == want["n_active"]


MODES = ["recoded", "recoded_compact", "basic", "basic_sc", "logged",
         "streamed", "streamed-fd"]


@pytest.mark.parametrize("mode", MODES)
def test_or_program_matches_reference(setup, mode, tmp_path):
    got = _run(tc, setup, mode, str(tmp_path / "port"))
    want = _run(rc, setup, mode, str(tmp_path / "ref"))
    _assert_same(got, want)
    # the source reaches more than itself, and a step finds nothing new
    assert 1 < want["values"].sum() < setup["g"].n_vertices
    assert want["n_active"][-1] == 0


def test_or_modes_agree(setup, tmp_path):
    """Every mode's reached set and halt step equal ``recoded``'s; the
    message counts too, but for ``recoded_compact``, which counts the
    shards that sent a vertex anything."""
    runs = {m: _run(tc, setup, m, str(tmp_path / m)) for m in MODES}
    base = runs["recoded"]
    for mode, r in runs.items():
        np.testing.assert_array_equal(r["values"], base["values"])
        np.testing.assert_array_equal(r["active"], base["active"])
        assert r["steps"] == base["steps"], mode
        if mode != "recoded_compact":
            assert r["n_msgs"] == base["n_msgs"], mode


@pytest.mark.parametrize("failed", [0, 2])
def test_or_recover_shard(setup, tmp_path, failed):
    """The logged run by each package, then ``recover_shard`` of one shard
    from its checkpoint and message log, by each package: the live row."""
    out = {}
    for pkg, pg in ((tc, setup["tpg"]), (rc, setup["pg"])):
        tag = "port" if pkg is tc else "ref"
        ck_mod = port_ckpt if pkg is tc else ref_ckpt
        ck = ck_mod.Checkpointer(str(tmp_path / tag / "ck"), every=2)
        log = ck_mod.MessageLog(str(tmp_path / tag / "log"))
        prog = (Reach(setup["src"]) if pkg is tc
                else _ref_program("logged", setup["src"]))
        if pkg is tc:
            eng = tc.GraphDEngine(pg, prog, device="cpu", message_log=log)
        else:
            eng = rc.GraphDEngine(pg, prog, message_log=log)
        ck.save(0, *eng.init())
        (v, a), hist = eng.run(checkpointer=ck)
        assert len(hist) - ck.latest() >= 1  # something to replay
        vj, aj = ck_mod.recover_shard(pg, prog, failed, ck, log, len(hist))
        np.testing.assert_array_equal(np.asarray(vj), np.asarray(v)[failed])
        np.testing.assert_array_equal(np.asarray(aj), np.asarray(a)[failed])
        out[tag] = np.asarray(vj)
    np.testing.assert_array_equal(out["port"], out["ref"])


def test_or_recover_shard_streamed(setup, tmp_path):
    """A logged streamed run (checkpoints and run-file message log) by the
    port; both packages' ``recover_shard_streamed`` replay shard 1 to the
    live row."""
    ck_dir, log_dir = str(tmp_path / "ck"), str(tmp_path / "log")
    ck = port_ckpt.Checkpointer(ck_dir, every=2)
    eng = tc.GraphDEngine(setup["pgs"], Reach(setup["src"]),
                          tc.EngineConfig(mode="streamed"), device="cpu",
                          stream_store=setup["st"],
                          message_log=port_ckpt.RunFileMessageLog(log_dir))
    ck.save(0, *eng.init())
    (v, a), hist = eng.run(checkpointer=ck)
    target = len(hist)
    assert target - ck.latest() >= 1
    pv, pa = port_ckpt.recover_shard_streamed(
        setup["pgs"], Reach(setup["src"]), 1, port_ckpt.Checkpointer(ck_dir),
        port_ckpt.RunFileMessageLog(log_dir), setup["st"], target)
    jv, ja = ref_ckpt.recover_shard_streamed(
        setup["pgs_ref"], _ref_program("streamed", setup["src"]), 1,
        ref_ckpt.Checkpointer(ck_dir), ref_ckpt.RunFileMessageLog(log_dir),
        setup["st_ref"], target)
    for got, gota in ((pv.numpy(), pa.numpy()),
                      (np.asarray(jv), np.asarray(ja))):
        np.testing.assert_array_equal(got, v.numpy()[1])
        np.testing.assert_array_equal(gota, a.numpy()[1])


@pytest.fixture
def spawn_env(monkeypatch):
    """Spawned workers and ranks unpickle ``torch_or_reach.Reach``: they
    find it on PYTHONPATH, one OpenMP thread each."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS, SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_or_on_a_gloo_mesh(setup, spawn_env, tmp_path):
    """``GraphDEngine(mesh=)`` over gloo, one rank a shard: the
    reference's ``recoded`` run."""
    (v, a), hist = run_mesh(setup["tpg"], Reach(setup["src"]),
                            tc.EngineConfig(), device="cpu",
                            workdir=str(tmp_path / "mesh"), timeout=300)
    _assert_same(_summary(v, a, hist), _run(rc, setup, "recoded"))


def test_or_under_launch_processes(setup, spawn_env, tmp_path):
    """One worker process a shard (the file transport): the reference's
    threads run of its own plan for the graph."""
    g, g_ref = setup["g"], setup["g_ref"]
    p = make_plan(Reach(setup["src"]), GraphMeta.of(g),
                  tc.MemoryBudget(n_shards=N_SHARDS), edge_block=EDGE_BLOCK,
                  launch="processes")
    assert p.mode == "streamed" and p.config.backend == "torch"
    with tc.GraphDJob(Reach(setup["src"]), g, plan=copy.deepcopy(p),
                      device="cpu", workdir=str(tmp_path / "procs"),
                      launch="processes") as jp:
        rp = jp.run()
        assert jp._last_run_recoveries == 0
    pr = ref_plan(_ref_program("streamed", setup["src"]), RefMeta.of(g_ref),
                  rc.MemoryBudget(n_shards=N_SHARDS), edge_block=EDGE_BLOCK,
                  launch="processes")
    with rc.GraphDJob(_ref_program("streamed", setup["src"]), g_ref, plan=pr,
                      workdir=str(tmp_path / "ref")) as jr:
        rr = jr.run()
    assert rp.n_supersteps == rr.n_supersteps
    for field in ("n_active", "n_msgs"):
        assert [getattr(x, field) for x in rp.history] == \
               [getattr(x, field) for x in rr.history], field
    assert rp.values == rr.values


# --------------------------------------------------------------------------
# the default backend
# --------------------------------------------------------------------------

class P2(tc.PageRank):
    """PageRank without a ``msg_kind``: the kernels cannot compute it."""

    msg_kind = None


class RefP2(rc.PageRank):
    msg_kind = None


def test_program_without_msg_kind_runs_on_the_default_config(setup):
    eng = tc.GraphDEngine(setup["tpg"], P2(3), device="cpu")
    assert eng.backend == "torch" and eng.config.backend == "torch"
    (v, a), hist = eng.run()
    (v_ref, a_ref), h_ref = rc.GraphDEngine(setup["pg"], RefP2(3)).run()
    assert len(hist) == len(h_ref) == 3
    assert np.abs(v.numpy() - np.asarray(v_ref)).max() < 1e-6
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


def test_program_without_msg_kind_runs_in_a_job(setup):
    job = tc.GraphDJob(P2(3), setup["g"],
                       budget=tc.MemoryBudget(n_shards=N_SHARDS), device="cpu")
    assert job.plan.mode == "recoded" and job.plan.config.backend == "torch"
    with job:
        r = job.run()
    with rc.GraphDJob(RefP2(3), setup["g_ref"],
                      budget=rc.MemoryBudget(n_shards=N_SHARDS)) as jr:
        rr = jr.run()
    assert r.n_supersteps == rr.n_supersteps == 3
    assert r.values.keys() == rr.values.keys()
    assert max(abs(r.values[k] - rr.values[k]) for k in rr.values) < 1e-6


class CopyReach(Reach):
    """OR reachability that declares a ``msg_kind``: the kernels still
    cannot compute its combiner."""

    msg_kind = "copy"


@pytest.mark.parametrize("make,what", [(lambda s: P2(3), "msg_kind"),
                                       (lambda s: Reach(s), "msg_kind"),
                                       (lambda s: CopyReach(s), "combiner")])
def test_explicit_kernel_backend_refuses_what_the_kernels_cannot_compute(
        setup, monkeypatch, make, what):
    from repro_torch.core import engine

    def no_launch(*a, **k):
        raise AssertionError("a kernel was launched")
    monkeypatch.setattr(engine, "edge_combine", no_launch)
    monkeypatch.setattr(engine, "kernel_digest", no_launch)
    prog = make(setup["src"])
    with pytest.raises(tc.ConfigError, match=what):
        tc.GraphDEngine(setup["tpg"], prog, tc.EngineConfig(backend="kernel"),
                        device="cpu")
    with pytest.raises(tc.ConfigError, match=what):
        tc.EngineConfig(backend="kernel").finalize(prog)
    assert tc.EngineConfig().finalize(prog).backend == "torch"
    # no program: recoded still resolves to the kernels
    assert tc.EngineConfig().finalize().backend == "kernel"


SHIPPED = {
    "pagerank": lambda s: tc.PageRank(3), "hashmin": lambda s: tc.HashMin(),
    "sssp": lambda s: tc.SSSP(s), "bfs": lambda s: tc.BFS(s),
    "degreesum": lambda s: tc.DegreeSum(),
    "labelspread": lambda s: tc.LabelSpread(),
}


@pytest.mark.parametrize("name", list(SHIPPED))
def test_shipped_combiner_programs_keep_the_kernels(setup, name):
    prog = SHIPPED[name](setup["src"])
    assert tc.EngineConfig().finalize(prog).backend == "kernel"
    assert tc.GraphDEngine(setup["tpg"], prog,
                           device="cpu").backend == "kernel"
    p = make_plan(prog, GraphMeta.of(setup["g"]),
                  tc.MemoryBudget(n_shards=N_SHARDS), edge_block=EDGE_BLOCK)
    assert p.mode == "recoded" and p.config.backend == "kernel"
