"""The port's multi-process launch (``launch="processes"``, one worker OS
process per shard over the shared-filesystem transport) on the CPU: the
``processes`` column of tests/test_equivalence.py's matrix (every algorithm
bit-identical to the port's own ``launch="threads"`` full-duplex run of the
same plan, and to the JAX package's threads run: integer, MIN and MAX
programs exactly, PageRank within 1e-6), twins of the processes tests of
tests/test_job.py, the socket transport's launch options accepted as the
JAX package accepts them, and a worker's outbox runs and per-worker message
log opened by the JAX package's stores."""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core.plan import GraphMeta as RefMeta
from repro.core.plan import plan as ref_plan
from repro.graph import rmat_graph as ref_rmat
from repro.streams.msgstore import MessageRunStore as RefRunStore
from repro_torch.core.plan import GraphMeta, plan as make_plan
from repro_torch.graph import rmat_graph
from repro_torch.streams.msgstore import MessageRunStore

# the shapes here are tiny: one intra-op thread keeps torch's idle OpenMP
# workers from competing with the other test processes
torch.set_num_threads(1)

N_SHARDS = 3
EDGE_BLOCK = 32  # tests/test_equivalence.py's default
PAGERANK_TOL = 1e-6  # tests/test_engine.py:99, across modes


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def graphs():
    kw = dict(scale=6, edge_factor=6, seed=5, weights="uniform")
    return ref_rmat(**kw), rmat_graph(**kw)


def _src(g):
    """Vertex 0's recoded id, the SSSP/BFS source (the recode map is a
    pure function of the vertex ids and the shard count)."""
    from repro_torch.graph.recode import recode_ids

    rmap = recode_ids(g.vertex_ids, N_SHARDS)
    return int(rmap.to_new(np.array([int(g.vertex_ids[0])]))[0])


#: name -> (reference factory, port factory, exact); each takes the graph
ALGORITHMS = {
    "pagerank": (lambda g: rc.PageRank(supersteps=5),
                 lambda g: tc.PageRank(supersteps=5), False),
    "hashmin": (lambda g: rc.HashMin(), lambda g: tc.HashMin(), True),
    "sssp": (lambda g: rc.SSSP(_src(g)), lambda g: tc.SSSP(_src(g)), True),
    "bfs": (lambda g: rc.BFS(_src(g)), lambda g: tc.BFS(_src(g)), True),
    "degreesum": (lambda g: rc.DegreeSum(), lambda g: tc.DegreeSum(), True),
    "labelspread": (lambda g: rc.LabelSpread(), lambda g: tc.LabelSpread(),
                    True),
    "distinct": (lambda g: rc.DistinctInLabels(n_groups=8, rounds=2),
                 lambda g: tc.DistinctInLabels(n_groups=8, rounds=2), True),
    "secondmin": (lambda g: rc.SecondMinLabel(),
                  lambda g: tc.SecondMinLabel(), True),
}

HISTORY_FIELDS = ("n_active", "n_msgs", "agg", "density")


def _plan(prog, g):
    return make_plan(prog, GraphMeta.of(g), tc.MemoryBudget(n_shards=N_SHARDS),
                     edge_block=EDGE_BLOCK, launch="processes")


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_matrix_processes_launch_matches_full_duplex(graphs, tmp_path, name):
    """The same algorithm run as THREE REAL OS PROCESSES over the
    shared-filesystem transport is bit-identical to the single-process
    full-duplex streamed run of the SAME plan: values, active and message
    trajectories, aggregator and density, PageRank included (the worker
    folds through the engine's own fold_groups and digests ascending
    source, so the sums are the same sums in the same order). Against the
    JAX package's threads run: integer programs exactly, PageRank within
    1e-6, the same trajectories."""
    g_ref, g = graphs
    ref_f, port_f, exact = ALGORITHMS[name]
    p = _plan(port_f(g), g)
    assert p.mode == "streamed" and p.pipeline
    assert p.config.channel.full_duplex and p.launch == "processes"
    with tc.GraphDJob(port_f(g), g, plan=copy.deepcopy(p), device="cpu",
                      workdir=str(tmp_path / "threads")) as jt:
        rt = jt.run(max_supersteps=60)
    with tc.GraphDJob(port_f(g), g, plan=copy.deepcopy(p), device="cpu",
                      workdir=str(tmp_path / "procs"),
                      launch="processes") as jp:
        rp = jp.run(max_supersteps=60)
        assert jp._last_run_recoveries == 0
    assert rp.n_supersteps == rt.n_supersteps
    for field in HISTORY_FIELDS:
        assert [getattr(x, field) for x in rp.history] == \
               [getattr(x, field) for x in rt.history], (name, field)
    assert rp.values == rt.values  # bit-identical
    # the JAX package's threads run of its own plan for the same graph
    pr = ref_plan(ref_f(g_ref), RefMeta.of(g_ref),
                  rc.MemoryBudget(n_shards=N_SHARDS), edge_block=EDGE_BLOCK,
                  launch="processes")
    with rc.GraphDJob(ref_f(g_ref), g_ref, plan=pr,
                      workdir=str(tmp_path / "ref")) as jr:
        rr = jr.run(max_supersteps=60)
    assert rp.n_supersteps == rr.n_supersteps
    for field in ("n_active", "n_msgs", "density"):
        assert [getattr(x, field) for x in rp.history] == \
               [getattr(x, field) for x in rr.history], (name, field)
    assert rp.values.keys() == rr.values.keys()
    if exact:
        assert rp.values == rr.values
    else:
        keys = sorted(rr.values)
        gap = np.abs(np.array([rp.values[k] for k in keys])
                     - np.array([rr.values[k] for k in keys])).max()
        assert gap < PAGERANK_TOL, gap


# --------------------------------------------------------------------------
# the job facade under launch="processes" (tests/test_job.py twins)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def job_graph():
    return rmat_graph(scale=8, edge_factor=8, seed=9)


def test_job_launch_knob_validation(job_graph):
    g = job_graph
    with pytest.raises(ValueError, match="launch"):
        tc.GraphDJob(tc.HashMin(), g, budget=tc.MemoryBudget(n_shards=3),
                     launch="cluster", device="cpu")
    # an in-memory plan cannot be deployed as processes
    p = make_plan(tc.HashMin(), g, tc.MemoryBudget(n_shards=3),
                  edge_block=EDGE_BLOCK)
    assert p.mode != "streamed"
    with pytest.raises(ValueError, match="streamed"):
        tc.GraphDJob(tc.HashMin(), g, plan=p, launch="processes",
                     device="cpu")


def test_job_processes_planner_vetoes_and_launch_field(job_graph):
    p = make_plan(tc.HashMin(), job_graph, tc.MemoryBudget(n_shards=3),
                  edge_block=EDGE_BLOCK, launch="processes")
    assert p.launch == "processes"
    assert p.mode == "streamed" and p.pipeline
    assert p.config.channel.full_duplex
    rejected = {c.name: c for c in p.alternatives if not c.feasible}
    assert "recoded" in rejected
    assert "streamed" in rejected  # the unpipelined fold
    assert "processes" in rejected["recoded"].reason
    from repro_torch.core.plan import ExecutionPlan
    assert ExecutionPlan.from_json(p.to_json()).launch == "processes"


def test_job_processes_auto_payload_downgrades_to_lossless(job_graph,
                                                           tmp_path):
    """``compress_payload="auto"`` under ``launch="processes"``: the job
    downgrades the plan to the fixed lossless codec; the threaded launch
    keeps the auto-pick."""
    def auto_plan():
        p = make_plan(tc.HashMin(), job_graph, tc.MemoryBudget(n_shards=3),
                      edge_block=EDGE_BLOCK, launch="processes")
        return dataclasses.replace(p, config=dataclasses.replace(
            p.config, channel=dataclasses.replace(
                p.config.channel, compress_payload="auto")))

    p = auto_plan()
    assert p.config.channel.payload_scheme == "auto"
    with tc.GraphDJob(tc.HashMin(), job_graph, plan=p, launch="processes",
                      device="cpu", workdir=str(tmp_path / "auto")) as job:
        assert job.plan.config.channel.payload_scheme == "lossless"
    with tc.GraphDJob(tc.HashMin(), job_graph, plan=auto_plan(),
                      device="cpu", workdir=str(tmp_path / "threads")) as jt:
        assert jt.plan.config.channel.payload_scheme == "auto"


def test_job_processes_run_resume_and_memory_budget(job_graph, tmp_path):
    """A paused processes job resumes from live state; the realized
    per-process RAM honors the budget the planner promised it under."""
    g = job_graph
    loose = make_plan(tc.HashMin(), g, tc.MemoryBudget(n_shards=3),
                      edge_block=EDGE_BLOCK, launch="processes")
    budget = tc.MemoryBudget(ram_per_shard=loose.ram_total, n_shards=3)
    with tc.GraphDJob(tc.HashMin(), g, plan=copy.deepcopy(loose),
                      device="cpu", workdir=str(tmp_path / "ref")) as ref:
        r_ref = ref.run()
    job = tc.GraphDJob(tc.HashMin(), g, budget=budget, edge_block=EDGE_BLOCK,
                       launch="processes", device="cpu",
                       workdir=str(tmp_path / "procs"))
    assert job.plan.launch == "processes"
    first = job.run(max_supersteps=2)
    assert first.n_supersteps == 2
    second = job.run()  # resumes from the live state at step 2
    assert second.history[0].step == 2
    assert second.values == r_ref.values  # bit-identical across the pause
    assert second.realized_ram <= budget.ram_per_shard
    # transport scratch was swept; durable artifacts (spec, results) remain
    procs_dir = job._dir("procs", "")
    assert not os.path.exists(os.path.join(procs_dir, "outbox"))
    assert not os.path.exists(os.path.join(procs_dir, "announce"))
    assert os.path.exists(os.path.join(procs_dir, "spec.json"))
    job.close()


def test_job_processes_recover_shard_reads_the_worker_lineage(job_graph,
                                                              tmp_path):
    """``recover_shard`` after a processes run replays the failed shard
    from its own worker's log (logs/shard-w) to its live row."""
    with tc.GraphDJob(tc.PageRank(supersteps=4), job_graph,
                      budget=tc.MemoryBudget(n_shards=3),
                      edge_block=EDGE_BLOCK, launch="processes",
                      checkpoint_every=3, device="cpu",
                      workdir=str(tmp_path / "job")) as job:
        job.run()
        assert os.path.isdir(os.path.join(job._dir("logs", ""), "shard-1",
                                          "step-000003"))
        v, a = job.recover_shard(1)
        assert torch.equal(v, job._state[0][1])
        assert torch.equal(a, job._state[1][1])


# --------------------------------------------------------------------------
# the socket transport's launch options
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    {"transport": "sockets"},
    {"transport": "sockets", "kill_net": {"shard": 1, "step": 2}},
    {"transport": "sockets", "coord_kill": {"step": 1}},
], ids=["transport", "kill_net", "coord_kill"])
def test_socket_transport_names_slice_4b(job_graph, tmp_path, opts):
    """``transport="sockets"`` and the socket-only drills build a
    processes job (the spill lands, the options ride on the job as given)
    and validate exactly as the JAX package's validator does; the drills
    are refused beside the file transport by both validators alike."""
    from repro.core.config import ConfigError as RefConfigError
    from repro.core.config import validate_launch_opts as ref_validate
    from repro_torch.core.config import validate_launch_opts

    workdir = str(tmp_path / "job")
    with tc.GraphDJob(tc.HashMin(), job_graph, launch="processes",
                      launch_opts=opts, device="cpu",
                      workdir=workdir) as job:
        assert job.launch_opts == opts
        assert job.plan.mode == "streamed"
        assert os.path.isdir(os.path.join(workdir, "edges"))
    assert validate_launch_opts(opts, "processes") == \
        ref_validate(opts, "processes") == opts
    files = dict(opts, transport="files")
    if len(opts) > 1:  # a sockets drill beside the file transport
        with pytest.raises(tc.ConfigError, match="sockets-transport drill"):
            validate_launch_opts(files, "processes")
        with pytest.raises(RefConfigError, match="sockets-transport drill"):
            ref_validate(files, "processes")
    else:
        assert validate_launch_opts(files, "processes") == \
            ref_validate(files, "processes") == files


# --------------------------------------------------------------------------
# a worker's outbox runs and its per-worker log, read by the JAX package
# --------------------------------------------------------------------------

def _runs(store_cls, directory, n, with_counts):
    """{(dest, seg index): (tag, arrays)} of every run in a store."""
    st = store_cls.open(directory)
    try:
        assert st.with_counts == with_counts
        return {(k, j): (seg.tag, [np.asarray(x) for x in
                                   st.read_run(k, seg)])
                for k in range(n) for j, seg in enumerate(st.runs(k))}
    finally:
        st.close()


def _same_runs(got, want):
    assert got.keys() == want.keys() and got
    for key in want:
        assert got[key][0] == want[key][0], key
        for x, y in zip(got[key][1], want[key][1]):
            assert x.dtype == y.dtype and np.array_equal(x, y), key


@pytest.mark.parametrize("name", ["pagerank", "distinct"])
def test_worker_outbox_runs_open_in_the_reference(graphs, tmp_path, name):
    """Each worker's outbox for superstep 0, written by its ``_send``, is a
    run store the JAX package's MessageRunStore opens to the same runs
    (combined sparse runs for PageRank, raw spills for the combiner-less
    program)."""
    from repro_torch.core.coordinator import FileCoordinator
    from repro_torch.launch import procs

    _, g = graphs
    prog = ALGORITHMS[name][1](g)
    with tc.GraphDJob(prog, g, plan=_plan(prog, g), launch="processes",
                      device="cpu", workdir=str(tmp_path / "job")) as job:
        pd = job._dir("procs", "")
        os.makedirs(pd)
        procs._write_spec(job, pd, os.path.join(pd, "coord"), start_step=0,
                          target=5, bootstrap="init", ckpt_step=None,
                          heartbeat_interval=0.25, heartbeat_timeout=10.0)
        import json

        with open(os.path.join(pd, procs.SPEC)) as f:
            spec = json.load(f)
        coord = FileCoordinator(spec["coord_dir"], N_SHARDS)
        for w in range(N_SHARDS):
            wk = procs._Worker(spec, prog, w, coord)
            wk._send(0, *wk.bootstrap())
            d = procs._outbox_dir(pd, 0, w)
            comb = prog.combiner is not None
            _same_runs(_runs(RefRunStore, d, N_SHARDS, comb),
                       _runs(MessageRunStore, d, N_SHARDS, comb))


@pytest.mark.parametrize("name", ["hashmin", "secondmin"])
def test_worker_message_log_opens_in_the_reference(graphs, tmp_path, name):
    """After a logged processes run, every worker's own log lineage
    (logs/shard-w/step-NNNNNN) opens in the JAX package: its
    MessageRunStore gives the same runs, and for a combiner program its
    RunFileMessageLog densifies the same (A_s, cnt) pairs."""
    from repro.core.checkpoint import RunFileMessageLog as RefLog
    from repro_torch.convert import numpy_dtype

    _, g = graphs
    prog = ALGORITHMS[name][1](g)
    comb = prog.combiner is not None
    with tc.GraphDJob(prog, g, plan=_plan(prog, g), launch="processes",
                      checkpoint_every=50, device="cpu",
                      workdir=str(tmp_path / "job")) as job:
        res = job.run(max_supersteps=3)
        logs = job._dir("logs", "")
        for w in range(N_SHARDS):
            lineage = os.path.join(logs, f"shard-{w}")
            port_log = tc.RunFileMessageLog(lineage)
            ref_log = RefLog(lineage)
            for log in (port_log, ref_log):
                log.configure(N_SHARDS, job.pg.P,
                              numpy_dtype(prog.msg_dtype),
                              e0=prog.combiner.e0 if comb else 0,
                              combined=comb)
            for s in range(res.n_supersteps):
                d = port_log.step_dir(s)
                assert os.path.isdir(d), d
                _same_runs(_runs(RefRunStore, d, N_SHARDS, comb),
                           _runs(MessageRunStore, d, N_SHARDS, comb))
                if comb:
                    got = ref_log.load_for_dest(s, w, N_SHARDS, -1)
                    want = port_log.load_for_dest(s, w, N_SHARDS, -1)
                    assert len(got) == len(want)
                    assert s > 0 or len(got) == N_SHARDS
                    for (A1, c1), (A2, c2) in zip(got, want):
                        assert np.array_equal(A1, A2)
                        assert np.array_equal(c1, c2)
