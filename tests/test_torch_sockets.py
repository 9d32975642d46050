"""The port's socket transport end to end on the CPU:
``GraphDJob(launch="processes", launch_opts={"transport": "sockets"})``,
three worker processes and a coordinator process talking over loopback TCP.
The sockets column of tests/test_equivalence.py's processes matrix (every
algorithm bit-identical to the port's threads full-duplex run and to its
files processes run of the same plan; integer programs equal to the JAX
package's threads run, PageRank within 1e-6), the mid-frame kill -9 drill
of tests/test_fault.py, a worker without its device under sockets, and the
planner's measured link probe (tests/test_plan.py's twin)."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core.plan import GraphMeta as RefMeta
from repro.core.plan import plan as ref_plan
from repro.graph import rmat_graph as ref_rmat
from repro_torch.core.coordinator import WorkerFailed
from repro_torch.core.plan import GraphMeta, plan as make_plan
from repro_torch.graph import rmat_graph

# the shapes here are tiny: one intra-op thread keeps torch's idle OpenMP
# workers from competing with the other test processes
torch.set_num_threads(1)

N_SHARDS = 3
EDGE_BLOCK = 32  # tests/test_equivalence.py's default
PAGERANK_TOL = 1e-6  # tests/test_engine.py:99, across modes
SOCKETS = {"transport": "sockets"}


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def graphs():
    kw = dict(scale=6, edge_factor=6, seed=5, weights="uniform")
    return ref_rmat(**kw), rmat_graph(**kw)


def _src(g):
    """Vertex 0's recoded id, the SSSP/BFS source."""
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
def test_matrix_socket_transport_matches_threads_and_files(graphs, tmp_path,
                                                           name):
    """The same algorithm run as THREE REAL OS PROCESSES and a coordinator
    process over loopback TCP is bit-identical to the single-process
    full-duplex streamed run of the SAME plan and to the file transport's
    processes run: values, active and message trajectories, aggregator and
    density, PageRank included (the worker folds through fold_groups and
    digests ascending source under both transports). Against the JAX
    package's threads run: integer programs exactly, PageRank within 1e-6.
    The socket run writes no announce markers: no shared-filesystem
    exchange."""
    g_ref, g = graphs
    ref_f, port_f, exact = ALGORITHMS[name]
    p = _plan(port_f(g), g)
    assert p.mode == "streamed" and p.pipeline
    assert p.config.channel.full_duplex and p.launch == "processes"
    runs = {}
    for label, kw in (("threads", {}),
                      ("files", dict(launch="processes")),
                      ("sockets", dict(launch="processes",
                                       launch_opts=SOCKETS))):
        with tc.GraphDJob(port_f(g), g, plan=copy.deepcopy(p), device="cpu",
                          workdir=str(tmp_path / label), **kw) as job:
            runs[label] = job.run(max_supersteps=60)
            if label == "sockets":
                assert job._last_run_recoveries == 0
                assert job._last_run_coord_restarts == 0
                net = job._last_run_net
                assert net["net_frames"] > 0 and net["net_wire_bytes"] > 0
                procs_dir = job._dir("procs", job._tag)
                assert not os.path.exists(os.path.join(procs_dir,
                                                       "announce"))
                assert os.path.isdir(os.path.join(procs_dir, "coord-wal"))
    rt, rs = runs["threads"], runs["sockets"]
    for label in ("threads", "files"):
        r = runs[label]
        assert rs.n_supersteps == r.n_supersteps, label
        for field in HISTORY_FIELDS:
            assert [getattr(x, field) for x in rs.history] == \
                   [getattr(x, field) for x in r.history], (label, field)
        assert rs.values == r.values, label  # bit-identical
    pr = ref_plan(ref_f(g_ref), RefMeta.of(g_ref),
                  rc.MemoryBudget(n_shards=N_SHARDS), edge_block=EDGE_BLOCK,
                  launch="processes")
    with rc.GraphDJob(ref_f(g_ref), g_ref, plan=pr,
                      workdir=str(tmp_path / "ref")) as jr:
        rr = jr.run(max_supersteps=60)
    assert rs.n_supersteps == rr.n_supersteps
    for field in ("n_active", "n_msgs", "density"):
        assert [getattr(x, field) for x in rs.history] == \
               [getattr(x, field) for x in rr.history], field
    assert rs.values.keys() == rr.values.keys() == rt.values.keys()
    if exact:
        assert rs.values == rr.values
    else:
        keys = sorted(rr.values)
        gap = np.abs(np.array([rs.values[k] for k in keys])
                     - np.array([rr.values[k] for k in keys])).max()
        assert gap < PAGERANK_TOL, gap


# --------------------------------------------------------------------------
# drills and failures under sockets
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plan_and_ref(graphs, tmp_path_factory):
    """tests/test_fault.py's processes plan, and the undisturbed threads
    run (checkpoint_every=2) the drill is held to."""
    _, g = graphs
    p = make_plan(tc.HashMin(), GraphMeta.of(g), tc.MemoryBudget(n_shards=3),
                  launch="processes")
    with tc.GraphDJob(tc.HashMin(), g, plan=copy.deepcopy(p), device="cpu",
                      workdir=str(tmp_path_factory.mktemp("ref")),
                      checkpoint_every=2) as ref:
        return p, ref.run()


def test_kill9_mid_frame_socket_transport_recovers(graphs, plan_and_ref,
                                                    tmp_path):
    """The victim SIGKILLs ITSELF with a run frame half-written on the wire
    (header + half payload). The peer's reader sees the torn frame,
    discards it, and waits; the respawned shard re-folds the step, the
    RESUME handshake replays from its outbox run-file log, duplicates are
    dropped by sequence, and the finished run is bit-identical to an
    undisturbed one."""
    _, g = graphs
    p, r_ref = plan_and_ref
    with tc.GraphDJob(tc.HashMin(), g, plan=copy.deepcopy(p), device="cpu",
                      workdir=str(tmp_path / "drill"), checkpoint_every=2,
                      launch="processes",
                      launch_opts={**SOCKETS,
                                   "kill_net": {"shard": 1, "step": 2,
                                                "after_frames": 1},
                                   "heartbeat_timeout": 5.0}) as drilled:
        r = drilled.run()
        assert drilled._last_run_recoveries == 1  # the drill really fired
        assert drilled._last_run_coord_restarts == 0
    assert r.n_supersteps == r_ref.n_supersteps
    assert [x.n_active for x in r.history] == \
           [x.n_active for x in r_ref.history]
    assert [x.n_msgs for x in r.history] == [x.n_msgs for x in r_ref.history]
    assert r.values == r_ref.values  # bit-identical after recovery


def test_worker_without_its_device_fails_loud_under_sockets(graphs,
                                                            plan_and_ref,
                                                            tmp_path):
    """Workers whose spec names CUDA, on a host with no card, register with
    the coordinator (before the torch import), then exit with a
    ``no-device`` failure record; the launcher turns that record into a
    WorkerFailed without a respawn, and stops the coordinator process."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    _, g = graphs
    p, _ = plan_and_ref
    job = tc.GraphDJob(tc.HashMin(), g, plan=copy.deepcopy(p), device="cpu",
                       workdir=str(tmp_path / "job"), checkpoint_every=2,
                       launch="processes", launch_opts=SOCKETS)
    try:
        job.device = torch.device("cuda")  # what the workers are told
        with pytest.raises(WorkerFailed, match="no cuda device") as ei:
            job.run()
        assert ei.value.record["kind"] == "no-device"
        assert ei.value.record["device"] == "cuda"
        assert job._last_run_recoveries == 0
        procs_dir = job._dir("procs", job._tag)
        with open(os.path.join(procs_dir, "spec.json")) as f:
            assert json.load(f)["device"] == "cuda"
        with open(os.path.join(procs_dir, "failure-summary.json")) as f:
            summary = json.load(f)
        assert summary["kind"] == "launch-failed"
        assert summary["record"]["kind"] == "no-device"
        # no result and no committed superstep: nothing ran on the CPU
        assert not os.path.isdir(os.path.join(procs_dir, "result"))
        assert not [n for n in os.listdir(os.path.join(procs_dir,
                                                       "coord-wal"))
                    if n.startswith("commit-")]
    finally:
        job.close()


def test_measured_link_throughput_prices_candidates(graphs):
    """The planner's measured companion of ``estimate_net``: a probe of the
    socket frame path prices every candidate's per-superstep NIC bytes in
    seconds (``Candidate.net_seconds``), explain() prints it, and the
    figure survives the JSON round trip (tests/test_plan.py's twin)."""
    from repro_torch.core.plan import (
        ExecutionPlan, estimate_net_seconds, measured_link_throughput,
    )

    _, g = graphs
    assert estimate_net_seconds(10 << 20, 10 << 20) == 1.0
    with pytest.raises(ValueError, match="positive"):
        estimate_net_seconds(1, 0.0)

    bw = measured_link_throughput(n_bytes=1 << 20)
    assert bw > 0  # loopback TCP through the frame path really moved bytes
    p = make_plan(tc.HashMin(), g, tc.MemoryBudget(n_shards=N_SHARDS),
                  edge_block=EDGE_BLOCK, launch="processes",
                  link_bytes_per_s=bw)
    chosen = next(c for c in p.alternatives if c.chosen)
    assert chosen.net_seconds == pytest.approx(chosen.net_total / bw)
    assert "at measured link" in p.explain()
    p2 = ExecutionPlan.from_json(p.to_json())
    assert [c.net_seconds for c in p2.alternatives] == \
           [c.net_seconds for c in p.alternatives]

    # without a probe the field stays 0.0 and explain() omits the pricing
    p0 = make_plan(tc.HashMin(), g, tc.MemoryBudget(n_shards=N_SHARDS),
                   edge_block=EDGE_BLOCK)
    assert all(c.net_seconds == 0.0 for c in p0.alternatives)
    assert "at measured link" not in p0.explain()
