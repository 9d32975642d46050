"""kill -9 of the COORDINATOR process mid-barrier under the port's socket
transport, on the CPU, for every algorithm of the equivalence matrix: the
twin of ``TestCoordinatorKillDrill`` in tests/test_fault.py. Arrivals are
in, the commit is not yet in the write-ahead log; the launcher respawns
the coordinator with a bumped incarnation, the successor restores the
committed steps and peer addresses from its WAL, the workers reconnect
through the incarnation-stamped address file and replay their pending
arrivals, and the finished run is bit-identical to an undisturbed one,
with one coordinator respawn and no worker respawn."""

import copy

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.plan import GraphMeta, plan as make_plan
from repro_torch.graph import rmat_graph

torch.set_num_threads(1)

N_SHARDS = 3
EDGE_BLOCK = 32  # tests/test_equivalence.py's default


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def drill_graph():
    return rmat_graph(scale=6, edge_factor=6, seed=5, weights="uniform")


def _src(g):
    """Vertex 0's recoded id, the SSSP/BFS source."""
    from repro_torch.graph.recode import recode_ids

    rmap = recode_ids(g.vertex_ids, N_SHARDS)
    return int(rmap.to_new(np.array([int(g.vertex_ids[0])]))[0])


#: the equivalence matrix's programs, each a factory of the graph
ALGORITHMS = {
    "pagerank": lambda g: tc.PageRank(supersteps=5),
    "hashmin": lambda g: tc.HashMin(),
    "sssp": lambda g: tc.SSSP(_src(g)),
    "bfs": lambda g: tc.BFS(_src(g)),
    "degreesum": lambda g: tc.DegreeSum(),
    "labelspread": lambda g: tc.LabelSpread(),
    "distinct": lambda g: tc.DistinctInLabels(n_groups=8, rounds=2),
    "secondmin": lambda g: tc.SecondMinLabel(),
}


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_kill9_coordinator_mid_barrier_recovers_bit_identical(
        drill_graph, tmp_path, name):
    g = drill_graph
    factory = ALGORITHMS[name]
    p = make_plan(factory(g), GraphMeta.of(g),
                  tc.MemoryBudget(n_shards=N_SHARDS), edge_block=EDGE_BLOCK,
                  launch="processes")
    with tc.GraphDJob(factory(g), g, plan=copy.deepcopy(p), device="cpu",
                      workdir=str(tmp_path / "ref")) as ref:
        r_ref = ref.run(max_supersteps=60)
    # kill as late as the algorithm allows: step 1 proves the WAL commit
    # restore too; single-superstep programs (degreesum) get killed inside
    # their only barrier
    kill_step = 1 if r_ref.n_supersteps > 1 else 0
    with tc.GraphDJob(
            factory(g), g, plan=copy.deepcopy(p), device="cpu",
            workdir=str(tmp_path / "drill"), checkpoint_every=2,
            launch="processes",
            # SIGKILL the coordinator mid-barrier, after at least one
            # arrival is in (the commit never hits the WAL)
            launch_opts={"transport": "sockets",
                         "coord_kill": {"step": kill_step,
                                        "after_arrivals": 1},
                         "heartbeat_timeout": 5.0}) as drilled:
        r_drill = drilled.run(max_supersteps=60)
        # the drill really fired: one coordinator respawn, zero worker
        # respawns: the workers rode out the outage on their retry policy
        assert drilled._last_run_coord_restarts == 1
        assert drilled._last_run_recoveries == 0
    assert r_drill.n_supersteps == r_ref.n_supersteps, name
    for field in ("n_active", "n_msgs", "agg"):
        assert [getattr(x, field) for x in r_drill.history] == \
               [getattr(x, field) for x in r_ref.history], (name, field)
    assert r_drill.values == r_ref.values, name  # bit-identical
