"""Whole-process fault drills of the port's multi-process launch on the
CPU, twins of the file-transport drills in tests/test_fault.py: kill -9 of
one worker mid-superstep (respawned alone, bit-identical result), the same
without recovery wiring (fails loud), ENOSPC mid-spill and on the first
checkpoint dump, and a silent bit-flip in a logged run (quarantined and
replayed). Each fault fires through ``repro_torch.fault`` at the worker's
own sites. Plus the port's own guard: a worker told to run on CUDA that
finds no card fails with a ``no-device`` record, never on the CPU."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.coordinator import WorkerFailed
from repro_torch.core.plan import GraphMeta, plan as make_plan
from repro_torch.graph import rmat_graph

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def procs_graph():
    return rmat_graph(scale=6, edge_factor=6, seed=5, weights="uniform")


@pytest.fixture(scope="module")
def plan_and_ref(procs_graph, tmp_path_factory):
    """The processes plan of tests/test_fault.py's drills, and the
    undisturbed threads run (checkpoint_every=2) every drill is held to."""
    g = procs_graph
    p = make_plan(tc.HashMin(), GraphMeta.of(g), tc.MemoryBudget(n_shards=3),
                  launch="processes")
    with tc.GraphDJob(tc.HashMin(), g, plan=copy.deepcopy(p), device="cpu",
                      workdir=str(tmp_path_factory.mktemp("ref")),
                      checkpoint_every=2) as ref:
        return p, ref.run()


def _drill(g, p, workdir, opts, checkpoint_every=2):
    return tc.GraphDJob(tc.HashMin(), g, plan=copy.deepcopy(p), device="cpu",
                        workdir=workdir, checkpoint_every=checkpoint_every,
                        launch="processes",
                        launch_opts={"heartbeat_timeout": 5.0, **opts})


def _same_run(r, r_ref):
    assert r.n_supersteps == r_ref.n_supersteps
    assert [x.n_active for x in r.history] == \
           [x.n_active for x in r_ref.history]
    assert [x.n_msgs for x in r.history] == [x.n_msgs for x in r_ref.history]
    assert r.values == r_ref.values  # bit-identical after recovery


class TestProcessCrashDrill:
    """kill -9 a worker PROCESS mid-superstep: the coordinator detects the
    death, respawns just that shard with ``--recover-to``, the respawn
    replays forward from the latest checkpoint over its own message log,
    and the finished run is bit-identical to an undisturbed one."""

    def test_kill9_recovers_bit_identical(self, procs_graph, plan_and_ref,
                                          tmp_path):
        p, r_ref = plan_and_ref
        # SIGKILL shard 1 mid-superstep 2: after its outbox for the step is
        # announced, before it applies/arrives
        drilled = _drill(procs_graph, p, str(tmp_path / "drill"),
                         {"kill": {"shard": 1, "step": 2}})
        r = drilled.run()
        _same_run(r, r_ref)
        assert drilled._last_run_recoveries == 1  # exactly one respawn
        log = open(os.path.join(drilled._dir("procs", ""), "shard-1",
                                "worker.log")).read()
        assert log.count("Traceback") == 0  # killed, not crashed
        drilled.close()

    def test_kill9_without_recovery_wiring_fails_loud(self, procs_graph,
                                                      plan_and_ref, tmp_path):
        p, _ = plan_and_ref
        job = _drill(procs_graph, p, str(tmp_path / "bare"),
                     {"kill": {"shard": 2, "step": 1}}, checkpoint_every=None)
        with pytest.raises(WorkerFailed, match="checkpoint"):
            job.run()
        job.close()


class TestDiskFaultDrill:
    """Deterministic disk faults (``launch_opts["faults"]`` schedules)
    against the worker's storage tiers."""

    def test_enospc_mid_spill_fails_loud_no_torn_index(self, procs_graph,
                                                       plan_and_ref,
                                                       tmp_path):
        p, _ = plan_and_ref
        job = _drill(procs_graph, p, str(tmp_path / "bare"), {
            "faults": {"seed": 7, "events": [
                {"site": "io.write.spill", "kind": "enospc",
                 "shard": 1, "step": 1, "where": "outbox/"}]},
        }, checkpoint_every=None)
        with pytest.raises(WorkerFailed, match="spill") as ei:
            job.run()
        # the dying worker classified itself: the record names the tier
        rec = ei.value.record
        assert rec is not None
        assert rec["kind"] == "disk-fault"
        assert rec["tier"] == "spill"
        assert rec["shard"] == 1
        procs_dir = job._dir("procs", job._tag)
        # no torn outbox index: the un-announced src dir was swept
        assert not os.path.exists(
            os.path.join(procs_dir, "outbox", "step-000001", "src-1"))
        assert not os.path.exists(
            os.path.join(procs_dir, "announce", "step-000001", "src-1.json"))
        with open(os.path.join(procs_dir, "failure-summary.json")) as f:
            summary = json.load(f)
        assert summary["kind"] == "launch-failed"
        assert summary["record"]["tier"] == "spill"
        job.close()

    def test_enospc_first_checkpoint_recovers_bit_identical(
            self, procs_graph, plan_and_ref, tmp_path):
        p, r_ref = plan_and_ref
        # ENOSPC on worker 2's shard dump for the FIRST checkpoint (step
        # 2): nothing is checkpointed yet, so the respawn must replay the
        # whole prefix from the log on the bootstrap state
        drilled = _drill(procs_graph, p, str(tmp_path / "drill"), {
            "faults": [{"site": "io.write.ckpt", "kind": "enospc",
                        "shard": 2, "step": 2}],
        })
        r = drilled.run()
        _same_run(r, r_ref)
        assert drilled._last_run_recoveries == 1  # the drill really fired
        ckpt_dir = drilled.checkpointer.dir
        assert not [n for n in os.listdir(ckpt_dir) if n.startswith(".tmp")]
        drilled.close()

    def test_bitflip_in_spilled_blob_quarantined_and_replayed(
            self, procs_graph, plan_and_ref, tmp_path):
        p, r_ref = plan_and_ref
        # flip ONE bit in shard 1's message-log copy at step 1; the write
        # succeeds silently (the CRC is of the pristine bytes), and the
        # same step's digest reads it back
        drilled = _drill(procs_graph, p, str(tmp_path / "drill"), {
            "faults": {"seed": 41, "events": [
                {"site": "io.write.spill", "kind": "bitflip",
                 "shard": 1, "step": 1, "where": "logs/"}]},
        })
        r = drilled.run()
        _same_run(r, r_ref)
        assert drilled._last_run_recoveries == 1  # detection really fired
        q = os.path.join(drilled._dir("logs", drilled._tag), "shard-1",
                         "step-000001.quarantine")
        assert os.path.isdir(q)
        drilled.close()


def test_worker_without_its_device_fails_loud(procs_graph, plan_and_ref,
                                              tmp_path):
    """A worker whose spec names CUDA, on a host with no card, exits with
    a ``no-device`` failure record (after its first heartbeat) and never
    runs on the CPU; the launcher turns that record into a WorkerFailed
    without a respawn."""
    from repro_torch.launch import procs

    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    p, _ = plan_and_ref
    job = _drill(procs_graph, p, str(tmp_path / "job"), {})
    pd = job._dir("procs", "")
    os.makedirs(pd)
    procs._write_spec(job, pd, os.path.join(pd, "coord"), start_step=0,
                      target=3, bootstrap="init", ckpt_step=None,
                      heartbeat_interval=0.25, heartbeat_timeout=10.0)
    spec_path = os.path.join(pd, procs.SPEC)
    with open(spec_path) as f:
        spec = json.load(f)
    assert spec["device"] == "cpu"
    spec["device"] = "cuda"
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.procs",
                          "worker", pd, "0"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 4, out.stderr
    rec = procs._read_failure(pd, 0)
    assert rec["kind"] == "no-device" and rec["device"] == "cuda"
    assert rec["shard"] == 0
    # it beat before failing, and it wrote no step record and no result
    assert os.path.exists(os.path.join(pd, "coord", "heartbeat", "0.json"))
    assert not os.path.exists(procs._result_path(pd, 0))
    assert not os.path.exists(procs._outbox_dir(pd, 0, 0))
    assert "found no cuda device" in procs._describe_exit(rec, 4, 0)
    # the launcher's side: a no-device exit is not respawned
    job.device = torch.device("cuda")
    with pytest.raises(WorkerFailed, match="no cuda device") as ei:
        job.run()
    assert ei.value.record["kind"] == "no-device"
    assert job._last_run_recoveries == 0
    job.close()
