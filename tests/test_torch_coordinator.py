"""The port's file-based coordinator (``repro_torch/core/coordinator.py``):
twins of tests/test_coordinator.py (barriers with stragglers, backoff,
shard-ascending reduction, heartbeat liveness of a SIGKILLed process, the
abort poison pill, and the restarted socket coordinator's boot grace), the
worker's import path kept free of torch, triton, jax and ``repro`` (by a
cold import and by ``repro.analysis``'s import-hygiene pass, whose roots
include the socket transport), and coordinator directories crossed between
the two packages."""

import ast
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import repro.core.coordinator as ref_coord
from repro_torch.core.coordinator import (
    FileCoordinator, RunAborted, atomic_write_json, read_json,
)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
DEADLINE = 10.0  # seconds any wait below may take before the test fails


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture
def coord(tmp_path):
    return FileCoordinator(str(tmp_path / "coord"), 3,
                           heartbeat_interval=0.05, heartbeat_timeout=0.5)


class TestBarrier:
    def test_wait_arrivals_with_straggler(self, coord):
        """The barrier stays open until the LAST worker arrives — two fast
        workers plus one straggler that lands 10 poll ticks later."""
        stats = dict(n_active=1, n_msgs=2, agg=0.5, active_blocks=1)
        coord.arrive(0, 0, stats)
        coord.arrive(0, 2, stats)

        def straggler():
            time.sleep(10 * FileCoordinator.POLL)
            coord.arrive(0, 1, dict(stats, n_active=7))

        ticks = []
        t = threading.Thread(target=straggler)
        t.start()
        got = coord.wait_arrivals(0, on_wait=lambda g: ticks.append(len(g)))
        t.join()
        assert set(got) == {0, 1, 2}
        assert got[1]["n_active"] == 7
        # the on_wait hook really ran while the straggler was missing
        assert ticks and all(n == 2 for n in ticks)

    def test_commit_round_trip_and_worker_wait(self, coord):
        totals = dict(n_active=3, n_msgs=9, agg=1.25, active_blocks=4)
        published = coord.publish_commit(2, totals, halt=False,
                                         ckpt_landed=True)
        got = coord.wait_commit(2, shard=1)
        assert got == published
        assert got["halt"] is False and got["ckpt_landed"] is True
        assert got["n_active"] == 3 and got["agg"] == 1.25
        assert coord.commit(3) is None  # non-blocking probe

    def test_wait_file_sees_marker(self, coord, tmp_path):
        marker = str(tmp_path / "announce.json")

        def publish():
            time.sleep(5 * FileCoordinator.POLL)
            atomic_write_json(marker, dict(ok=True))

        t = threading.Thread(target=publish)
        t.start()
        coord.wait_file(marker, shard=0)  # returns instead of hanging
        t.join()
        assert read_json(marker) == dict(ok=True)

    def test_gc_steps(self, coord):
        for s in range(4):
            coord.arrive(s, 0, dict(n_active=0, n_msgs=0, agg=0.0))
        coord.gc_steps(before=3)
        assert coord.arrivals(2) == {}
        assert 0 in coord.arrivals(3)


class TestBarrierBackoff:
    def test_poll_delays_start_fast_and_cap(self, coord):
        delays = coord._poll_delays()
        seq = [next(delays) for _ in range(16)]
        assert seq[0] == FileCoordinator.POLL
        assert all(b >= a for a, b in zip(seq, seq[1:]))
        assert seq[-1] == FileCoordinator.POLL_MAX
        assert max(seq) == FileCoordinator.POLL_MAX
        # one generator per wait: a fresh wait starts fast again
        assert next(coord._poll_delays()) == FileCoordinator.POLL

    def test_wait_commit_poll_count_ceiling(self, coord, monkeypatch):
        """A commit that lands after one (simulated) second of blocking
        costs ~a dozen polls, not the 200 of a fixed POLL spin."""
        import repro_torch.core.coordinator as mod

        clock = [0.0]
        polls = []

        def fake_sleep(d):
            polls.append(d)
            clock[0] += d
            if clock[0] >= 1.0 and coord.commit(0) is None:
                coord.publish_commit(
                    0, dict(n_active=0, n_msgs=0, agg=0.0, active_blocks=0),
                    halt=True, ckpt_landed=False)

        monkeypatch.setattr(mod.time, "sleep", fake_sleep)
        rec = coord.wait_commit(0, shard=0)
        assert rec["halt"] is True
        assert sum(polls) >= 1.0
        assert len(polls) <= 25, len(polls)


class TestReduction:
    def test_reduce_matches_threaded_accumulation(self):
        """Shard-ascending, int/int/Python-float left fold: the threaded
        driver's loop, so committed totals are bit-identical."""
        per_shard = [
            dict(n_active=5, n_msgs=17, agg=0.1, active_blocks=2),
            dict(n_active=0, n_msgs=3, agg=1e-17, active_blocks=0),
            dict(n_active=2, n_msgs=8, agg=0.3, active_blocks=1),
        ]
        arrivals = {2: per_shard[2], 0: per_shard[0], 1: per_shard[1]}
        got = FileCoordinator.reduce_arrivals(arrivals)
        n_active = n_msgs = 0
        agg = 0.0
        for rec in per_shard:
            n_active += int(rec["n_active"])
            n_msgs += int(rec["n_msgs"])
            agg += float(rec["agg"])
        assert got["n_active"] == n_active
        assert got["n_msgs"] == n_msgs
        assert got["agg"] == agg
        assert got["active_blocks"] == 3
        # and the reference's reduction of the same arrivals, key for key
        assert got == ref_coord.FileCoordinator.reduce_arrivals(arrivals)

    def test_float_fold_order_is_shard_ascending(self):
        a, b, c = 0.1, 0.2, 0.3
        arrivals = {w: dict(n_active=0, n_msgs=0, agg=v)
                    for w, v in enumerate((a, b, c))}
        assert FileCoordinator.reduce_arrivals(arrivals)["agg"] == (a + b) + c


class TestLiveness:
    def test_heartbeat_daemon_keeps_fresh(self, coord):
        t = coord.start_heartbeat(0)
        try:
            time.sleep(0.2)
            assert coord.heartbeat_age(0) < 0.5
            assert not coord.stale(0)
        finally:
            t.stop.set()

    def test_missing_heartbeat_is_stale(self, coord):
        assert coord.heartbeat_age(2) == float("inf")
        assert coord.stale(2)

    def test_frozen_mtime_with_progress_stays_fresh(self, coord):
        """Staleness is judged from the record's sequence progress, never
        the file's mtime (frozen at the epoch here)."""
        hb = coord.heartbeat_path(0)
        coord.beat(0)
        os.utime(hb, (0, 0))
        assert coord.heartbeat_age(0) == 0.0
        for _ in range(3):
            time.sleep(0.01)
            coord.beat(0)
            os.utime(hb, (0, 0))
            assert coord.heartbeat_age(0) == 0.0
        assert not coord.stale(0)

    def test_fresh_mtime_without_progress_goes_stale(self, coord):
        coord.beat(1)
        rec = read_json(coord.heartbeat_path(1))
        assert coord.heartbeat_age(1) == 0.0
        time.sleep(0.05)
        atomic_write_json(coord.heartbeat_path(1), rec)
        assert coord.heartbeat_age(1) >= 0.05

    def test_restarted_coord_server_grants_boot_grace(self):
        """A successor CoordServer has seen NO beats at boot (every live
        worker looks beat-less until its reconnect lands): a never-seen
        shard only goes stale ``heartbeat_timeout + boot_grace`` after THIS
        server booted, and an explicit ``grant_grace`` (the respawn path)
        extends further."""
        from repro_torch.launch.net import CoordServer

        coord = CoordServer(3, heartbeat_timeout=0.1, boot_grace=0.3)
        try:
            # freshly booted: no worker has ever beaten, none is stale
            assert all(coord.heartbeat_age(w) == float("inf")
                       for w in range(3))
            assert not any(coord.stale(w) for w in range(3))
            time.sleep(0.15)  # past heartbeat_timeout, inside boot grace
            assert not any(coord.stale(w) for w in range(3))
            deadline = time.monotonic() + DEADLINE
            while not coord.stale(0):  # boot grace expires -> stale
                assert time.monotonic() < deadline, "boot grace never expired"
                time.sleep(0.02)
            # the respawn path's explicit grant waives staleness again
            coord.grant_grace(0, 30.0)
            assert not coord.stale(0)
            assert coord.stale(1)  # ...but only for the granted shard
        finally:
            coord.close()

    def test_sigkilled_worker_process_goes_stale(self, coord):
        """A separate OS process heartbeats through the shared directory;
        kill -9 stops the beats and the staleness probe flips."""
        p = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, time\n"
             "from repro_torch.core.coordinator import FileCoordinator\n"
             f"c = FileCoordinator({coord.dir!r}, 3, "
             "heartbeat_interval=0.05)\n"
             "c.start_heartbeat(1)\n"
             "time.sleep(60)\n"],
            env=_env(),
        )
        try:
            deadline = time.monotonic() + DEADLINE
            while coord.heartbeat_age(1) == float("inf"):
                assert time.monotonic() < deadline, "worker never beat"
                time.sleep(0.02)
            assert not coord.stale(1)
            p.kill()
            p.wait()
            deadline = time.monotonic() + DEADLINE
            while not coord.stale(1):
                assert time.monotonic() < deadline, "kill -9 never detected"
                time.sleep(0.02)
            assert coord.heartbeat_age(1) > coord.heartbeat_timeout
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()


class TestAbort:
    def test_abort_unblocks_commit_wait(self, coord):
        """The waiter sees the abort within a deadline (a waiting thread,
        not one poll right after the write)."""
        def poison():
            time.sleep(5 * FileCoordinator.POLL)
            coord.abort("drill")

        t = threading.Thread(target=poison)
        t.start()
        t0 = time.monotonic()
        with pytest.raises(RunAborted, match="drill"):
            coord.wait_commit(0, shard=1)  # no commit will ever land
        t.join()
        assert time.monotonic() - t0 < DEADLINE
        assert coord.aborted() == "drill"

    def test_abort_unblocks_marker_wait(self, coord, tmp_path):
        coord.abort("stop")
        with pytest.raises(RunAborted, match="stop"):
            coord.wait_file(str(tmp_path / "never.json"), shard=0)

    def test_read_json_partial_file_is_unpublished(self, tmp_path):
        p = str(tmp_path / "rec.json")
        with open(p, "w") as f:
            f.write('{"truncated": ')
        assert read_json(p) is None
        assert read_json(str(tmp_path / "absent.json")) is None


# --------------------------------------------------------------------------
# the worker's import path
# --------------------------------------------------------------------------

def test_worker_import_path_is_torch_free():
    """Workers start their heartbeat BEFORE any heavy import; that holds
    only if importing the launcher and the coordinator (and the package
    __init__s they run) loads no torch, triton, jax or JAX package."""
    subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import repro_torch.launch.procs\n"
         "import repro_torch.core.coordinator\n"
         "bad = sorted(m for m in sys.modules\n"
         "             if m.split('.')[0] in ('torch', 'triton', 'jax',\n"
         "                                    'jaxlib', 'repro'))\n"
         "assert not bad, bad\n"],
        check=True, env=_env(),
    )


#: the port's pre-heartbeat roots, and what they must not reach eagerly
#: (``repro`` matches the JAX package and its submodules, not repro_torch)
PORT_WORKER_ROOTS = ("repro_torch.launch.procs",
                     "repro_torch.core.coordinator",
                     "repro_torch.launch.net",
                     "repro_torch.launch.mesh")
PORT_FORBIDDEN = ("torch", "triton", "jax", "jaxlib", "repro")


def _port_module_name(path: str):
    """``repro.analysis.imports.module_name`` for the port's paths: the
    pass names modules from a ``repro`` path part, which the port's
    ``repro_torch`` tree does not have."""
    parts = path.replace("\\", "/").split("/")
    if "repro_torch" not in parts:
        return None
    parts = parts[parts.index("repro_torch"):]
    parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _hygiene(monkeypatch, root: str):
    from repro.analysis import imports
    from repro.analysis.base import AnalysisConfig, collect_sources

    monkeypatch.setattr(imports, "module_name", _port_module_name)
    sources = collect_sources([os.path.join(root, "repro_torch")], root=root)
    config = AnalysisConfig(worker_roots=PORT_WORKER_ROOTS,
                            forbidden_imports=PORT_FORBIDDEN)
    return imports.ImportHygienePass().run(sources, config)


def test_import_hygiene_pass_on_the_port(monkeypatch):
    """``repro.analysis``'s import-hygiene pass, run over the port with its
    worker roots: no eager chain reaches torch, triton, jax or repro."""
    found = _hygiene(monkeypatch, SRC)
    assert found == [], [f.message for f in found]


def test_import_hygiene_pass_sees_a_seeded_torch_import(monkeypatch,
                                                        tmp_path):
    """The same pass, over a copy of the port whose ``streams/__init__``
    imports torch eagerly (the regression the lazy inits prevent), names
    the chain from the launcher."""
    import shutil

    shutil.copytree(os.path.join(SRC, "repro_torch"),
                    str(tmp_path / "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    init = tmp_path / "repro_torch" / "streams" / "__init__.py"
    init.write_text("import torch\n" + init.read_text())
    ast.parse(init.read_text())
    found = _hygiene(monkeypatch, str(tmp_path))
    assert found and {f.detail for f in found} == {"torch"}
    assert any("repro_torch.streams" in f.message for f in found)


# --------------------------------------------------------------------------
# coordinator directories crossed between the packages
# --------------------------------------------------------------------------

PACKAGES = {"port": FileCoordinator, "ref": ref_coord.FileCoordinator}


def _drive(cls, directory: str):
    """One superstep's records: three arrivals, a commit, a heartbeat."""
    c = cls(directory, 3, heartbeat_interval=0.05, heartbeat_timeout=0.5)
    for w, (a, m, g) in enumerate(((5, 17, 0.1), (0, 3, 1e-17),
                                   (2, 8, 0.3))):
        c.arrive(4, w, dict(n_active=a, n_msgs=m, agg=g, active_blocks=w,
                            ckpt=False, blocks_read=w, cache_hits=0,
                            cache_evictions=0, blocks_skipped=1))
    totals = c.reduce_arrivals(c.arrivals(4))
    c.publish_commit(4, totals, halt=False, ckpt_landed=True)
    c.beat(1)
    return c


@pytest.mark.parametrize("writer,reader",
                         [("port", "ref"), ("ref", "port")])
def test_coordinator_directory_crosses_packages(tmp_path, writer, reader):
    """A directory one package's FileCoordinator wrote is read by the
    other's: the same arrivals, the same reduced totals, the same commit,
    a fresh heartbeat; the arrive and commit files hold the same bytes."""
    w_dir, r_dir = str(tmp_path / "w"), str(tmp_path / "r")
    _drive(PACKAGES[writer], w_dir)
    _drive(PACKAGES[reader], r_dir)
    rd = PACKAGES[reader](w_dir, 3, heartbeat_interval=0.05,
                          heartbeat_timeout=0.5)
    own = PACKAGES[reader](r_dir, 3)
    assert rd.arrivals(4) == own.arrivals(4)
    assert rd.reduce_arrivals(rd.arrivals(4)) == \
        own.reduce_arrivals(own.arrivals(4))
    assert rd.commit(4) == own.commit(4)
    assert rd.wait_commit(4, shard=0)["ckpt_landed"] is True
    assert rd.heartbeat_age(1) == 0.0  # first sighting counts as fresh
    for name in ["arrive-0.json", "arrive-1.json", "arrive-2.json",
                 "commit.json"]:
        with open(os.path.join(rd.step_dir(4), name), "rb") as f:
            got = f.read()
        with open(os.path.join(own.step_dir(4), name), "rb") as f:
            assert got == f.read(), name
    PACKAGES[writer](w_dir, 3).abort("crossed")
    with pytest.raises(Exception, match="crossed"):
        rd.check_abort()
    assert rd.aborted() == "crossed"


def test_coordinator_module_is_the_reference_copy():
    """The port's coordinator is the reference's, names and code: only the
    docstrings may differ."""
    def body(mod):
        tree = ast.parse(textwrap.dedent(open(mod.__file__).read()))
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                    and ast.get_docstring(node) is not None:
                node.body = node.body[1:]
        return ast.dump(tree)

    import repro_torch.core.coordinator as port_coord

    assert body(port_coord) == body(ref_coord)
