"""The port's socket transport (``repro_torch/launch/net.py``) on the CPU:
twins of every test in tests/test_net.py (framing, the run codec, the
coordinator plane, the data plane with its reconnect-with-resume handshake,
the link probes, send-failure episodes), and the two packages' transports
crossed: the same run bytes, frames and runs delivered from either
package's sender to the other's receiver, a coordinator client of one
package served by the other's server, and a write-ahead log written by one
package's server restored by the other's. Everything here is stdlib and
numpy: no torch, no jax, no engine. Every server, sender and client is
closed in a ``finally`` and every wait is bounded."""

import ast
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
import zlib

import numpy as np
import pytest

import repro.launch.net as ref_net
import repro_torch.launch.net as port_net
from repro.streams.msgstore import MessageRunStore as RefRunStore
from repro_torch.core.coordinator import RunAborted, atomic_write_json
from repro_torch.fault import RetryPolicy
from repro_torch.launch.net import (
    _HEADER,
    MAGIC,
    CoordClient,
    CoordServer,
    FrameError,
    K_ARRIVE,
    K_RUN,
    PeerSender,
    PeerServer,
    TornFrame,
    decode_run,
    encode_run,
    probe_file_throughput,
    probe_link_throughput,
    recv_frame,
    send_frame,
)
from repro_torch.streams.msgstore import MessageRunStore

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
DEADLINE = 10.0  # seconds any wait below may take before the test fails


# -- framing -------------------------------------------------------------------

class TestFraming:
    def test_round_trip(self):
        a, b = socket.socketpair()
        try:
            for kind, payload in [(K_RUN, b"hello"), (7, b""),
                                  (K_ARRIVE, b"\x00" * 4096)]:
                wire = send_frame(a, kind, payload)
                assert wire == _HEADER.size + len(payload)
                got_kind, got = recv_frame(b)
                assert got_kind == kind and got == payload
        finally:
            a.close()
            b.close()

    def test_crc_mismatch_is_frame_error(self):
        a, b = socket.socketpair()
        try:
            payload = b"payload bytes"
            hdr = _HEADER.pack(MAGIC, K_RUN, len(payload),
                               zlib.crc32(payload) ^ 0xDEAD)
            a.sendall(hdr + payload)
            with pytest.raises(FrameError, match="CRC"):
                recv_frame(b)
        finally:
            a.close()
            b.close()

    def test_bad_magic_is_frame_error(self):
        a, b = socket.socketpair()
        try:
            a.sendall(_HEADER.pack(0x12345678, K_RUN, 0, zlib.crc32(b"")))
            with pytest.raises(FrameError, match="magic"):
                recv_frame(b)
        finally:
            a.close()
            b.close()

    def test_torn_frame_on_eof_mid_payload(self):
        """Header + half the payload, then the peer dies: the reader raises
        TornFrame and the partial bytes never surface as a run."""
        a, b = socket.socketpair()
        try:
            payload = b"x" * 1000
            hdr = _HEADER.pack(MAGIC, K_RUN, len(payload),
                               zlib.crc32(payload))
            a.sendall(hdr + payload[: len(payload) // 2])
            a.close()  # SIGKILL's FIN
            with pytest.raises(TornFrame):
                recv_frame(b)
        finally:
            b.close()

    def test_eof_between_frames_is_torn(self):
        a, b = socket.socketpair()
        a.close()
        try:
            with pytest.raises(TornFrame):
                recv_frame(b)
        finally:
            b.close()


# -- run wire codec ------------------------------------------------------------

class TestRunCodec:
    def test_raw_run_round_trip(self):
        dp = np.array([0, 3, 3, 7, 12], np.int32)
        msg = np.array([1.5, -2.0, 0.25, 3.0, 9.0], np.float32)
        payload = encode_run(step=4, seq=2, tag=1, dp=dp, msg=msg, cnt=None)
        hdr, dp2, msg2, cnt2 = decode_run(payload)
        assert (hdr["step"], hdr["seq"], hdr["tag"]) == (4, 2, 1)
        assert cnt2 is None
        assert np.array_equal(dp2, dp)
        assert msg2.dtype == np.float32 and np.array_equal(msg2, msg)

    def test_combined_run_with_counts(self):
        dp = np.array([1, 5, 6], np.int32)
        msg = np.array([7, 8, 9], np.int64)
        cnt = np.array([2, 1, 4], np.int32)
        hdr, dp2, msg2, cnt2 = decode_run(
            encode_run(step=0, seq=0, tag=2, dp=dp, msg=msg, cnt=cnt))
        assert hdr["cnt"] is True
        assert np.array_equal(dp2, dp)
        assert msg2.dtype == np.int64 and np.array_equal(msg2, msg)
        assert np.array_equal(cnt2, cnt)  # counts are ALWAYS raw/exact

    def test_compressed_wire_formats_round_trip(self):
        """varint-delta on the sorted dp column + the lossless payload codec
        on the value column: smaller on the wire, bit-identical back."""
        dp = np.sort(np.random.default_rng(0).integers(
            0, 1 << 20, 500)).astype(np.int32)
        msg = np.random.default_rng(1).normal(size=500).astype(np.float32)
        raw = encode_run(step=1, seq=0, tag=0, dp=dp, msg=msg, cnt=None)
        packed = encode_run(step=1, seq=0, tag=0, dp=dp, msg=msg, cnt=None,
                            compress=True, scheme="lossless")
        hdr, dp2, msg2, _ = decode_run(packed)
        assert hdr["dp_enc"] and hdr["scheme"] == "lossless"
        assert np.array_equal(dp2, dp)
        assert msg2.tobytes() == msg.tobytes()  # bit-identical floats
        assert len(packed) < len(raw)

    def test_empty_run(self):
        hdr, dp, msg, cnt = decode_run(encode_run(
            step=0, seq=0, tag=0, dp=np.empty(0, np.int32),
            msg=np.empty(0, np.float32), cnt=None,
            compress=True, scheme="lossless"))
        assert hdr["n"] == 0 and dp.size == 0 and msg.size == 0


# -- coordinator plane ---------------------------------------------------------

def _register_all(server, n, client_cls=CoordClient, **kw):
    """Register ``n`` clients against ``server``; returns the clients
    (started, to be closed by the caller) and each one's peer table."""
    clients = []
    peers = [None] * n
    threads = []
    for w in range(n):
        c = client_cls(server.addr, w, **kw)
        clients.append(c)
        c.start()

        def reg(w=w, c=c):
            peers[w] = c.register(("127.0.0.1", 20000 + w))

        t = threading.Thread(target=reg, daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=DEADLINE)
    return clients, peers


def _wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + DEADLINE
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


class TestCoordPlane:
    def test_register_arrive_commit_abort(self):
        srv = CoordServer(2, heartbeat_timeout=5.0)
        srv.start()
        clients = []
        try:
            clients, peers = _register_all(srv, 2)
            # every worker got the full data-plane address table
            assert peers[0] == peers[1]
            assert [a[1] for a in peers[0]] == [20000, 20001]

            stats = dict(n_active=3, n_msgs=7, agg=0.5, active_blocks=1)
            clients[0].arrive(0, 0, stats)
            clients[1].arrive(0, 1, dict(stats, n_active=4))
            got = srv.wait_arrivals(0)
            assert set(got) == {0, 1} and got[1]["n_active"] == 4
            totals = srv.reduce_arrivals(got)
            assert totals["n_active"] == 7 and totals["agg"] == 1.0

            rec = srv.publish_commit(0, totals, halt=False, ckpt_landed=True)
            for c in clients:  # pushed, event-driven barrier
                assert c.wait_commit(0, c.shard) == rec

            # heartbeats flowed after registration
            _wait_for(lambda: srv.heartbeat_age(0) != float("inf"),
                      "no heartbeat arrived")
            assert not srv.stale(0)

            srv.abort("drill")
            with pytest.raises(RunAborted, match="drill"):
                clients[0].wait_commit(1, 0)
            # the pushed ABORT reaches the other client's reader thread in
            # its own time: wait for it with a deadline, then check
            _wait_for(lambda: clients[1].aborted() is not None,
                      "the abort never reached client 1")
            with pytest.raises(RunAborted, match="drill"):
                clients[1].check_abort()
        finally:
            for c in clients:
                c.close()
            srv.close()

    def test_vanished_coordinator_aborts_on_retry_exhaustion(self):
        """A dead coordinator is not an instant poison pill: the client
        retries under its RetryPolicy, and only an exhausted budget aborts,
        loudly, with a structured failure summary."""
        srv = CoordServer(1)
        srv.start()
        retry = RetryPolicy(max_attempts=3, base_delay=0.02, max_delay=0.05,
                            deadline=5.0)
        clients = []
        try:
            clients, _ = _register_all(srv, 1, retry=retry)
            srv.close()  # the coordinator dies for good
            with pytest.raises(RunAborted, match="retry budget exhausted"):
                clients[0].wait_commit(0, 0)
            assert clients[0].failure is not None
            assert clients[0].failure["kind"] == "retry-exhausted"
            assert clients[0].failure["attempts"] == 3
        finally:
            for c in clients:
                c.close()
            srv.close()

    def test_coordinator_restart_reconnects_and_resumes(self, tmp_path):
        """A coordinator with a WAL dies between a worker's arrival and the
        commit; a successor restores the WAL, the client rediscovers it
        through the address file, re-registers, and replays the stranded
        arrival: the barrier commits as if nothing happened."""
        wal = str(tmp_path / "coord-wal")
        addr_file = str(tmp_path / "coord-addr.json")
        srv = CoordServer(1, wal_dir=wal)
        atomic_write_json(addr_file,
                          dict(incarnation=0, addr=list(srv.addr)))
        srv.start()
        retry = RetryPolicy(base_delay=0.02, max_delay=0.1, deadline=30.0)
        client = CoordClient(shard=0, addr_file=addr_file, retry=retry)
        client.start()
        srv2 = None
        try:
            t = threading.Thread(
                target=lambda: client.register(("127.0.0.1", 20000)),
                daemon=True)
            t.start()
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
            stats = dict(n_active=1, n_msgs=0, agg=0.0, active_blocks=1)
            client.arrive(0, 0, stats)
            rec0 = srv.publish_commit(
                0, srv.reduce_arrivals(srv.wait_arrivals(0)),
                halt=False, ckpt_landed=False)
            assert client.wait_commit(0, 0) == rec0
            srv.close()  # SIGKILL stand-in: dies with step 1 in flight
            client.arrive(1, 0, stats)  # stranded; cached for replay
            srv2 = CoordServer(1, wal_dir=wal)
            assert srv2.last_commit_step() == 0  # WAL restored the commit
            atomic_write_json(addr_file,
                              dict(incarnation=1, addr=list(srv2.addr)))
            srv2.start()
            got = srv2.wait_arrivals(1)  # replayed after the reconnect
            assert set(got) == {0}
            srv2.publish_commit(1, srv2.reduce_arrivals(got),
                                halt=True, ckpt_landed=False)
            assert client.wait_commit(1, 0)["step"] == 1
            assert client.aborted() is None
        finally:
            client.close()
            srv.close()
            if srv2 is not None:
                srv2.close()


# -- data plane ----------------------------------------------------------------

P = 16


def _mk_sender(tmp_path, me, n, net=port_net, store_cls=MessageRunStore,
               **kw):
    def make_store(step):
        return store_cls(
            str(tmp_path / f"outbox-{me}" / f"step-{step:06d}"), n, P,
            np.dtype(np.float32), with_counts=True,
        )

    return net.PeerSender(me, n, make_store, **kw)


def _drain(server, step, src):
    runs = []
    server.read_source(step, src, lambda *a: runs.append(a), lambda: None)
    return runs


def _close_all(*resources):
    for r in resources:
        if r is not None:
            r.close()


class TestDataPlane:
    def test_send_receive_combined_runs(self, tmp_path):
        """One sender, two receivers (self-loop included): each run arrives
        in the sender's append_combined transform, bit-identical."""
        servers = [PeerServer(2, start_step=0) for _ in range(2)]
        sender = None
        try:
            for s in servers:
                s.start()
            sender = _mk_sender(tmp_path, 0, 2)
            sender.set_addrs([s.addr for s in servers])
            sender.start()
            sender.begin_step(0)
            rng = np.random.default_rng(3)
            A = rng.normal(size=P).astype(np.float32)
            cnt = rng.integers(0, 3, P).astype(np.int32)  # zeros drop out
            for dest in range(2):
                sender.send_combined(dest, A, cnt, tag=0)
            sender.end_step()
            sender.check_failed()
            for dest, srv in enumerate(servers):
                runs = _drain(srv, 0, 0)
                assert len(runs) == 1
                hdr, dp, msg, c = runs[0]
                nz = np.nonzero(cnt > 0)[0].astype(np.int32)
                assert hdr["tag"] == 0
                assert np.array_equal(dp, nz)
                assert msg.tobytes() == A[nz].tobytes()
                assert np.array_equal(c, cnt[nz])
        finally:
            _close_all(sender, *servers)

    def test_receiver_respawn_resume_replays_outbox(self, tmp_path):
        """Mid-step receiver death: runs already framed at the old address
        are NOT lost: the respawned receiver's RESUME says have=0 and the
        sender replays the whole backlog from its per-step outbox store, in
        the original append order."""
        srv = PeerServer(2, start_step=0)
        self_srv = PeerServer(2, start_step=0)
        sender = reborn = None
        try:
            srv.start()
            self_srv.start()
            sender = _mk_sender(tmp_path, 0, 2)
            sender.set_addrs([self_srv.addr, srv.addr])
            sender.start()
            sender.begin_step(0)
            batches = []
            rng = np.random.default_rng(4)
            for i in range(2):
                A = rng.normal(size=P).astype(np.float32)
                cnt = np.ones(P, np.int32)
                batches.append(A)
                sender.send_combined(1, A, cnt, tag=0)
            srv.close()  # receiver 1 dies with two runs in flight
            reborn = PeerServer(2, start_step=0)  # respawn: new port
            reborn.start()
            sender.update_addr(1, reborn.addr)
            A = rng.normal(size=P).astype(np.float32)
            batches.append(A)
            sender.send_combined(1, A, np.ones(P, np.int32), tag=0)
            sender.send_combined(0, batches[0], np.ones(P, np.int32), tag=0)
            sender.end_step()
            sender.check_failed()
            runs = _drain(reborn, 0, 0)
            assert [hdr["seq"] for hdr, *_ in runs] == [0, 1, 2]
            for (hdr, dp, msg, c), A in zip(runs, batches):
                assert msg.tobytes() == A.tobytes()  # replay == original
            assert len(_drain(self_srv, 0, 0)) == 1  # self-loop unaffected
        finally:
            _close_all(sender, srv, self_srv, reborn)

    def test_duplicate_frames_after_reconnect_are_discarded(self, tmp_path):
        """The other half of resume: a receiver that already appended runs
        reports have=k, and replayed frames with seq < k are dropped: the
        digest sees every run exactly once."""
        servers = [PeerServer(2, start_step=0) for _ in range(2)]
        sender = None
        t = None
        try:
            for s in servers:
                s.start()
            sender = _mk_sender(tmp_path, 0, 2)
            sender.set_addrs([s.addr for s in servers])
            sender.start()
            sender.begin_step(0)
            rng = np.random.default_rng(5)
            batches = [rng.normal(size=P).astype(np.float32)
                       for _ in range(3)]
            got = []
            t = threading.Thread(
                target=lambda: servers[1].read_source(
                    0, 0, lambda *a: got.append(a), lambda: None),
                daemon=True)
            t.start()
            sender.send_combined(1, batches[0], np.ones(P, np.int32), tag=0)
            sender.send_combined(1, batches[1], np.ones(P, np.int32), tag=0)
            _wait_for(lambda: len(got) >= 2,
                      "the receiver never appended both live frames")
            # force a reconnect: the handshake replays runs[have:] only
            sender.update_addr(1, servers[1].addr)
            sender.send_combined(1, batches[2], np.ones(P, np.int32), tag=0)
            sender.send_combined(0, batches[0], np.ones(P, np.int32), tag=0)
            sender.end_step()
            sender.check_failed()
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
            assert [hdr["seq"] for hdr, *_ in got] == [0, 1, 2]  # no dups
            for (hdr, dp, msg, c), A in zip(got, batches):
                assert msg.tobytes() == A.tobytes()
        finally:
            _close_all(sender, *servers)


# -- link probes ---------------------------------------------------------------

class TestProbes:
    def test_link_probe_measures_positive_throughput(self):
        bw = probe_link_throughput(n_bytes=1 << 20)
        assert bw > 0

    def test_file_probe_measures_positive_throughput(self, tmp_path):
        bw = probe_file_throughput(str(tmp_path), n_bytes=1 << 20)
        assert bw > 0
        assert not any(p.name == "probe.bin" for p in tmp_path.iterdir())


class TestSendFailureEpisode:
    """A peer that keeps ACCEPTING connections but never takes a frame must
    not livelock the reconnect->replay->fail cycle: the send failures
    themselves carry the budget, and any delivered frame resets it."""

    def _sender(self, max_attempts):
        from repro_torch.fault import RetryExhausted

        s = PeerSender(0, 2, make_store=None,
                       retry=RetryPolicy(max_attempts=max_attempts,
                                         base_delay=0.001, max_delay=0.002,
                                         deadline=30.0))
        return s, RetryExhausted

    def test_episode_exhausts_loud_with_site(self):
        s, RetryExhausted = self._sender(max_attempts=3)
        err = OSError(32, "broken pipe")
        s._note_send_failure(1, err)
        s._note_send_failure(1, err)
        with pytest.raises(RetryExhausted) as ei:
            s._note_send_failure(1, err)
        assert ei.value.site == "peer-send:0->1"
        assert ei.value.attempts == 3
        assert ei.value.summary()["kind"] == "retry-exhausted"

    def test_delivered_frame_resets_the_episode(self):
        s, _ = self._sender(max_attempts=3)
        err = OSError(32, "broken pipe")
        s._note_send_failure(1, err)
        s._note_send_failure(1, err)
        s._send_fail.pop(1, None)  # what a successful send does
        s._note_send_failure(1, err)  # a fresh episode: attempt 1 again
        assert s._send_fail[1][1] == 1

    def test_episodes_are_per_destination(self):
        s, RetryExhausted = self._sender(max_attempts=2)
        err = OSError(32, "broken pipe")
        s._note_send_failure(0, err)
        s._note_send_failure(1, err)  # dest 1's first failure: no raise
        with pytest.raises(RetryExhausted):
            s._note_send_failure(0, err)


# --------------------------------------------------------------------------
# the module, and its import path
# --------------------------------------------------------------------------

def test_net_module_is_the_reference_copy():
    """The port's net.py is the reference's, names and code: only the
    docstrings and the package its imports name may differ."""
    def body(mod, pkg):
        tree = ast.parse(textwrap.dedent(open(mod.__file__).read()))
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                    and ast.get_docstring(node) is not None:
                node.body = node.body[1:]
            if isinstance(node, ast.ImportFrom) and node.module:
                node.module = node.module.replace(pkg, "PKG", 1)
            if isinstance(node, ast.Import):
                for alias in node.names:
                    alias.name = alias.name.replace(pkg, "PKG", 1)
        return ast.dump(tree)

    assert body(port_net, "repro_torch") == body(ref_net, "repro")


def test_net_cold_import_is_stdlib_and_numpy():
    """Workers start their peer server and coordinator client BEFORE torch,
    and the coordinator process never imports it: a cold import of the
    transport loads no torch, triton, jax or JAX package."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import repro_torch.launch.net\n"
         "from repro_torch.launch import PeerServer, CoordClient\n"
         "bad = sorted(m for m in sys.modules\n"
         "             if m.split('.')[0] in ('torch', 'triton', 'jax',\n"
         "                                    'jaxlib', 'repro'))\n"
         "assert not bad, bad\n"],
        check=True, env=env, timeout=120,
    )


# --------------------------------------------------------------------------
# the two packages' transports crossed
# --------------------------------------------------------------------------

NETS = {"port": port_net, "ref": ref_net}
STORES = {"port": MessageRunStore, "ref": RefRunStore}
CROSSED = [("ref", "port"), ("port", "ref")]
CROSSED_IDS = ["ref-to-port", "port-to-ref"]

_rng = np.random.default_rng(11)
_DP = np.sort(_rng.integers(0, 1 << 20, 300)).astype(np.int32)
RUNS = {
    "raw_f32": dict(step=4, seq=2, tag=1, dp=_DP,
                    msg=_rng.normal(size=300).astype(np.float32), cnt=None),
    "combined_i64": dict(step=0, seq=0, tag=2, dp=_DP[:40],
                         msg=_rng.integers(-9, 9, 40).astype(np.int64),
                         cnt=_rng.integers(1, 5, 40).astype(np.int32)),
    "lossless": dict(step=7, seq=5, tag=0, dp=_DP,
                     msg=_rng.normal(size=300).astype(np.float32), cnt=None,
                     compress=True, scheme="lossless"),
    "empty": dict(step=0, seq=0, tag=0, dp=np.empty(0, np.int32),
                  msg=np.empty(0, np.float32), cnt=None, compress=True,
                  scheme="lossless"),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_encode_run_gives_the_reference_bytes(case):
    """Both packages frame a run into the same bytes, and each decodes the
    other's to the same header and arrays."""
    got = port_net.encode_run(**RUNS[case])
    want = ref_net.encode_run(**RUNS[case])
    assert got == want
    for dec in (port_net.decode_run, ref_net.decode_run):
        hdr, dp, msg, cnt = dec(want)
        assert hdr == ref_net.decode_run(want)[0]
        assert np.array_equal(dp, RUNS[case]["dp"])
        assert msg.dtype == RUNS[case]["msg"].dtype
        assert msg.tobytes() == RUNS[case]["msg"].tobytes()
        want_cnt = RUNS[case]["cnt"]
        assert (cnt is None) == (want_cnt is None)
        if want_cnt is not None:
            assert np.array_equal(cnt, want_cnt)


@pytest.mark.parametrize("sender_pkg,server_pkg", CROSSED, ids=CROSSED_IDS)
def test_peer_sender_delivers_across_packages(tmp_path, sender_pkg,
                                              server_pkg):
    """One package's PeerSender, its outbox in its own MessageRunStore,
    delivers combined runs to the other package's PeerServers (self-loop
    included): the HELLO/RESUME handshake, the frames and the runs are the
    same on both sides, and a forced reconnect replays no duplicate."""
    servers = [NETS[server_pkg].PeerServer(2, start_step=0)
               for _ in range(2)]
    sender = None
    try:
        for s in servers:
            s.start()
        sender = _mk_sender(tmp_path, 0, 2, net=NETS[sender_pkg],
                            store_cls=STORES[sender_pkg])
        sender.set_addrs([s.addr for s in servers])
        sender.start()
        sender.begin_step(0)
        rng = np.random.default_rng(6)
        batches = [(rng.normal(size=P).astype(np.float32),
                    rng.integers(0, 3, P).astype(np.int32))
                   for _ in range(3)]
        for A, cnt in batches[:2]:
            sender.send_combined(1, A, cnt, tag=0)
        sender.update_addr(1, servers[1].addr)  # reconnect + resume
        sender.send_combined(1, *batches[2], tag=0)
        sender.send_combined(0, *batches[0], tag=0)
        sender.end_step()
        sender.check_failed()
        runs = _drain(servers[1], 0, 0)
        assert [hdr["seq"] for hdr, *_ in runs] == [0, 1, 2]
        for (hdr, dp, msg, c), (A, cnt) in zip(runs, batches):
            nz = np.nonzero(cnt > 0)[0].astype(np.int32)
            assert np.array_equal(dp, nz)
            assert msg.tobytes() == A[nz].tobytes()
            assert np.array_equal(c, cnt[nz])
        assert len(_drain(servers[0], 0, 0)) == 1
    finally:
        _close_all(sender, *servers)


@pytest.mark.parametrize("client_pkg,server_pkg", CROSSED, ids=CROSSED_IDS)
def test_coord_client_registers_arrives_commits_across_packages(
        client_pkg, server_pkg):
    """One package's CoordClients register, beat, arrive and wait for the
    commit against the other package's CoordServer."""
    srv = NETS[server_pkg].CoordServer(2, heartbeat_timeout=5.0)
    clients = []
    try:
        srv.start()
        clients, peers = _register_all(
            srv, 2, client_cls=NETS[client_pkg].CoordClient)
        assert peers[0] == peers[1]
        assert [a[1] for a in peers[0]] == [20000, 20001]
        stats = dict(n_active=3, n_msgs=7, agg=0.25, active_blocks=1)
        for c in clients:
            c.arrive(0, c.shard, dict(stats, n_active=3 + c.shard))
        got = srv.wait_arrivals(0)
        totals = srv.reduce_arrivals(got)
        assert totals["n_active"] == 7 and totals["agg"] == 0.5
        rec = srv.publish_commit(0, totals, halt=True, ckpt_landed=False)
        for c in clients:
            assert c.wait_commit(0, c.shard) == rec
        _wait_for(lambda: srv.heartbeat_age(1) != float("inf"),
                  "no heartbeat arrived")
        assert not srv.stale(1)
    finally:
        for c in clients:
            c.close()
        srv.close()


def _drive_wal(pkg: str, wal: str) -> dict:
    """One coordinator's life: two workers register, two barriers commit,
    then an abort. Returns what a successor must restore."""
    srv = NETS[pkg].CoordServer(2, wal_dir=wal)
    clients = []
    try:
        srv.start()
        clients, _ = _register_all(srv, 2,
                                   client_cls=NETS[pkg].CoordClient)
        for s in range(2):
            for c in clients:
                c.arrive(s, c.shard, dict(n_active=2 - s, n_msgs=5,
                                          agg=0.5, active_blocks=1))
            srv.publish_commit(s, srv.reduce_arrivals(srv.wait_arrivals(s)),
                               halt=s == 1, ckpt_landed=s == 0,
                               extra=dict(seconds=0.125))
        srv.abort("drill over")
        return dict(commits={s: srv.commit(s) for s in range(2)},
                    addrs=dict(srv._addrs))
    finally:
        for c in clients:
            c.close()
        srv.close()


@pytest.mark.parametrize("writer,reader", CROSSED, ids=CROSSED_IDS)
def test_wal_written_by_one_package_restores_in_the_other(tmp_path, writer,
                                                          reader):
    """A WAL one package's CoordServer wrote (commits, the peer address
    table, the abort) is restored by the other package's CoordServer, and
    both packages write the same file names and the same records."""
    wal = str(tmp_path / "coord-wal")
    before = _drive_wal(writer, wal)
    succ = NETS[reader].CoordServer(2, wal_dir=wal)
    try:
        assert succ.last_commit_step() == 1
        for s in range(2):
            assert succ.commit(s) == before["commits"][s]
        assert succ._addrs == before["addrs"]
        assert succ._seen == {0, 1}
        assert succ.aborted() == "drill over"
        with pytest.raises(Exception, match="drill over"):
            succ.check_abort()
    finally:
        succ.close()
    other = str(tmp_path / "other-wal")
    _drive_wal(reader, other)
    assert sorted(os.listdir(wal)) == sorted(os.listdir(other))
    for name in sorted(os.listdir(wal)):
        with open(os.path.join(wal, name)) as f:
            got = json.load(f)
        with open(os.path.join(other, name)) as f:
            want = json.load(f)
        assert got == want, name
