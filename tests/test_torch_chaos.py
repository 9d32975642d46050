"""The port's chaos layer against the JAX package's, on the CPU: the retry
policy, the fault schedule and its injector, the failure records, the
``launch_opts`` validation, and fault injection into an edge-store spill.
Each case runs the same inputs through both packages and compares what
comes out: values, error type names and messages."""

import errno
import io
import os

import pytest

import repro.fault as ref_fault
import repro_torch.fault as port_fault
from repro.core import config as ref_config
from repro.graph import partition_graph_streamed as ref_streamed
from repro.graph import rmat_graph as ref_rmat
from repro_torch.core import config as port_config
from repro_torch.graph import partition_graph_streamed, rmat_graph


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raise", type name, message)`` of a call."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the type name is compared
        return ("raise", type(e).__name__, str(e))


# --------------------------------------------------------------------------
# retry policy
# --------------------------------------------------------------------------

POLICIES = {
    "default": {},
    "bounded": dict(max_attempts=4, base_delay=0.2, max_delay=1.0, seed=3),
    "no_jitter": dict(jitter=0.0, base_delay=0.5, max_delay=0.5),
    "full_jitter": dict(jitter=1.0, seed=11, deadline=5.0),
    "bad_attempts": dict(max_attempts=-1),
    "bad_delays": dict(base_delay=2.0, max_delay=1.0),
    "bad_deadline": dict(deadline=0),
    "bad_jitter": dict(jitter=1.5),
    "unknown_key": dict(retries=3),
}


@pytest.mark.parametrize("name", list(POLICIES))
def test_retry_policy_matches_reference(name):
    """The same options give the same policy, backoff delays and opts, or
    the same error."""
    def facts(mod):
        p = mod.RetryPolicy.from_opts(POLICIES[name])
        return (p.to_opts(),
                [p.delay_for(site, a) for site in ("coord-reconnect", "peer")
                 for a in range(1, 8)])

    assert _outcome(facts, port_fault) == _outcome(facts, ref_fault)


def test_retry_attempts_and_exhaustion_match_reference():
    """A bounded episode yields the same attempts, stops early on request,
    and its exhaustion summary is the reference's."""
    def facts(mod):
        p = mod.RetryPolicy(max_attempts=3, base_delay=1e-4, max_delay=1e-3)
        tries = list(p.attempts("site"))
        stopped = list(p.attempts("site", should_stop=lambda: True))
        err = mod.RetryExhausted("site", p, OSError(errno.ECONNREFUSED, "no"),
                                 attempts=len(tries), elapsed=0.25)
        return tries, stopped, str(err), err.summary(), \
            isinstance(err, ConnectionError)

    assert facts(port_fault) == facts(ref_fault)


# --------------------------------------------------------------------------
# fault schedule and injector
# --------------------------------------------------------------------------

SCHEDULES = {
    "none": None,
    "list": [{"site": "io.write.store", "kind": "eio", "after": 2}],
    "dict": {"seed": 7, "events": [
        {"site": "net.send", "kind": "delay", "seconds": 0.5, "dest": 1},
        {"site": "io.write.spill", "kind": "short", "shard": 1, "step": 3,
         "where": "outbox/", "once": False}]},
    "unknown_site": [{"site": "io.read", "kind": "eio"}],
    "bad_kind": [{"site": "io.write.ckpt", "kind": "bitflip"}],
    "negative_after": [{"site": "net.recv", "kind": "drop", "after": -1}],
    "unknown_event_key": [{"site": "net.recv", "kind": "drop", "when": 1}],
    "no_kind": [{"site": "net.recv"}],
    "unknown_schedule_key": {"seed": 1, "events": [], "rate": 0.1},
    "not_a_schedule": "eio",
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_schedule_matches_reference(name):
    """The same ``faults`` opts give the same schedule, or the same error."""
    def facts(mod):
        return mod.FaultSchedule.from_opts(SCHEDULES[name]).to_opts()

    assert _outcome(facts, port_fault) == _outcome(facts, ref_fault)


def _drive_injector(mod):
    """One schedule of every non-lethal file kind driven through the same
    sequence of site calls: what each call wrote or raised."""
    sched = mod.FaultSchedule.from_opts({"seed": 5, "events": [
        {"site": "io.write.store", "kind": "bitflip", "after": 1,
         "where": "w.bin"},
        {"site": "io.write.spill", "kind": "short", "shard": 2, "step": 4},
        {"site": "io.write.ckpt", "kind": "enospc", "once": False,
         "after": 1},
        {"site": "io.write.store", "kind": "eio", "where": "sp.bin"},
    ]})
    inj = mod.FaultInjector(sched, shard=2)
    calls = [("file_write", "io.write.store", "/s/w.bin", None),
             ("file_write", "io.write.store", "/s/w.bin", None),
             ("file_write", "io.write.store", "/s/w.bin", None),
             ("file_write", "io.write.spill", "/o/run", 3),
             ("file_write", "io.write.spill", "/o/run", 4),
             ("file_write", "io.write.store", "/s/sp.bin", None),
             ("check", "io.write.ckpt", "/c", 1),
             ("check", "io.write.ckpt", "/c", 1),
             ("check", "io.write.ckpt", "/c", 1),
             ("check", "io.write.ckpt", "/c", 1)]
    out = []
    for how, site, path, step in calls:
        fh = io.BytesIO()
        try:
            if how == "file_write":
                inj.file_write(fh, bytes(range(40)), site=site, path=path,
                               step=step)
            else:
                inj.check(site, path=path, step=step)
            out.append(("ok", fh.getvalue()))
        except OSError as e:
            out.append((type(e).__name__, e.errno, str(e), fh.getvalue()))
    return out, [(e.count, e.fired) for e in sched.events]


def test_injector_fires_like_reference():
    """The same schedule and calls: the same writes, torn writes, bit
    flips and errors, call by call, and the same event state after."""
    assert _drive_injector(port_fault) == _drive_injector(ref_fault)


def test_install_is_per_package():
    """Each package has its own process-global injector."""
    inj = port_fault.FaultInjector(port_fault.FaultSchedule())
    try:
        port_fault.install(inj)
        assert port_fault.active() is inj and ref_fault.active() is None
    finally:
        port_fault.clear()
    assert port_fault.active() is None


# --------------------------------------------------------------------------
# failure records
# --------------------------------------------------------------------------

def test_failure_records_match_reference(tmp_path):
    """``failure_record``, the bytes ``write_record`` publishes, and
    ``find_in_chain`` through a cause and a context, as the reference's."""
    def facts(mod, d):
        rec = mod.failure_record("disk-fault", shard=1, step=2,
                                 message="spill", tier="spill")
        path = os.path.join(d, "sub", "rec.json")
        mod.write_record(path, rec)
        with open(path, "rb") as f:
            blob = f.read()
        try:
            try:
                raise mod.BlobCorruption("/x/w.bin", "crc mismatch", "/x")
            except mod.BlobCorruption as inner:
                raise RuntimeError("channel") from inner
        except RuntimeError as e:
            try:
                raise ValueError("outer")
            except ValueError as outer:
                found = mod.find_in_chain(outer, mod.BlobCorruption)
                missing = mod.find_in_chain(e, mod.TierFault)
        tier = mod.TierFault("spill", 3, OSError(errno.ENOSPC, "full"))
        return (rec, blob, found.summary(), missing, tier.summary(),
                str(tier), os.listdir(os.path.dirname(path)))

    assert facts(port_fault, str(tmp_path / "port")) == \
        facts(ref_fault, str(tmp_path / "ref"))


# --------------------------------------------------------------------------
# launch_opts validation
# --------------------------------------------------------------------------

LAUNCH_OPTS = {
    "empty": ({}, "processes"),
    "none_threads": (None, "threads"),
    "threads": ({"heartbeat_timeout": 5.0}, "threads"),
    "timeouts": ({"heartbeat_interval": "0.5", "heartbeat_timeout": 3,
                  "send_timeout": 9}, "processes"),
    "unknown": ({"transport": "files", "speed": 1}, "processes"),
    "transport": ({"transport": "udp"}, "processes"),
    "not_seconds": ({"connect_timeout": "soon"}, "processes"),
    "zero_seconds": ({"handshake_timeout": 0}, "processes"),
    "heartbeat_order": ({"heartbeat_interval": 2.0,
                         "heartbeat_timeout": 1.0}, "processes"),
    "restart_limit": ({"coord_restart_limit": -1}, "processes"),
    "retry": ({"retry": {"max_attempts": 2, "deadline": 3.0}}, "processes"),
    "bad_retry": ({"retry": {"jitter": 2.0}}, "processes"),
    "faults": ({"faults": [{"site": "io.write.spill", "kind": "eio"}]},
               "processes"),
    "bad_faults": ({"faults": {"events": [{"site": "disk", "kind": "eio"}]}},
                   "processes"),
    "kill_files": ({"kill": {"shard": 1, "step": 2}}, "processes"),
    "kill_sockets": ({"transport": "sockets", "kill": {"shard": 1, "step": 2}},
                     "processes"),
    "coord_kill": ({"transport": "sockets",
                    "coord_kill": {"step": 2, "after_arrivals": 1}},
                   "processes"),
    "bad_coord_kill": ({"transport": "sockets", "coord_kill": {"shard": 1}},
                       "processes"),
}


def test_launch_opt_fields_match_reference():
    """The same documented keys with the same defaults."""
    assert ({k: v[0] for k, v in port_config.LAUNCH_OPT_FIELDS.items()}
            == {k: v[0] for k, v in ref_config.LAUNCH_OPT_FIELDS.items()})


@pytest.mark.parametrize("name", list(LAUNCH_OPTS))
def test_validate_launch_opts_matches_reference(name):
    """The same ``launch_opts`` give the same validated copy, or the same
    ``ConfigError``."""
    opts, launch = LAUNCH_OPTS[name]
    got = _outcome(port_config.validate_launch_opts, opts, launch)
    want = _outcome(ref_config.validate_launch_opts, opts, launch)
    assert got == want
    if got[0] == "raise":
        assert got[1] == "ConfigError"


# --------------------------------------------------------------------------
# a store spill under injected faults
# --------------------------------------------------------------------------

def _spill_under(mod, spill, g, d, events):
    """Spill ``g`` with ``events`` installed in ``mod``'s injector: the
    error it raised, or the store's ``verify_integrity()`` outcome and its
    files' bytes."""
    mod.install(mod.FaultInjector(mod.FaultSchedule.from_opts(
        {"seed": 9, "events": events})))
    try:
        *_, store = spill(g, 3, d)
    except OSError as e:
        return ("raise", type(e).__name__, e.errno,
                str(e).replace(d, "<dir>"))
    finally:
        mod.clear()
    try:
        store.verify_integrity()
        verdict = "intact"
    except mod.BlobCorruption as e:
        verdict = {k: v.replace(d, "<dir>") if isinstance(v, str) else v
                   for k, v in e.summary().items()}
    blobs = {}
    for name in ("sp.bin", "dp.bin", "w.bin", "manifest.json"):
        with open(os.path.join(store.dir, name), "rb") as f:
            blobs[name] = f.read()
    return ("ok", verdict, blobs)


STORE_FAULTS = {
    "bitflip": [{"site": "io.write.store", "kind": "bitflip", "after": 1,
                 "where": "w.bin"}],
    "enospc": [{"site": "io.write.store", "kind": "enospc", "after": 2,
                "where": "dp.bin"}],
    "short": [{"site": "io.write.store", "kind": "short", "where": "sp.bin"}],
}


@pytest.mark.parametrize("name", list(STORE_FAULTS))
def test_store_spill_faults_match_reference(tmp_path, name):
    """The store routes each write through its package's injector: a bit
    flip lands on the same byte and ``verify_integrity`` names the same
    file; a full disk or a torn write fails the spill with the same
    error."""
    kw = dict(scale=6, edge_factor=6, seed=2, weights="uniform")
    got = _spill_under(
        port_fault,
        lambda g, n, d: partition_graph_streamed(g, n, d, edge_block=32,
                                                 device="cpu"),
        rmat_graph(**kw), str(tmp_path / "port"), STORE_FAULTS[name])
    want = _spill_under(
        ref_fault,
        lambda g, n, d: ref_streamed(g, n, d, edge_block=32),
        ref_rmat(**kw), str(tmp_path / "ref"), STORE_FAULTS[name])
    assert got == want
    if name == "bitflip":
        assert got[1] != "intact" and got[1]["path"].endswith("w.bin")
    else:
        assert got[0] == "raise"
