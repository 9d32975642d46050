"""The port's mesh (``GraphDEngine(..., mesh=)`` over ``torch.distributed``,
``repro_torch.launch.mesh``) on the CPU: gloo ranks spawned as processes,
one a shard, held against the port's emulated one-process run and the JAX
reference's ``vmap`` run.

One mesh is spawned per world size and runs every case in turn (the
spawn, a torch import a rank, costs more than the cases). Twins of
tests/test_distributed.py's shard_map tests: all modes' PageRank (:29),
sparse SSSP (:57), the kernel backend (:87), the logged step with
checkpoints and recovery (:113), the ring against the logged all_to_all
(:221)."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.checkpoint as rckpt
import repro_torch.core as tc
from repro.graph import partition_graph, rmat_graph
from repro_torch import convert
from repro_torch.core.collectives import ProcessMesh
from repro_torch.graph.partition import (
    PartitionedGraph, load_shard_slice, shard_slice, write_shard_slice,
)
from repro_torch.launch.mesh import (
    CaseFiles, MeshFailed, run_mesh, run_mesh_cases,
)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
WORLD = (2, 4, 8)
SUPERSTEPS = 5
TIMEOUT = 120.0  # seconds a mesh may take before the run fails
SPARSE = dict(adapt_threshold=0.6, sparse_cap_frac=0.6)

#: case -> (program factory of the source vertex, EngineConfig kwargs)
CASES = {
    "pagerank-recoded-torch": (lambda s: tc.PageRank(SUPERSTEPS),
                               dict(backend="torch")),
    "pagerank-basic-torch": (lambda s: tc.PageRank(SUPERSTEPS),
                             dict(mode="basic", backend="torch")),
    "pagerank-basic_sc-torch": (lambda s: tc.PageRank(SUPERSTEPS),
                                dict(mode="basic_sc", backend="torch")),
    "pagerank-recoded-kernel": (lambda s: tc.PageRank(SUPERSTEPS),
                                dict(backend="kernel")),
    "hashmin-recoded-kernel": (lambda s: tc.HashMin(), dict(backend="kernel")),
    "sssp-recoded-kernel": (lambda s: tc.SSSP(s), dict(backend="kernel")),
    "bfs-recoded-kernel": (lambda s: tc.BFS(s), dict(backend="kernel")),
    "sssp-recoded-torch-sparse": (lambda s: tc.SSSP(s),
                                  dict(backend="torch", **SPARSE)),
    "bfs-recoded-torch-sparse": (lambda s: tc.BFS(s),
                                 dict(backend="torch", **SPARSE)),
    "hashmin-basic_sc-torch-sparse": (lambda s: tc.HashMin(),
                                      dict(mode="basic_sc", backend="torch",
                                           **SPARSE)),
    "hashmin-basic-torch": (lambda s: tc.HashMin(),
                            dict(mode="basic", backend="torch")),
    "pagerank-recoded_compact-torch": (lambda s: tc.PageRank(SUPERSTEPS),
                                       dict(mode="recoded_compact",
                                            backend="torch")),
    "distinct-basic-torch": (lambda s: tc.DistinctInLabels(n_groups=8,
                                                           rounds=2),
                             dict(mode="basic", backend="torch")),
    "secondmin-basic-torch": (lambda s: tc.SecondMinLabel(),
                              dict(mode="basic", backend="torch")),
}

#: case -> (program factory, CaseFiles fields): the logged step (every
#: superstep through a message log) with checkpoints, run after CASES in
#: this order, each world size in directories of its own. The resumed case
#: restarts the first from its step-4 checkpoint; "every2" is the twin of
#: tests/test_distributed.py:113; Hash-Min's is the logged half of :221.
LOGGED = {
    "pagerank-logged": (lambda: tc.PageRank(6),
                        dict(log="log", ckpt="ckpt", every=4,
                             save_initial=True)),
    "pagerank-logged-resumed": (lambda: tc.PageRank(6),
                                dict(log="log", ckpt="ckpt", every=4)),
    "pagerank-logged-every2": (lambda: tc.PageRank(6),
                               dict(log="log2", ckpt="ckpt2", every=2,
                                    save_initial=True)),
    "hashmin-logged": (tc.HashMin, dict(log="log3")),
}
LOGGED_CFG = dict(backend="torch")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _graph():
    return rmat_graph(scale=8, edge_factor=8, seed=3)


def _port_pg(pg):
    """The JAX package's partition, carried across to the port."""
    arrays = {f: np.asarray(getattr(pg, f)) for f in PartitionedGraph.TENSORS}
    static = {f: getattr(pg, f) for f in convert.STATIC}
    return convert.partition_from_arrays(arrays, static, device="cpu")


def _setup(n):
    """(JAX partition, the port's copy of it, SSSP/BFS source)."""
    g = _graph()
    pg, rmap = partition_graph(g, n_shards=n, edge_block=64)
    src = int(rmap.to_new(np.array([int(g.vertex_ids[0])]))[0])
    return pg, _port_pg(pg), src


def _cases(src):
    return [(make(src), tc.EngineConfig(**cfg))
            for make, cfg in CASES.values()]


def _files(root, fields):
    """CaseFiles with its directories under ``root``."""
    return CaseFiles(**{k: os.path.join(root, v) if k in ("log", "ckpt")
                        else v for k, v in fields.items()})


def _logged_cases(root):
    return [(make(), tc.EngineConfig(**LOGGED_CFG), _files(root, fields))
            for make, fields in LOGGED.values()]


def _emulated(tpg, program, config):
    (v, a), hist = tc.GraphDEngine(tpg, program, config, device="cpu").run()
    return v, a, hist


def _emulated_logged(tpg, root):
    """The LOGGED cases in order on the emulated engine, with an
    unmeshed MessageLog and Checkpointer in ``root``: {case: (v, a,
    history)}."""
    out = {}
    for case, (program, config, files) in zip(LOGGED, _logged_cases(root)):
        log = tc.MessageLog(files.log) if files.log else None
        ck = (tc.Checkpointer(files.ckpt, files.every, files.keep)
              if files.ckpt else None)
        eng = tc.GraphDEngine(tpg, program, config, device="cpu",
                              message_log=log)
        if files.save_initial:
            ck.save(0, *eng.init())
        (v, a), hist = eng.run(checkpointer=ck)
        out[case] = (v, a, hist)
    return out


def _stats(hist):
    return [(h.step, h.n_active, h.n_msgs, h.mode, h.agg, h.density)
            for h in hist]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """world size -> (port partition, source, MeshRun of every case, the
    directory of the logged cases' files), run once each."""
    runs = {}

    def get(n):
        if n not in runs:
            _, tpg, src = _setup(n)
            root = str(tmp_path_factory.mktemp(f"mesh{n}"))
            runs[n] = (tpg, src, run_mesh_cases(
                tpg, _cases(src) + _logged_cases(root), device="cpu",
                timeout=TIMEOUT), root)
        return runs[n]
    return get


@pytest.fixture(scope="module")
def emulated_logged(tmp_path_factory):
    """world size -> (the LOGGED cases' emulated results, their files'
    directory)."""
    runs = {}

    def get(n):
        if n not in runs:
            root = str(tmp_path_factory.mktemp(f"emulated{n}"))
            runs[n] = (_emulated_logged(_setup(n)[1], root), root)
        return runs[n]
    return get


def _result(run, case):
    return run.results[(list(CASES) + list(LOGGED)).index(case)]


# --------------------------------------------------------------------------
# the mesh against the emulated run: bit-identical
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", WORLD)
def test_mesh_equals_emulated(meshes, n, case):
    """Values, active bitmaps, every superstep's stats (the aggregator and
    the dense/sparse decision too) and the halt step, bit for bit."""
    tpg, src, run, _ = meshes(n)
    res = _result(run, case)
    make, cfg = CASES[case]
    v, a, hist = _emulated(tpg, make(src), tc.EngineConfig(**cfg))
    assert res.values.dtype == v.dtype and res.values.shape == v.shape
    assert torch.equal(res.values, v)
    assert torch.equal(res.active, a)
    assert _stats(res.history) == _stats(hist)
    if case.startswith("pagerank"):
        # the reference's own bound between shard_map and vmap (:52)
        assert float((res.values - v).abs().max()) < 1e-7
    assert all(r["launches"] == dict(edge_combine=0, digest=0, run_sum=0)
               for r in res.ranks)  # the CPU runs the plain versions


def _a2a_model(case, tpg, n):
    """(ring, all_to_all) bytes a rank hands its backend a superstep."""
    if "-basic-" in case:  # a payload and a destination an edge slot
        return 0, n * tpg.E_cap * 8
    if "-recoded_compact-" in case:  # a bf16 value and an int8 flag a slot
        return 0, n * tpg.P * 3
    if "-logged" in case:  # a float32 value and an int32 count a slot
        return 0, n * tpg.P * 8
    return (n - 1) * tpg.P * 8, 0  # the ring: a value and a count


@pytest.mark.parametrize("n", WORLD)
def test_mesh_bytes_match_the_model(meshes, n):
    """What each rank hands the backend a superstep: the ring (n-1)·P·8
    bytes (value and count), basic's all_to_all n·E_cap·8 (payload and
    destination), recoded_compact's n·P·3 (a bf16 value and an int8 flag),
    the logged step's n·P·8 (a float32 value and an int32 count), five
    8-byte reductions, PageRank's 4-byte aggregator; nothing staged on the
    CPU, and a checkpoint's barriers uncounted."""
    tpg, _, run, _ = meshes(n)
    for case, res in zip(list(CASES) + list(LOGGED), run.results):
        steps = len(res.history)
        ring, a2a = _a2a_model(case, tpg, n)
        gather = 4 if case.startswith("pagerank") else 0
        want = dict(ring=ring * steps, all_to_all=a2a * steps,
                    gather=gather * steps, reduce=40 * steps, staged=0)
        assert all(r["bytes"] == want for r in res.ranks), (case, want)


@pytest.mark.parametrize("n", WORLD)
def test_sparse_sssp_twin(meshes, n):
    """tests/test_distributed.py:57: SSSP on the mesh with the sparse
    superstep on equals the emulated dense-only run (the port's config
    takes adapt_threshold in [0, 1]; 0 keeps every superstep dense). On 8
    ranks, the reference's configuration, the mesh takes the sparse
    superstep at least once (on 4 the groups are too long for the cap)."""
    tpg, src, run, _ = meshes(n)
    res = _result(run, "sssp-recoded-torch-sparse")
    v, a, hist = _emulated(tpg, tc.SSSP(src),
                           tc.EngineConfig(adapt_threshold=0,
                                           backend="torch"))
    assert torch.equal(res.values, v) and torch.equal(res.active, a)
    assert [(h.n_active, h.n_msgs) for h in res.history] == \
        [(h.n_active, h.n_msgs) for h in hist]
    assert {h.mode for h in hist} == {"dense"}
    if n == 8:
        assert "sparse" in {h.mode for h in res.history}


def test_kernel_backend_twin(meshes):
    """tests/test_distributed.py:87: the kernel backend on a 4-rank mesh
    (its plain versions here) within 1e-6 of the emulated torch backend."""
    tpg, _, run, _ = meshes(4)
    res = _result(run, "pagerank-recoded-kernel")
    v, _, _ = _emulated(tpg, tc.PageRank(SUPERSTEPS),
                        tc.EngineConfig(backend="torch"))
    assert float((res.values.double() - v.double()).abs().max()) < 1e-6


# --------------------------------------------------------------------------
# the mesh against the JAX reference's vmap run
# --------------------------------------------------------------------------

REF = {
    "pagerank-recoded-torch": (lambda s: rc.PageRank(SUPERSTEPS), {}),
    "pagerank-basic-torch": (lambda s: rc.PageRank(SUPERSTEPS),
                             dict(mode="basic")),
    "pagerank-basic_sc-torch": (lambda s: rc.PageRank(SUPERSTEPS),
                                dict(mode="basic_sc")),
    "hashmin-recoded-kernel": (lambda s: rc.HashMin(), {}),
    "sssp-recoded-kernel": (lambda s: rc.SSSP(s), {}),
    "bfs-recoded-kernel": (lambda s: rc.BFS(s), {}),
    "distinct-basic-torch": (lambda s: rc.DistinctInLabels(n_groups=8,
                                                           rounds=2),
                             dict(mode="basic")),
    "secondmin-basic-torch": (lambda s: rc.SecondMinLabel(),
                              dict(mode="basic")),
}


@pytest.mark.parametrize("case", list(REF))
def test_mesh_against_the_reference(meshes, case):
    """The 8-rank mesh against the reference's emulated (vmap) run of the
    same partition: PageRank within 1e-5 (tests/test_torch_engine.py),
    the rest exactly, with its superstep stats."""
    pg, _, src = _setup(8)
    _, _, run, _ = meshes(8)
    res = _result(run, case)
    make, cfg = REF[case]
    (v_ref, a_ref), h_ref = rc.GraphDEngine(
        pg, make(src), config=rc.EngineConfig(**cfg)).run()
    v_ref, a_ref = np.asarray(v_ref), np.asarray(a_ref)
    v = res.values.numpy()
    if case.startswith("pagerank"):
        assert np.abs(v.astype(np.float64) - v_ref).max() < 1e-5
    else:
        assert v.dtype == v_ref.dtype
        np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(res.active.numpy(), a_ref)
    assert [(h.n_active, h.n_msgs) for h in res.history] == \
        [(h.n_active, h.n_msgs) for h in h_ref]


# --------------------------------------------------------------------------
# the logged step, the message log and checkpoints on the mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(LOGGED))
@pytest.mark.parametrize("n", WORLD)
def test_logged_mesh_equals_emulated(meshes, emulated_logged, n, case):
    """Each logged case on the mesh against the same cases run in turn on
    the emulated engine with an unmeshed log and checkpointer: values,
    bitmaps and every superstep's stats (the step it resumed from too),
    bit for bit."""
    _, _, run, _ = meshes(n)
    res = _result(run, case)
    v, a, hist = emulated_logged(n)[0][case]
    assert torch.equal(res.values, v) and torch.equal(res.active, a)
    assert _stats(res.history) == _stats(hist)
    assert [h.restored_from for h in res.history] == \
        [h.restored_from for h in hist]
    assert all(r["launches"] == dict(edge_combine=0, digest=0, run_sum=0)
               for r in res.ranks)


def _tree(root):
    """{relative path: file} under ``root``."""
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("n", WORLD)
def test_mesh_files_equal_emulated(meshes, emulated_logged, n):
    """The message logs and checkpoints the ranks wrote, one file a shard,
    are the emulated engine's, file for file: the same names (stale steps
    collected alike), the same arrays bit for bit, the same manifests
    (n_shards the world size)."""
    mesh_root = meshes(n)[3]
    emu_root = emulated_logged(n)[1]
    got, want = _tree(mesh_root), _tree(emu_root)
    assert sorted(got) == sorted(want) and got
    for rel, path in want.items():
        if rel.endswith(".json"):
            with open(path) as a, open(got[rel]) as b:
                assert json.load(a) == json.load(b), rel
            continue
        with np.load(path) as a, np.load(got[rel]) as b:
            assert sorted(a.files) == sorted(b.files), rel
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (rel, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=rel)
    with open(os.path.join(mesh_root, "ckpt", "step-000004",
                           "manifest.json")) as fh:
        assert json.load(fh)["n_shards"] == n


@pytest.mark.parametrize("n", WORLD)
def test_resumed_mesh_run_equals_the_live_run(meshes, n):
    """A case restarted on the mesh from the live case's step-4 checkpoint
    (each rank restoring its own shard) runs supersteps 4 and 5 and ends
    bit-identical to the live run."""
    _, _, run, _ = meshes(n)
    live = _result(run, "pagerank-logged")
    resumed = _result(run, "pagerank-logged-resumed")
    assert [h.step for h in resumed.history] == [4, 5]
    assert resumed.history[0].restored_from == 4
    assert live.history[0].restored_from == 0
    assert torch.equal(resumed.values, live.values)
    assert torch.equal(resumed.active, live.active)
    assert _stats(resumed.history) == _stats(live.history)[4:]


@pytest.mark.parametrize("n", WORLD)
def test_recover_shard_from_what_the_mesh_wrote(meshes, n):
    """recover_shard in this process, on the whole partition, from the
    mesh's step-4 checkpoint and its logs of supersteps 4 and 5: the last
    shard equals the live mesh run's within the reference's 1e-6, its
    bitmap exactly."""
    tpg, _, run, root = meshes(n)
    live = _result(run, "pagerank-logged")
    failed = n - 1
    ck = tc.Checkpointer(os.path.join(root, "ckpt"), every=4)
    assert ck.latest() == 4
    vj, aj = tc.recover_shard(tpg, tc.PageRank(6), failed, ck,
                              tc.MessageLog(os.path.join(root, "log")), 6)
    assert float((vj - live.values[failed]).abs().max()) < 1e-6
    assert torch.equal(aj, live.active[failed])


def test_logged_mode_and_recovery_twin(meshes):
    """tests/test_distributed.py:113 on 4 gloo ranks: logged PageRank with
    a checkpoint every 2 after a step-0 save equals the unlogged run, and
    shard 3 recovered from the mesh's files is within 1e-6 of it."""
    tpg, _, run, root = meshes(4)
    res = _result(run, "pagerank-logged-every2")
    v_ref, _, _ = _emulated(tpg, tc.PageRank(6),
                            tc.EngineConfig(backend="torch"))
    assert torch.allclose(res.values, v_ref)
    vj, _ = tc.recover_shard(tpg, tc.PageRank(6), 3,
                             tc.Checkpointer(os.path.join(root, "ckpt2"),
                                             every=2),
                             tc.MessageLog(os.path.join(root, "log2")), 6)
    assert float((vj - v_ref[3]).abs().max()) < 1e-6


@pytest.mark.parametrize("n", WORLD)
def test_ring_equals_logged_twin(meshes, n):
    """tests/test_distributed.py:221: on the mesh, Hash-Min over the ring
    and over the logged all_to_all give the same labels, bitmaps and
    superstep stats."""
    _, _, run, _ = meshes(n)
    ring = _result(run, "hashmin-recoded-kernel")
    logged = _result(run, "hashmin-logged")
    assert torch.equal(ring.values, logged.values)
    assert torch.equal(ring.active, logged.active)
    assert [(h.n_active, h.n_msgs) for h in ring.history] == \
        [(h.n_active, h.n_msgs) for h in logged.history]


@pytest.mark.parametrize("n", WORLD)
def test_reference_reads_what_the_mesh_wrote(meshes, n):
    """The JAX package's Checkpointer and MessageLog read the mesh's files
    and give the port's arrays: the checkpoint is the live run's state at
    its step, and the logged A_s for a destination are the port reader's."""
    tpg, _, run, root = meshes(n)
    ck_dir, log_dir = os.path.join(root, "ckpt"), os.path.join(root, "log")
    rv, ra, step = rckpt.Checkpointer(ck_dir).restore()
    tv, ta, tstep = tc.Checkpointer(ck_dir).restore(device="cpu")
    assert step == tstep == 4
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ra), ta.numpy())
    for dest in range(n):
        ref = rckpt.MessageLog(log_dir).load_for_dest(5, dest, n, -1)
        port = tc.MessageLog(log_dir).load_for_dest(5, dest, n, -1)
        assert len(ref) == len(port) == n
        for (rA, rc_), (pA, pc) in zip(ref, port):
            np.testing.assert_array_equal(rA, pA)
            np.testing.assert_array_equal(rc_, pc)


@pytest.mark.parametrize("n", WORLD)
def test_mesh_log_bytes_and_checkpoint_seconds(meshes, n):
    """Each rank reports the bytes of its own log files, an npz of n·P
    float32 values and n·P int32 counts a superstep (the archive's headers
    under 1 KiB), and the seconds its checkpoints took."""
    tpg, _, run, _ = meshes(n)
    res = _result(run, "pagerank-logged")
    steps = len(res.history)
    for r in res.ranks:
        assert steps * n * tpg.P * 8 <= r["log_bytes"] \
            < steps * (n * tpg.P * 8 + 1024)
        assert r["ckpt_seconds"] > 0
    assert all(r["log_bytes"] is None and r["ckpt_seconds"] is None
               for r in _result(run, "pagerank-recoded-torch").ranks)


# --------------------------------------------------------------------------
# the distributed shim, op by op
# --------------------------------------------------------------------------

SHIM_RANK = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.core import collectives as coll
    from repro_torch.core.collectives import ProcessMesh
    r, n, port = (int(a) for a in sys.argv[1:4])
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=r, world_size=n)
    m = ProcessMesh(r, n, backend='gloo', device='cpu')
    rng = np.random.default_rng(7)  # every rank draws the same (n, ...) data
    P, E = 37, 5
    xf = torch.from_numpy(rng.standard_normal((n, P)).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-50, 50, (n, P)).astype(np.int32))
    a2a = torch.from_numpy(rng.standard_normal((n, n, E)).astype(np.float32))
    mine = slice(r, r + 1)

    def same(got, want, what):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert torch.equal(got, want), (what, got, want)

    same(m.ring_shift(xf[mine]), coll.ring_shift(xf)[mine], 'ring f32')
    same(m.ring_shift(xi[mine]), coll.ring_shift(xi)[mine], 'ring i32')
    same(m.all_to_all(a2a[mine]), coll.all_to_all(a2a)[mine], 'all_to_all')
    same(m.psum(xi[mine].sum(1)), coll.psum(xi.sum(1)), 'psum int')
    same(m.psum(xf[mine].sum(1)), coll.psum(xf.sum(1)), 'psum float')
    same(m.pmax(xi[mine]), coll.pmax(xi), 'pmax')
    same(m.axis_index(1, 'cpu'), coll.axis_index(n, 'cpu')[mine], 'index')
    k = int(n > 1)
    want = dict(ring=k * 2 * P * 4, all_to_all=k * n * E * 4, gather=k * 4,
                reduce=k * (8 + 4), staged=0)
    assert m.bytes == want, (m.bytes, want)
    dist.destroy_process_group()
    print('OK')
""")


@pytest.mark.parametrize("n", [1, 3, 4])
def test_shim_ops_equal_their_emulated_twins(n):
    """Each op of ProcessMesh on n gloo ranks gives every rank its row of
    the emulated op's result, bit for bit, and counts the bytes it handed
    gloo: ring P·4 a tensor, all_to_all the row, the float partial, an
    int64 sum and an int32 max."""
    from repro_torch.launch.mesh import _free_port

    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", SHIM_RANK, str(r),
                               str(n), port], env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "OK" in out, out


# --------------------------------------------------------------------------
# the slice, and a mesh of one rank in this process
# --------------------------------------------------------------------------

def test_slice_round_trip(tmp_path):
    _, tpg, _ = _setup(4)
    path = str(tmp_path / "s.npz")
    write_shard_slice(tpg, 2, path)
    got, shard = load_shard_slice(path, "cpu")
    want = shard_slice(tpg, 2)
    assert shard == 2 and got.n_rows == 1 and got.n_shards == 4
    for f in PartitionedGraph.TENSORS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.shape_summary == tpg.shape_summary
    with pytest.raises(ValueError, match="already a slice"):
        shard_slice(want, 0)


def test_one_rank_mesh_in_process():
    """A world of one needs no collective: the engine given the whole
    one-shard partition, or its slice, runs as the emulated engine."""
    _, tpg, src = _setup(1)
    mesh = ProcessMesh(0, 1, backend="gloo", device="cpu")
    for prog in (lambda: tc.PageRank(SUPERSTEPS), lambda: tc.SSSP(src)):
        v, a, hist = _emulated(tpg, prog(), tc.EngineConfig(backend="kernel"))
        for pg in (tpg, shard_slice(tpg, 0)):
            (mv, ma), mh = tc.GraphDEngine(pg, prog(), tc.EngineConfig(
                backend="kernel"), mesh=mesh).run()
            assert torch.equal(mv, v) and torch.equal(ma, a)
            assert _stats(mh) == _stats(hist)
    assert mesh.bytes == dict(ring=0, all_to_all=0, gather=0, reduce=0,
                              staged=0)


# --------------------------------------------------------------------------
# what the mesh refuses
# --------------------------------------------------------------------------

def _unranked_files(tmp_path):
    pg = _setup(2)[1]
    mesh = ProcessMesh(0, 2, backend="gloo", device="cpu")
    eng = lambda log, m=mesh: tc.GraphDEngine(
        pg, tc.PageRank(2), tc.EngineConfig(backend="torch"), mesh=m,
        message_log=log)
    return {
        "message log without mesh=": lambda: eng(
            tc.MessageLog(str(tmp_path / "l"))),
        "run-file log": lambda: eng(
            tc.RunFileMessageLog(str(tmp_path / "r"))),
        "checkpointer without mesh=": lambda: eng(None).run(
            checkpointer=tc.Checkpointer(str(tmp_path / "c"), every=1)),
        "meshed log off the mesh": lambda: eng(
            tc.MessageLog(str(tmp_path / "m"), mesh=mesh), None),
    }


@pytest.mark.parametrize("what", ["message log without mesh=",
                                  "run-file log",
                                  "checkpointer without mesh=",
                                  "meshed log off the mesh"])
def test_files_must_know_the_rank(tmp_path, what):
    """A log or checkpointer writes one file a shard it holds: on a mesh
    it is made with the engine's mesh, off one without; a run-file log
    keeps one index a superstep for every shard, so it stays off the
    mesh."""
    with pytest.raises(ValueError, match="mesh="):
        _unranked_files(tmp_path)[what]()


def test_restore_on_a_mesh_checks_the_shard_count(tmp_path):
    """A checkpoint of 2 shards does not restore onto a mesh of 1 rank; a
    checkpoint of 1 restores that rank's row."""
    _, tpg, _ = _setup(2)
    ck = tc.Checkpointer(str(tmp_path / "c"))
    ck.save(3, torch.zeros(2, tpg.P), torch.ones(2, tpg.P, dtype=torch.bool))
    one = ProcessMesh(0, 1, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="holds 2 shards and the mesh has 1"):
        tc.Checkpointer(str(tmp_path / "c"), mesh=one).restore(device="cpu")
    mine = tc.Checkpointer(str(tmp_path / "d"), mesh=one)
    mine.save(2, torch.ones(1, 5), torch.zeros(1, 5, dtype=torch.bool))
    v, a, step = mine.restore(device="cpu")
    assert step == 2 and v.shape == (1, 5) and not bool(a.any())


def test_streamed_with_a_mesh_is_the_references_value_error(tmp_path):
    from repro_torch.graph import partition_graph_streamed, rmat_graph as trmat

    pgs, _, store = partition_graph_streamed(
        trmat(scale=7, edge_factor=8, seed=3), 2, str(tmp_path / "s"),
        edge_block=64, device="cpu")
    with pytest.raises(ValueError, match="host-driven"):
        tc.GraphDEngine(pgs, tc.HashMin(), tc.EngineConfig(mode="streamed"),
                        stream_store=store,
                        mesh=ProcessMesh(0, 2, backend="gloo", device="cpu"))


def test_mesh_size_must_match_the_shards():
    pg = _setup(2)[1]
    with pytest.raises(ValueError, match="one shard a rank"):
        tc.GraphDEngine(pg, tc.HashMin(), tc.EngineConfig(backend="torch"),
                        mesh=ProcessMesh(0, 3, backend="gloo", device="cpu"))
    with pytest.raises(ValueError, match="world_size"):
        run_mesh(pg, tc.HashMin(), world_size=3, device="cpu")


def test_launcher_never_falls_back(monkeypatch):
    """The default device is CUDA and raises without it; NCCL on the CPU,
    or with fewer GPUs than ranks, raises before anything is spawned."""
    pg = _setup(2)[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mesh(pg, tc.HashMin())
    with pytest.raises(ValueError, match="device='cpu' means gloo"):
        run_mesh(pg, tc.HashMin(), backend="nccl", device="cpu")
    import repro_torch.device as rdev

    monkeypatch.setattr(rdev, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with pytest.raises(ValueError, match="one rank a GPU: 2 ranks, 1 GPUs"):
        run_mesh(pg, tc.HashMin(), backend="nccl")


# --------------------------------------------------------------------------
# a rank that dies or hangs fails the run, with no hang
# --------------------------------------------------------------------------

def _start(pg, workdir, timeout):
    """run_mesh of a PageRank that would run for minutes, in a thread;
    returns (thread, box) where box gets the exception."""
    box = {}

    def go():
        try:
            run_mesh(pg, tc.PageRank(100_000), tc.EngineConfig(
                backend="torch"), device="cpu", workdir=workdir,
                timeout=timeout)
        except Exception as e:  # handed to the test thread
            box["error"] = e

    t = threading.Thread(target=go)
    t.start()
    return t, box


def _rank_pids(workdir, n):
    pids = []
    for r in range(n):
        with open(os.path.join(workdir, f"rank-{r}.log")) as fh:
            pids.append(int(fh.readline().split()[3]))
    return pids


def _wait_for(pred, what):
    deadline = time.monotonic() + TIMEOUT
    while not pred():
        assert time.monotonic() < deadline, f"no {what}"
        time.sleep(0.05)


def _superstep_seen(workdir, rank, step):
    try:
        with open(os.path.join(workdir, f"rank-{rank}.log")) as fh:
            return f"superstep {step} " in fh.read()
    except OSError:
        return False


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_killed_rank_fails_the_run(tmp_path):
    pg = _setup(3)[1]
    workdir = str(tmp_path / "mesh")
    t, box = _start(pg, workdir, TIMEOUT)
    try:
        _wait_for(lambda: _superstep_seen(workdir, 1, 3), "superstep 3")
        pids = _rank_pids(workdir, 3)
        os.kill(pids[1], signal.SIGKILL)
        t0 = time.monotonic()
    finally:
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert time.monotonic() - t0 < 30  # the launcher saw it, not a timeout
    err = box.get("error")
    assert isinstance(err, MeshFailed) and "rank 1 exited with code -9" \
        in str(err), err
    assert all(_gone(p) for p in pids)


def test_hung_run_fails_at_its_deadline(tmp_path):
    pg = _setup(2)[1]
    workdir = str(tmp_path / "mesh")
    t0 = time.monotonic()
    t, box = _start(pg, workdir, 8.0)
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    err = box.get("error")
    assert isinstance(err, MeshFailed) and "still running after 8 s" \
        in str(err), err
    assert time.monotonic() - t0 < 8.0 + 30
    assert all(_gone(p) for p in _rank_pids(workdir, 2))


# --------------------------------------------------------------------------
# the launcher's import path
# --------------------------------------------------------------------------

def test_launcher_cold_import_loads_no_torch_jax_or_repro():
    """The rank imports torch itself, and times it: importing the launcher
    (and the package __init__s it runs) loads no torch, jax or JAX
    package."""
    subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import repro_torch.launch.mesh\n"
         "from repro_torch.launch import run_mesh\n"
         "bad = sorted(m for m in sys.modules\n"
         "             if m.split('.')[0] in ('torch', 'triton', 'jax',\n"
         "                                    'jaxlib', 'repro'))\n"
         "assert not bad, bad\n"],
        check=True, env=_env(),
    )


def test_edge_combine_takes_a_whole_partition_or_one_row():
    """The kernel finds row i's group at i * rows + dest[i]: right for all
    n rows or for one rank's row of all n destinations, and the wrapper
    refuses anything between."""
    from repro_torch.kernels.edge_combine import edge_combine

    _, tpg, _ = _setup(4)
    nb, B = tpg.n_blocks, tpg.edge_block
    blocks = lambda a, rows: a[:rows].reshape(rows, 4, nb, B)
    values = torch.rand(4, tpg.P)
    args = lambda rows: (values[:rows], tpg.degree[:rows],
                         tpg.vmask[:rows], blocks(tpg.src_pos, rows),
                         blocks(tpg.dst_pos, rows), blocks(tpg.eweight, rows),
                         torch.zeros(rows, dtype=torch.int32),
                         torch.arange(nb, dtype=torch.int32).repeat(rows, 1),
                         torch.full((rows,), nb, dtype=torch.int32))
    whole = edge_combine(*args(4), msg_kind="div_deg", combiner="sum")
    row = edge_combine(*args(1), msg_kind="div_deg", combiner="sum")
    assert torch.equal(row[0], whole[0][:1]) and torch.equal(row[1],
                                                             whole[1][:1])
    with pytest.raises(ValueError, match="for one row"):
        edge_combine(*args(2), msg_kind="div_deg", combiner="sum")
