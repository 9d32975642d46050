"""The port's mesh (``GraphDEngine(..., mesh=)`` over ``torch.distributed``,
``repro_torch.launch.mesh``) on the CPU: gloo ranks spawned as processes,
one a shard, held against the port's emulated one-process run and the JAX
reference's ``vmap`` run.

One mesh is spawned per world size and runs every case in turn (the
spawn, a torch import a rank, costs more than the cases). Twins of
tests/test_distributed.py's shard_map tests: all modes' PageRank (:29),
sparse SSSP (:57), the kernel backend (:87)."""

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
import repro_torch.core as tc
from repro.graph import partition_graph, rmat_graph
from repro_torch import convert
from repro_torch.core.collectives import ProcessMesh
from repro_torch.graph.partition import (
    PartitionedGraph, load_shard_slice, shard_slice, write_shard_slice,
)
from repro_torch.launch.mesh import MeshFailed, run_mesh, run_mesh_cases

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
}


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


def _emulated(tpg, program, config):
    (v, a), hist = tc.GraphDEngine(tpg, program, config, device="cpu").run()
    return v, a, hist


def _stats(hist):
    return [(h.step, h.n_active, h.n_msgs, h.mode, h.agg, h.density)
            for h in hist]


@pytest.fixture(scope="module")
def meshes():
    """world size -> (port partition, source, MeshRun of every case), run
    once each."""
    runs = {}

    def get(n):
        if n not in runs:
            _, tpg, src = _setup(n)
            runs[n] = (tpg, src, run_mesh_cases(
                tpg, _cases(src), device="cpu", timeout=TIMEOUT))
        return runs[n]
    return get


# --------------------------------------------------------------------------
# the mesh against the emulated run: bit-identical
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", WORLD)
def test_mesh_equals_emulated(meshes, n, case):
    """Values, active bitmaps, every superstep's stats (the aggregator and
    the dense/sparse decision too) and the halt step, bit for bit."""
    tpg, src, run = meshes(n)
    res = run.results[list(CASES).index(case)]
    make, cfg = CASES[case]
    v, a, hist = _emulated(tpg, make(src), tc.EngineConfig(**cfg))
    assert res.values.dtype == v.dtype and res.values.shape == v.shape
    assert torch.equal(res.values, v)
    assert torch.equal(res.active, a)
    assert _stats(res.history) == _stats(hist)
    if case.startswith("pagerank"):
        # the reference's own bound between shard_map and vmap (:52)
        assert float((res.values - v).abs().max()) < 1e-7
    assert all(r["launches"] == dict(edge_combine=0, digest=0)
               for r in res.ranks)  # the CPU runs the plain versions


@pytest.mark.parametrize("n", WORLD)
def test_mesh_bytes_match_the_model(meshes, n):
    """What each rank hands the backend a superstep: the ring (n-1)·P·8
    bytes (value and count), basic's all_to_all n·E_cap·8 (payload and
    destination), five 8-byte reductions, PageRank's 4-byte aggregator;
    nothing staged on the CPU."""
    tpg, _, run = meshes(n)
    for case, res in zip(CASES, run.results):
        steps = len(res.history)
        ring = 0 if "-basic-" in case else (n - 1) * tpg.P * 8
        a2a = n * tpg.E_cap * 8 if "-basic-" in case else 0
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
    tpg, src, run = meshes(n)
    res = run.results[list(CASES).index("sssp-recoded-torch-sparse")]
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
    tpg, _, run = meshes(4)
    res = run.results[list(CASES).index("pagerank-recoded-kernel")]
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
}


@pytest.mark.parametrize("case", list(REF))
def test_mesh_against_the_reference(meshes, case):
    """The 8-rank mesh against the reference's emulated (vmap) run of the
    same partition: PageRank within 1e-5 (tests/test_torch_engine.py),
    the rest exactly, with its superstep stats."""
    pg, _, src = _setup(8)
    _, _, run = meshes(8)
    res = run.results[list(CASES).index(case)]
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

def _refusals(tmp_path):
    pg = _setup(2)[1]
    mesh = ProcessMesh(0, 2, backend="gloo", device="cpu")
    eng = lambda prog, cfg, **kw: tc.GraphDEngine(pg, prog, cfg, mesh=mesh,
                                                  **kw)
    return {
        "recoded_compact": lambda: eng(tc.PageRank(2), tc.EngineConfig(
            mode="recoded_compact", backend="torch")),
        "message_log": lambda: eng(tc.PageRank(2), tc.EngineConfig(
            backend="torch"), message_log=tc.MessageLog(str(tmp_path / "l"))),
        "checkpointer": lambda: eng(tc.PageRank(2), tc.EngineConfig(
            backend="torch")).run(checkpointer=tc.Checkpointer(
                str(tmp_path / "c"), every=1)),
        "basic without a combiner": lambda: eng(
            tc.DistinctInLabels(), tc.EngineConfig(mode="basic",
                                                   backend="torch")),
    }


@pytest.mark.parametrize("what", ["recoded_compact", "message_log",
                                  "checkpointer", "basic without a combiner"])
def test_slice_5b_refusals(tmp_path, what):
    with pytest.raises(NotImplementedError, match="slice 5b"):
        _refusals(tmp_path)[what]()


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
