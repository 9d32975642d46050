"""The port's recovery layer on the CPU: checkpoint/restore, message-log fast
recovery, elastic repartitioning and topology mutation (paper §3.4 and
[19]), as the twins of tests/test_fault.py and tests/test_engine.py's
mutation tests, plus checkpoints and logs that cross between the packages."""

import os

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import checkpoint as ref_ckpt
from repro.core.mutation import mutate as ref_mutate
from repro.graph import partition_graph, rmat_graph
from repro_torch import convert
from repro_torch.core.checkpoint import Checkpointer, MessageLog, recover_shard
from repro_torch.core.elastic import extract_global, repartition
from repro_torch.core.mutation import mutate
from repro_torch.graph.partition import PartitionedGraph

# the shapes here are tiny: one intra-op thread keeps torch's idle
# OpenMP workers from competing with the other test processes
torch.set_num_threads(1)

CPU = "cpu"


def _port_pg(pg):
    arrays = {f: np.asarray(getattr(pg, f)) for f in PartitionedGraph.TENSORS}
    static = {f: getattr(pg, f) for f in convert.STATIC}
    return convert.partition_from_arrays(arrays, static, device=CPU)


def Engine(pg, prog, **kw):
    return tc.GraphDEngine(pg, prog, device=CPU, **kw)


@pytest.fixture
def job():
    g = rmat_graph(scale=7, edge_factor=8, seed=3)
    pg, rmap = partition_graph(g, n_shards=4, edge_block=64)
    return g, _port_pg(pg), rmap


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    """A JAX array as a (writable) CPU tensor."""
    return torch.from_numpy(np.array(x))


class TestCheckpoint:
    def test_save_restore_roundtrip(self, job, tmp_path):
        _, pg, _ = job
        eng = Engine(pg, tc.PageRank(supersteps=6))
        ck = Checkpointer(str(tmp_path / "ckpt"), every=2)
        eng.run(checkpointer=ck)
        assert ck.latest() == 6
        rv, ra, step = ck.restore(device=CPU)
        (v6, a6), _ = eng.run(max_supersteps=6)
        assert step == 6 and np.allclose(rv.numpy(), v6.numpy())
        assert torch.equal(ra, a6)

    def test_restart_equals_uninterrupted(self, job, tmp_path):
        _, pg, _ = job
        (v_ref, _), _ = Engine(pg, tc.PageRank(supersteps=8)).run()
        ck = Checkpointer(str(tmp_path / "ckpt"), every=3)
        eng = Engine(pg, tc.PageRank(supersteps=8))
        eng.run(max_supersteps=5, checkpointer=ck)  # "crash" after step 5
        eng2 = Engine(pg, tc.PageRank(supersteps=8))
        (v2, _), hist = eng2.run(checkpointer=ck)  # resumes from step 3
        assert hist[0].step == 3
        assert np.allclose(v2.numpy(), v_ref.numpy())

    def test_gc_keeps_latest(self, job, tmp_path):
        _, pg, _ = job
        ck = Checkpointer(str(tmp_path / "ckpt"), every=1, keep=2)
        Engine(pg, tc.PageRank(supersteps=6)).run(checkpointer=ck)
        assert len(ck.all_steps()) == 2

    def test_atomic_no_partial_visible(self, job, tmp_path):
        _, pg, _ = job
        ck = Checkpointer(str(tmp_path / "ckpt"), every=1)
        Engine(pg, tc.PageRank(supersteps=3)).run(checkpointer=ck)
        for name in os.listdir(str(tmp_path / "ckpt")):
            assert not name.startswith(".tmp")

    def test_stale_tmp_dirs_swept_on_init(self, tmp_path):
        d = str(tmp_path / "ckpt")
        os.makedirs(os.path.join(d, ".tmp-step-000004"))
        with open(os.path.join(d, ".tmp-step-000004", "shard-0.npz"), "wb"):
            pass
        ck = Checkpointer(d, every=1)
        assert not any(name.startswith(".tmp") for name in os.listdir(d))
        assert ck.all_steps() == []

    def test_all_steps_ignores_malformed_entries(self, tmp_path):
        d = str(tmp_path / "ckpt")
        ck = Checkpointer(d, every=1)
        os.makedirs(os.path.join(d, "step-000002"))
        os.makedirs(os.path.join(d, "step-garbage"))
        with open(os.path.join(d, "step-000009"), "w"):
            pass  # a FILE named like a step is not a checkpoint
        with open(os.path.join(d, "notes.txt"), "w"):
            pass
        assert ck.all_steps() == [2]
        assert ck.latest() == 2

    def test_explicit_state_wins_over_checkpoint(self, job, tmp_path):
        _, pg, _ = job
        ck = Checkpointer(str(tmp_path / "ckpt"), every=2)
        eng = Engine(pg, tc.PageRank(supersteps=6))
        eng.run(checkpointer=ck)  # leaves a step-6 checkpoint behind
        assert ck.latest() == 6
        v0, a0 = eng.init()
        (_, _), hist = eng.run(state=(v0, a0), start_step=0, checkpointer=ck)
        assert hist[0].step == 0  # not fast-forwarded to 6
        assert hist[0].restored_from is None

    def test_auto_restore_records_step(self, job, tmp_path):
        _, pg, _ = job
        ck = Checkpointer(str(tmp_path / "ckpt"), every=2)
        Engine(pg, tc.PageRank(supersteps=6)).run(max_supersteps=4,
                                                   checkpointer=ck)
        (_, _), hist = Engine(pg, tc.PageRank(supersteps=6)).run(
            checkpointer=ck)
        assert hist[0].step == 4
        assert hist[0].restored_from == 4
        assert all(r.restored_from is None for r in hist[1:])

    def test_verbose_prints_each_resumed_superstep(self, job, tmp_path,
                                                   capsys):
        _, pg, _ = job
        ck = Checkpointer(str(tmp_path / "ckpt"), every=2)
        Engine(pg, tc.PageRank(supersteps=6)).run(max_supersteps=4,
                                                   checkpointer=ck)
        assert capsys.readouterr().out == ""  # quiet by default
        (_, _), hist = Engine(pg, tc.PageRank(supersteps=6)).run(
            checkpointer=ck, verbose=True)
        lines = capsys.readouterr().out.splitlines()
        assert [int(ln.split(":")[0].split()[-1]) for ln in lines] == [4, 5]
        for ln, rec in zip(lines, hist):
            assert f"msgs={rec.n_msgs:>10d}" in ln and f"[{rec.mode}]" in ln


class TestFastRecovery:
    """[19]: only the failed shard recomputes, replaying logged messages."""

    @pytest.mark.parametrize("failed", [0, 2, 3])
    def test_single_shard_recovery(self, job, tmp_path, failed):
        _, pg, _ = job
        prog = tc.PageRank(supersteps=8)
        (v_ref, a_ref), _ = Engine(pg, prog).run()
        ck = Checkpointer(str(tmp_path / "ckpt"), every=3)
        ml = MessageLog(str(tmp_path / "logs"))
        eng = Engine(pg, prog, message_log=ml)
        ck.save(0, *eng.init())
        eng.run(checkpointer=ck)
        vj, aj = recover_shard(pg, prog, failed=failed, ckpt=ck, log=ml,
                               target_step=8)
        assert np.abs(vj.numpy() - v_ref.numpy()[failed]).max() < 1e-6
        assert np.array_equal(aj.numpy(), a_ref.numpy()[failed])

    def test_recovery_min_combiner(self, job, tmp_path):
        _, pg, _ = job
        prog = tc.HashMin()
        (v_ref, _), hist = Engine(pg, prog).run()
        ck = Checkpointer(str(tmp_path / "ckpt"), every=4)
        ml = MessageLog(str(tmp_path / "logs"))
        eng = Engine(pg, prog, message_log=ml)
        ck.save(0, *eng.init())
        eng.run(checkpointer=ck)
        vj, _ = recover_shard(pg, prog, failed=1, ckpt=ck, log=ml,
                              target_step=len(hist))
        assert torch.equal(vj, v_ref[1])

    def test_log_gc(self, job, tmp_path):
        _, pg, _ = job
        ml = MessageLog(str(tmp_path / "logs"))
        Engine(pg, tc.PageRank(supersteps=4), message_log=ml).run()
        ml.gc_before(2)
        remaining = sorted(os.listdir(str(tmp_path / "logs")))
        assert remaining == ["step-000002", "step-000003"]

    def test_engine_gcs_logs_after_checkpoint(self, job, tmp_path):
        _, pg, _ = job
        ck = Checkpointer(str(tmp_path / "ckpt"), every=3)
        ml = MessageLog(str(tmp_path / "logs"))
        Engine(pg, tc.PageRank(supersteps=8), message_log=ml).run(
            checkpointer=ck)
        # checkpoints landed at steps 3 and 6 => logs 0..5 are gone, and
        # recovery from the latest checkpoint still has every log it needs
        assert sorted(os.listdir(str(tmp_path / "logs"))) == [
            "step-000006", "step-000007",
        ]
        vj, _ = recover_shard(pg, tc.PageRank(supersteps=8), failed=1,
                              ckpt=ck, log=ml, target_step=8)
        (v_ref, _), _ = Engine(pg, tc.PageRank(supersteps=8)).run()
        assert np.abs(vj.numpy() - v_ref.numpy()[1]).max() < 1e-6


class TestElastic:
    def test_scale_up_pagerank(self, job):
        _, pg, _ = job
        (v_ref, _), _ = Engine(pg, tc.PageRank(supersteps=8)).run()
        ref = Engine(pg, tc.PageRank(supersteps=8)).gather_values(v_ref)
        (vA, aA), _ = Engine(pg, tc.PageRank(supersteps=8)).run(
            max_supersteps=4)
        pgB, vB, aB = repartition(pg, vA, aA, n_new=6, edge_block=64)
        engB = Engine(pgB, tc.PageRank(supersteps=8))
        (vC, _), _ = engB.run(state=(vB, aB), start_step=4)
        got = engB.gather_values(vC)
        assert max(abs(got[k] - ref[k]) for k in ref) < 1e-6

    def test_scale_down_hashmin(self):
        gu = rmat_graph(scale=8, edge_factor=2, seed=9, directed=False)
        pgu, _ = partition_graph(gu, n_shards=4, edge_block=32)
        pgu = _port_pg(pgu)
        (vr, _), _ = Engine(pgu, tc.HashMin()).run()
        want = Engine(pgu, tc.HashMin()).gather_values(vr)
        (v1, a1), _ = Engine(pgu, tc.HashMin()).run(max_supersteps=3)
        pg2, v2, a2 = repartition(pgu, v1, a1, n_new=2, edge_block=32)
        e2 = Engine(pg2, tc.HashMin())
        (v3, _), _ = e2.run(state=(v2, a2), start_step=3)
        assert e2.gather_values(v3) == want

    def test_extract_global_roundtrip(self, job):
        g, pg, _ = job
        eng = Engine(pg, tc.PageRank(supersteps=2))
        (v, a), _ = eng.run()
        g_real, _, _, _, src_g, _, _ = extract_global(pg, v, a)
        assert len(g_real) == g.n_vertices
        assert len(src_g) == g.n_edges
        # repartition to the SAME n is an identity on results
        pg2, v2, a2 = repartition(pg, v, a, n_new=pg.n_shards,
                                  edge_block=pg.edge_block)
        got = Engine(pg2, tc.PageRank(supersteps=2)).gather_values(v2)
        assert got == eng.gather_values(v)

    def test_sssp_across_repartition(self, job):
        g, pg, rmap = job
        src_new = int(rmap.to_new(np.array([int(g.vertex_ids[0])]))[0])
        (v_ref, _), _ = Engine(pg, tc.SSSP(src_new)).run()
        ref = Engine(pg, tc.SSSP(src_new)).gather_values(v_ref)
        (v1, a1), _ = Engine(pg, tc.SSSP(src_new)).run(max_supersteps=2)
        pg2, v2, a2 = repartition(pg, v1, a1, n_new=5, edge_block=64)
        e2 = Engine(pg2, tc.SSSP(src_new))
        (v3, _), _ = e2.run(state=(v2, a2), start_step=2)
        got = e2.gather_values(v3)
        for k in ref:
            assert got[k] == ref[k] or (np.isinf(got[k]) and np.isinf(ref[k]))


@pytest.mark.parametrize("n_new", [2, 6])
def test_repartition_matches_reference(job, n_new):
    """The port's repartition gives the reference's partition and state."""
    from repro.core.elastic import repartition as ref_repartition

    _, tpg, _ = job
    g = rmat_graph(scale=7, edge_factor=8, seed=3)
    pg, _ = partition_graph(g, n_shards=4, edge_block=64)
    (v, a), _ = rc.GraphDEngine(pg, rc.HashMin()).run(max_supersteps=2)
    want = ref_repartition(pg, v, a, n_new=n_new)
    got = repartition(tpg, _t(v),
                      _t(a), n_new=n_new)
    for f in PartitionedGraph.TENSORS:
        np.testing.assert_array_equal(_np(getattr(got[0], f)),
                                      np.asarray(getattr(want[0], f)), f)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


class TestTopologyMutation:
    """Paper §3.4: edge/vertex mutation between supersteps."""

    def test_add_remove_and_continue(self):
        g = rmat_graph(scale=7, edge_factor=6, seed=9)
        pg0, _ = partition_graph(g, n_shards=4, edge_block=32)
        pg0 = _port_pg(pg0)
        (v0, a0), _ = Engine(pg0, tc.PageRank(supersteps=4)).run(
            max_supersteps=2)
        pg1, v1, a1, new_g = mutate(pg0, v0, a0, add_vertices=3)
        assert pg1.n_vertices == pg0.n_vertices + 3
        e_add = [(int(new_g[0]), int(new_g[1])),
                 (int(new_g[1]), int(new_g[2]))]
        pg2, v2, a2, _ = mutate(pg1, v1, a1, add_edges=e_add)
        assert pg2.n_edges == pg1.n_edges + 2
        (v3, _), _ = Engine(pg2, tc.PageRank(supersteps=4)).run(
            state=(v2, a2), start_step=2)
        assert torch.isfinite(v3).all()
        pg3, _, _, _ = mutate(pg2, v3, a2, remove_edges=e_add)
        assert pg3.n_edges == pg2.n_edges - 2

    def test_positions_stable_under_mutation(self):
        g = rmat_graph(scale=6, edge_factor=4, seed=2)
        pg0, _ = partition_graph(g, n_shards=4, edge_block=32)
        pg0 = _port_pg(pg0)
        (v0, a0), _ = Engine(pg0, tc.PageRank(supersteps=2)).run()
        pg1, v1, _, _ = mutate(pg0, v0, a0, add_vertices=5)
        g0 = pg0.gids.numpy()[pg0.vmask.numpy()]
        old_vals, new_vals = v0.numpy(), v1.numpy()
        for gid in g0[:50]:
            s, p = int(gid) % 4, int(gid) // 4
            assert old_vals[s, p] == new_vals[s, p]


def test_mutate_matches_reference():
    """The vectorised edge removal gives the reference loop's partition,
    state and new ids, duplicates and absent edges included."""
    g = rmat_graph(scale=7, edge_factor=6, seed=9)
    pg, _ = partition_graph(g, n_shards=3, edge_block=32)
    tpg = _port_pg(pg)
    (v, a), _ = rc.GraphDEngine(pg, rc.PageRank(3)).run()
    src_g, dst_g = extract_global(tpg, _t(v),
                                  _t(a))[4:6]
    rng = np.random.default_rng(0)
    pick = rng.choice(src_g.shape[0], 20, replace=False)
    remove = [(int(src_g[i]), int(dst_g[i])) for i in pick]
    remove += [remove[0], (0, 0), (10**6, 3)]  # a duplicate, two absent
    kw = dict(remove_edges=remove, add_vertices=4,
              add_edges=[(1, 2, 0.5), (3, 1, 2.0)])
    want = ref_mutate(pg, v, a, **kw)
    got = mutate(tpg, _t(v),
                 _t(a), **kw)
    assert got[0].n_edges == want[0].n_edges < pg.n_edges
    for f in PartitionedGraph.TENSORS:
        np.testing.assert_array_equal(_np(getattr(got[0], f)),
                                      np.asarray(getattr(want[0], f)), f)
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


# --------------------------------------------------------------------------
# checkpoints and logs across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prog", ["pagerank", "hashmin"])
def test_checkpoint_jax_to_port(tmp_path, prog):
    g = rmat_graph(scale=7, edge_factor=8, seed=3)
    pg, _ = partition_graph(g, n_shards=4, edge_block=64)
    p = rc.PageRank(4) if prog == "pagerank" else rc.HashMin()
    (v, a), _ = rc.GraphDEngine(pg, p).run(max_supersteps=3)
    ref_ckpt.Checkpointer(str(tmp_path), every=1).save(3, v, a)
    ck = Checkpointer(str(tmp_path))
    rv, ra, step = ck.restore(device=CPU)
    assert step == 3 and rv.dtype == (torch.float32 if prog == "pagerank"
                                      else torch.int32)
    np.testing.assert_array_equal(rv.numpy(), np.asarray(v))
    np.testing.assert_array_equal(ra.numpy(), np.asarray(a))
    sv, sa, _ = ck.restore_shard(2, device=CPU)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(v)[2])
    np.testing.assert_array_equal(sa.numpy(), np.asarray(a)[2])


@pytest.mark.parametrize("prog", ["pagerank", "hashmin"])
def test_checkpoint_port_to_jax(job, tmp_path, prog):
    _, pg, _ = job
    p = tc.PageRank(4) if prog == "pagerank" else tc.HashMin()
    ck = Checkpointer(str(tmp_path), every=2)
    (v, a), _ = Engine(pg, p).run(max_supersteps=2, checkpointer=ck)
    rv, ra, step = ref_ckpt.Checkpointer(str(tmp_path)).restore()
    assert step == 2
    np.testing.assert_array_equal(np.asarray(rv), v.numpy())
    np.testing.assert_array_equal(np.asarray(ra), a.numpy())
    # the JAX engine resumes the port's checkpoint to the same result
    g = rmat_graph(scale=7, edge_factor=8, seed=3)
    rpg, _ = partition_graph(g, n_shards=4, edge_block=64)
    rp = rc.PageRank(4) if prog == "pagerank" else rc.HashMin()
    (rv2, _), hist = rc.GraphDEngine(rpg, rp).run(
        checkpointer=ref_ckpt.Checkpointer(str(tmp_path), every=0))
    assert hist[0].restored_from == 2
    (v2, _), _ = Engine(pg, p).run()
    if prog == "pagerank":
        assert np.abs(np.asarray(rv2) - v2.numpy()).max() < 1e-6
    else:
        np.testing.assert_array_equal(np.asarray(rv2), v2.numpy())


@pytest.mark.parametrize("prog", ["pagerank", "hashmin"])
def test_jax_message_log_replayed_by_port(tmp_path, prog):
    """A log and checkpoint the JAX engine wrote, replayed by the port's
    recover_shard, give the JAX recover_shard's row."""
    g = rmat_graph(scale=7, edge_factor=8, seed=3)
    pg, _ = partition_graph(g, n_shards=4, edge_block=64)
    mk_r = (lambda: rc.PageRank(7)) if prog == "pagerank" else rc.HashMin
    mk_p = (lambda: tc.PageRank(7)) if prog == "pagerank" else tc.HashMin
    ck = ref_ckpt.Checkpointer(str(tmp_path / "ckpt"), every=3)
    ml = ref_ckpt.MessageLog(str(tmp_path / "logs"))
    eng = rc.GraphDEngine(pg, mk_r(), message_log=ml)
    ck.save(0, *eng.init())
    (_, _), hist = eng.run(checkpointer=ck)
    target = len(hist)
    want_v, want_a = ref_ckpt.recover_shard(pg, mk_r(), failed=2, ckpt=ck,
                                            log=ml, target_step=target)
    got_v, got_a = recover_shard(
        _port_pg(pg), mk_p(), failed=2, ckpt=Checkpointer(ck.dir),
        log=MessageLog(ml.dir), target_step=target)
    if prog == "pagerank":
        assert np.abs(got_v.numpy() - np.asarray(want_v)).max() < 1e-6
    else:
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_port_message_log_replayed_by_jax(job, tmp_path):
    """And the other way round: the port's log, the reference's replay."""
    _, tpg, _ = job
    ck = Checkpointer(str(tmp_path / "ckpt"), every=3)
    ml = MessageLog(str(tmp_path / "logs"))
    eng = Engine(tpg, tc.HashMin(), message_log=ml)
    ck.save(0, *eng.init())
    (v, _), hist = eng.run(checkpointer=ck)
    g = rmat_graph(scale=7, edge_factor=8, seed=3)
    pg, _ = partition_graph(g, n_shards=4, edge_block=64)
    want_v, _ = ref_ckpt.recover_shard(
        pg, rc.HashMin(), failed=3, ckpt=ref_ckpt.Checkpointer(ck.dir),
        log=ref_ckpt.MessageLog(ml.dir), target_step=len(hist))
    np.testing.assert_array_equal(np.asarray(want_v), v.numpy()[3])
