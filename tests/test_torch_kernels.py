"""The port's kernels against the JAX package's, on the CPU: edge_combine
and digest (their plain versions, which CPU tensors take) held against the
Pallas kernels in interpret mode and the JAX package's oracles, plus the
skip() compaction against the JAX engine's test. The kernels themselves
are held against these plain versions on the card by test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.engine import _active_prefix as ref_prefix
from repro.core.engine import _block_active as ref_block_active
from repro.core.engine import _combine_scatter as ref_combine_scatter
from repro.core.algorithms import HashMin as RefHashMin
from repro.graph import partition_graph, rmat_graph
from repro.graph.kblocks import build_kernel_layout
from repro.kernels import ops as jops
from repro.kernels.ref import digest_ref as jax_digest_ref
from repro.kernels.ref import edge_combine_ref as jax_edge_combine_ref
from repro_torch.kernels import ops
from repro_torch.kernels.digest import digest
from repro_torch.kernels.edge_combine import (
    COMBINERS, MSG_KINDS, edge_combine, pair_counts,
)

# the shapes here are tiny: one intra-op thread keeps torch's idle
# OpenMP workers from competing with the other test processes
torch.set_num_threads(1)

WIN = 32


def _setup(scale=7, ef=8, seed=3, n=4, blk=32, vp=32, win=WIN):
    g = rmat_graph(scale=scale, edge_factor=ef, seed=seed, weights="uniform")
    pg, _ = partition_graph(g, n_shards=n, edge_block=64, vertex_pad=vp)
    kl = build_kernel_layout(pg, BLK=blk, SRC_WIN=win, DST_WIN=win)
    return pg, kl


@pytest.fixture(scope="module")
def layout():
    return _setup()


def _state(pg, density, seed=0):
    """(values f32, degree i32, active bool), each (n, P), from numpy."""
    rng = np.random.default_rng(seed)
    n, P = pg.n_shards, pg.P
    values = rng.random((n, P), dtype=np.float32)
    active = rng.random((n, P)) < density
    return values, np.asarray(pg.degree), active


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_group(values, degree, active, sp, dp, w, i, k, ids, nk, **kw):
    """Run the port's edge_combine on group (i, k): shard i reads dest k;
    the other shards keep no block."""
    n = values.shape[0]
    dest = torch.zeros(n, dtype=torch.int32)
    dest[i] = k
    n_keep = torch.zeros(n, dtype=torch.int32)
    n_keep[i] = int(nk)
    blk_ids = torch.zeros((n, sp.shape[2]), dtype=torch.int32)
    blk_ids[i] = _t(np.asarray(ids, dtype=np.int32))
    A, cnt = edge_combine(_t(values), _t(degree), _t(active), _t(sp), _t(dp),
                          _t(w), dest, blk_ids, n_keep, **kw)
    return A[i].numpy(), cnt[i].numpy()


def _assert_close(got, want, combiner):
    if combiner == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# edge_combine on the reference's KernelLayout against the Pallas kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.02, 0.2, 1.0])
@pytest.mark.parametrize("combiner", COMBINERS)
@pytest.mark.parametrize("msg_kind", MSG_KINDS)
def test_edge_combine_matches_pallas(layout, msg_kind, combiner, density):
    pg, kl = layout
    values, degree, active = _state(pg, density, seed=int(density * 100))
    i, k = 0, 1
    state3 = jnp.stack([jnp.asarray(values[i]),
                        jnp.asarray(degree[i].astype(np.float32)),
                        jnp.asarray(active[i].astype(np.float32))])
    prefix = ref_prefix(jnp.asarray(active[i]))
    keep = jops.skip_keep_mask(kl.blk_lo[i, k], kl.blk_hi[i, k],
                               kl.blk_dwin[i, k], prefix)
    ids, nk = jops.compact_blocks(keep)
    kw = dict(msg_kind=msg_kind, combiner=combiner)
    A_j, c_j = jops.edge_combine(
        state3, kl.sp[i, k], kl.dp[i, k], kl.w[i, k], ids, nk,
        kl.blk_swin[i, k], kl.blk_dwin[i, k], SRC_WIN=WIN, DST_WIN=WIN, **kw)
    A_p, c_p = _port_group(values, degree, active, np.asarray(kl.sp),
                           np.asarray(kl.dp), np.asarray(kl.w), i, k,
                           np.asarray(ids), nk, **kw)
    _assert_close(A_p, np.asarray(A_j), combiner)
    np.testing.assert_array_equal(c_p, np.asarray(c_j).astype(np.int32))


def test_edge_combine_empty_group_matches_pallas():
    pg, kl = _setup(scale=5, ef=1, n=8, blk=8, vp=8, win=8)
    values, degree, active = _state(pg, 0.0)
    i, k = 0, 0
    state3 = jnp.stack([jnp.asarray(values[i]),
                        jnp.asarray(degree[i].astype(np.float32)),
                        jnp.zeros(pg.P, jnp.float32)])
    ids = jnp.arange(kl.NB, dtype=jnp.int32)
    A_j, c_j = jops.edge_combine(
        state3, kl.sp[i, k], kl.dp[i, k], kl.w[i, k], ids, jnp.int32(kl.NB),
        kl.blk_swin[i, k], kl.blk_dwin[i, k], SRC_WIN=8, DST_WIN=8,
        msg_kind="copy", combiner="sum")
    A_p, c_p = _port_group(values, degree, active, np.asarray(kl.sp),
                           np.asarray(kl.dp), np.asarray(kl.w), i, k,
                           np.asarray(ids), kl.NB, msg_kind="copy",
                           combiner="sum")
    np.testing.assert_array_equal(A_p, np.asarray(A_j))
    assert A_p.sum() == 0 and c_p.sum() == 0 and np.asarray(c_j).sum() == 0


# --------------------------------------------------------------------------
# edge_combine on the partition's own blocks against the JAX oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("combiner", COMBINERS)
@pytest.mark.parametrize("msg_kind", MSG_KINDS)
def test_edge_combine_on_partition_blocks(layout, msg_kind, combiner):
    """One ring round of all shards over the partition's own blocks:
    every shard i against the JAX oracle."""
    pg, _ = layout
    n, P, NB, B = pg.n_shards, pg.P, pg.n_blocks, pg.edge_block
    values, degree, active = _state(pg, 0.3, seed=5)
    blocks = lambda f: np.asarray(getattr(pg, f)).reshape(n, n, NB, B)
    sp, dp, w = blocks("src_pos"), blocks("dst_pos"), blocks("eweight")
    dest = (np.arange(n) + 1) % n
    prefix = torch.cat([torch.zeros(n, 1, dtype=torch.int32),
                        _t(active).cumsum(1, dtype=torch.int32)], 1)
    ar = np.arange(n)
    keep = ops.skip_keep_mask(_t(np.asarray(pg.blk_lo)[ar, dest]),
                              _t(np.asarray(pg.blk_hi)[ar, dest]), prefix)
    ids, n_keep = ops.compact_blocks(keep)
    kw = dict(msg_kind=msg_kind, combiner=combiner)
    A, cnt = edge_combine(_t(values), _t(degree), _t(active), _t(sp), _t(dp),
                          _t(w), _t(dest.astype(np.int32)), ids, n_keep, **kw)
    for i in range(n):
        k = dest[i]
        state3 = np.stack([values[i], degree[i].astype(np.float32),
                           active[i].astype(np.float32)])
        A_j, c_j = jax_edge_combine_ref(
            jnp.asarray(state3), jnp.asarray(sp[i, k]), jnp.asarray(dp[i, k]),
            jnp.asarray(w[i, k]), jnp.asarray(ids[i].numpy()),
            jnp.int32(int(n_keep[i])), None, None, SRC_WIN=P, DST_WIN=P, **kw)
        _assert_close(A[i].numpy(), np.asarray(A_j), combiner)
        np.testing.assert_array_equal(cnt[i].numpy(), np.asarray(c_j))


@pytest.mark.parametrize("combiner", ["min", "max"])
@pytest.mark.parametrize("density", [0.1, 1.0])
def test_int32_copy_matches_combine_scatter(layout, combiner, density):
    """Hash-Min's int32 labels (here above 2^24) go through the int32 path
    exactly, as the JAX plain backend's _combine_scatter gives them."""
    pg, _ = layout
    n, NB, B = pg.n_shards, pg.n_blocks, pg.edge_block
    rng = np.random.default_rng(17)
    labels = rng.integers(2**24, 2**31 - 1, size=(n, pg.P)).astype(np.int32)
    _, degree, active = _state(pg, density, seed=3)
    dest = np.arange(n) % n  # the diagonal groups
    ids = torch.arange(NB, dtype=torch.int32).repeat(n, 1)
    n_keep = torch.full((n,), NB, dtype=torch.int32)
    blocks = lambda f: _t(np.asarray(getattr(pg, f)).reshape(n, n, NB, B))
    A, cnt = edge_combine(_t(labels), _t(degree), _t(active), blocks("src_pos"),
                          blocks("dst_pos"), blocks("eweight"),
                          _t(dest.astype(np.int32)), ids, n_keep,
                          msg_kind="copy", combiner=combiner)
    assert A.dtype == torch.int32
    prog = RefHashMin()
    if combiner == "max":
        from repro.core.algorithms import LabelSpread
        prog = LabelSpread()
    for i in range(n):
        k = dest[i]
        sp = jnp.asarray(np.asarray(pg.src_pos)[i, k])
        spc = jnp.clip(sp, 0)
        aact = (sp >= 0) & jnp.asarray(active[i])[spc]
        msg = jnp.where(aact, jnp.asarray(labels[i])[spc], prog.combiner.e0)
        A_j, c_j = ref_combine_scatter(prog, pg.P, msg,
                                       jnp.asarray(np.asarray(pg.dst_pos)[i, k]),
                                       aact)
        np.testing.assert_array_equal(A[i].numpy(), np.asarray(A_j))
        np.testing.assert_array_equal(cnt[i].numpy(), np.asarray(c_j))


def test_edge_combine_rejects_bad_input(layout):
    pg, _ = layout
    n, NB, B = pg.n_shards, pg.n_blocks, pg.edge_block
    ints = torch.zeros((n, pg.P), dtype=torch.int32)
    sp = torch.full((n, n, NB, B), -1, dtype=torch.int32)
    args = (ints, torch.zeros((n, pg.P), dtype=torch.bool), sp, sp,
            sp.float(), torch.zeros(n, dtype=torch.int32),
            torch.zeros((n, NB), dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32 values"):
        edge_combine(ints, *args, msg_kind="div_deg", combiner="sum")
    with pytest.raises(ValueError, match="unknown"):
        edge_combine(ints.float(), *args, msg_kind="sqrt", combiner="sum")
    with pytest.raises(ValueError, match=r"\(n, n, NB, BLK\)"):
        edge_combine(ints.float(), *args[:2], sp[0], *args[3:],
                     msg_kind="copy", combiner="sum")


def test_plain_path_counts_no_launches(layout):
    pg, _ = layout
    n, NB, B = pg.n_shards, pg.n_blocks, pg.edge_block
    before = edge_combine.launches, digest.launches
    sp = torch.full((n, n, NB, B), -1, dtype=torch.int32)
    edge_combine(torch.zeros((n, pg.P)), torch.zeros((n, pg.P), dtype=torch.int32),
                 torch.zeros((n, pg.P), dtype=torch.bool), sp, sp, sp.float(),
                 torch.zeros(n, dtype=torch.int32),
                 torch.zeros((n, NB), dtype=torch.int32),
                 torch.zeros(n, dtype=torch.int32), msg_kind="copy",
                 combiner="min")
    digest(torch.zeros(4), torch.zeros(4, dtype=torch.int32), torch.ones(4),
           torch.zeros(4, dtype=torch.int32), combiner="sum")
    assert (edge_combine.launches, digest.launches) == before


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_smoke_bound_counts_the_sources_kept_slots_name(density):
    """chip_smoke prices edge_combine's source state by the distinct sources
    that the kept slots name, and the active ones among them: a plain loop
    over the kept blocks gives the same counts."""
    import importlib.util
    import os

    from repro_torch.graph import partition_graph as t_partition_graph
    from repro_torch.graph import rmat_graph as t_rmat_graph

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    pg, _ = t_partition_graph(t_rmat_graph(scale=9, edge_factor=8, seed=2),
                              4, edge_block=32, device="cpu")
    n, P, NB, B = pg.n_shards, pg.P, pg.n_blocks, pg.edge_block
    sp = pg.src_pos.view(n, n, NB, B)
    rng = np.random.default_rng(7)
    active = torch.from_numpy(rng.random((n, P)) < density)
    dest = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    ids = torch.from_numpy(np.stack([rng.permutation(NB) for _ in range(n)])
                           .astype(np.int32))
    n_keep = torch.tensor([NB, 0, NB // 2, 1], dtype=torch.int32)
    named = active_named = 0
    for i in range(n):
        srcs = set()
        for j in range(int(n_keep[i])):
            blk = sp[i, int(dest[i]), int(ids[i, j])]
            srcs |= {int(x) for x in blk if x >= 0}
        named += len(srcs)
        active_named += sum(bool(active[i, x]) for x in srcs)
    assert smoke.kept_sources(sp, active, dest, ids, n_keep) == (
        named, active_named)


@pytest.mark.parametrize("E_cap", [512, 4_203_008, 2**24 - 512, 2**24,
                                   2**25])
def test_pair_counts_only_where_float32_counts_stay_exact(E_cap):
    """The paired path counts each destination's messages in float32, one
    at a time, and a destination of a group receives at most E_cap of
    them: counting up to E_cap must stay exact wherever the path is
    allowed, which is float sums with E_cap below 2^24 only."""
    c = np.float32(E_cap - 4)
    for _ in range(4):  # the last counts toward E_cap
        c = np.float32(c + np.float32(1))
    allowed = pair_counts(torch.float32, "sum", E_cap)
    assert allowed == (E_cap < 2**24)
    assert int(c) == E_cap or not allowed
    assert int(c) != E_cap or E_cap <= 2**24
    for dtype, combiner in [(torch.int32, "sum"), (torch.float32, "min"),
                            (torch.float32, "max")]:
        assert not pair_counts(dtype, combiner, E_cap)


# --------------------------------------------------------------------------
# digest
# --------------------------------------------------------------------------

@pytest.mark.parametrize("combiner", COMBINERS)
@pytest.mark.parametrize("P,win", [(64, 16), (128, 128), (96, 32)])
def test_digest_matches_pallas_and_refs(combiner, P, win):
    rng = np.random.default_rng(P + win)
    ar = rng.standard_normal(P).astype(np.float32)
    cnt = rng.integers(0, 5, P).astype(np.int32)
    rv = rng.standard_normal(P).astype(np.float32)
    rc = rng.integers(0, 5, P).astype(np.int32)
    a_j, c_j = jops.digest(*map(jnp.asarray, (ar, cnt, rv, rc)),
                           combiner=combiner, WIN=win)
    a_r, c_r = jax_digest_ref(*map(jnp.asarray, (ar, cnt, rv, rc)),
                              combiner=combiner)
    a_p, c_p = digest(*map(_t, (ar, cnt, rv, rc)), combiner=combiner)
    for a, c in ((a_j, c_j), (a_r, c_r)):
        np.testing.assert_array_equal(a_p.numpy(), np.asarray(a))
        np.testing.assert_array_equal(c_p.numpy(), np.asarray(c))


@pytest.mark.parametrize("combiner", COMBINERS)
def test_digest_int32_and_batched(combiner):
    rng = np.random.default_rng(1)
    a, r = (rng.integers(-2**31, 2**31 - 1, (4, 40)).astype(np.int32)
            for _ in range(2))
    c, rc = (rng.integers(0, 9, (4, 40)).astype(np.int32) for _ in range(2))
    got = digest(*map(_t, (a, c, r, rc)), combiner=combiner)
    want = jax_digest_ref(*map(jnp.asarray, (a.ravel(), c.ravel(),
                                              r.ravel(), rc.ravel())),
                          combiner=combiner)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy().ravel(), np.asarray(y))


# --------------------------------------------------------------------------
# skip() compaction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.02, 0.2, 1.0])
def test_compaction_keeps_block_active_blocks(density):
    """The port's compact_blocks(skip_keep_mask(...)) keeps exactly the
    blocks the JAX engine's _block_active marks, ascending, kept first."""
    g = rmat_graph(scale=8, edge_factor=8, seed=2)
    pg, _ = partition_graph(g, n_shards=4, edge_block=16)
    rng = np.random.default_rng(int(density * 1000))
    active = rng.random((4, pg.P)) < density
    ar = np.arange(4)
    for r in range(4):
        dest = (np.arange(4) + 3 - r) % 4
        lo = np.asarray(pg.blk_lo)[ar, dest]
        hi = np.asarray(pg.blk_hi)[ar, dest]
        prefix = torch.cat([torch.zeros(4, 1, dtype=torch.int32),
                            _t(active).cumsum(1, dtype=torch.int32)], 1)
        ids, n_keep = ops.compact_blocks(ops.skip_keep_mask(_t(lo), _t(hi), prefix))
        for i in range(4):
            want = np.asarray(ref_block_active(
                pg, ref_prefix(jnp.asarray(active[i])), jnp.asarray(lo[i]),
                jnp.asarray(hi[i])))
            kept = ids[i, : int(n_keep[i])].numpy()
            np.testing.assert_array_equal(kept, np.flatnonzero(want))
            assert sorted(ids[i].tolist()) == list(range(pg.n_blocks))

