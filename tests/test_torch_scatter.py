"""The torch backend's float sums in one stated order, on the CPU:
``core/engine.py::_combine_scatter`` adds each destination slot's messages
left to right as they stand in the flat message array, through
``kernels/run_sum`` (whose plain version runs here), which is the order of
``np.add.at``. Every caller's input shape is held to ``np.add.at`` bit for
bit: the dense groups with their precomputed order, the sparse and
recovery calls that sort per call, ``basic_sc``'s sorted rows, ``basic``'s
receiver partials and the streamed ``fold_batch`` lanes."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.core import HashMin, PageRank
from repro_torch.core.engine import (
    PRESORTED, StreamKernels, _combine_scatter, _combine_sort,
    _contrib_dense, _gen_messages,
)
from repro_torch.graph import partition_graph, rmat_graph
from repro_torch.kernels.run_sum import run_sum, run_sum_plain

SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _bits(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else x
    return np.ascontiguousarray(x).view(np.uint32)


def _inputs(seed, rows, E, P, hub_share, active_share):
    """(dp, msg, aact) as the callers hand them over: messages of mixed
    magnitudes (so the order of a sum shows in its bits), a few hub
    destinations taking ``hub_share`` of every row, inactive messages set
    to e0 = 0."""
    rng = np.random.default_rng(seed)
    dp = rng.integers(0, P, (rows, E)).astype(np.int32)
    hub = rng.random((rows, E)) < hub_share
    dp[hub] = rng.integers(0, min(P, 3), int(hub.sum()))
    msg = (rng.standard_normal((rows, E))
           * 10.0 ** rng.integers(-4, 5, (rows, E))).astype(np.float32)
    aact = rng.random((rows, E)) < active_share
    msg = np.where(aact, msg, np.float32(0)).astype(np.float32)
    return dp, msg, aact


def _add_at(n_out, idx, msg) -> np.ndarray:
    out = np.zeros(n_out, np.float32)
    np.add.at(out, idx, msg)
    return out


def _want(P, dp, msg, aact):
    """np.add.at over the flat (rows, E) arrays: A_s and the counts."""
    rows = dp.shape[0]
    idx = (dp.astype(np.int64) + np.arange(rows)[:, None] * P).ravel()
    cnt = np.zeros(rows * P, np.int64)
    np.add.at(cnt, idx, aact.ravel())
    return (_add_at(rows * P, idx, msg.ravel()).reshape(rows, P),
            cnt.reshape(rows, P))


SHAPES = dict(
    rows=st.integers(1, 4), E=st.integers(1, 400), P=st.integers(1, 40),
    hub_share=st.sampled_from([0.0, 0.3, 0.9]),
    active_share=st.sampled_from([0.0, 0.5, 1.0]),
    seed=st.integers(0, 2**31 - 1))


@pytest.mark.parametrize("order", ["dense", "per-call"])
@SETTINGS
@given(**SHAPES)
def test_combine_scatter_equals_np_add_at(order, rows, E, P, hub_share,
                                          active_share, seed):
    """The dense groups' call (the stable order made once, int32, as
    ``PartitionedGraph.dst_order``) and the sparse, recovery and
    fold_batch calls (one stable sort a call) give np.add.at's bits."""
    dp, msg, aact = _inputs(seed, rows, E, P, hub_share, active_share)
    msg_t, dp_t, aact_t = (torch.from_numpy(x) for x in (msg, dp, aact))
    perm = (torch.sort(dp_t, dim=-1, stable=True).indices.to(torch.int32)
            if order == "dense" else None)
    A, cnt = _combine_scatter(PageRank(1), P, msg_t, dp_t, aact_t, perm)
    A_w, cnt_w = _want(P, dp, msg, aact)
    np.testing.assert_array_equal(_bits(A), _bits(A_w))
    np.testing.assert_array_equal(cnt.numpy(), cnt_w)


@SETTINGS
@given(**SHAPES)
def test_basic_sc_sorted_rows_equal_np_add_at(rows, E, P, hub_share,
                                              active_share, seed):
    """basic_sc sorts each row by destination (inactive messages to the
    tail) and adds the sorted runs: a stable sort keeps each slot's
    messages in their order, so the bits are np.add.at's on the rows as
    they were."""
    dp, msg, aact = _inputs(seed, rows, E, P, hub_share, active_share)
    A, cnt = _combine_sort(PageRank(1), P, *(torch.from_numpy(x)
                                             for x in (msg, dp, aact)))
    A_w, cnt_w = _want(P, dp, msg, aact)
    np.testing.assert_array_equal(_bits(A), _bits(A_w))
    np.testing.assert_array_equal(cnt.numpy(), cnt_w)


@SETTINGS
@given(n=st.integers(1, 4), E=st.integers(1, 120), P=st.integers(1, 30),
       hub_share=st.sampled_from([0.0, 0.5]),
       active_share=st.sampled_from([0.2, 1.0]),
       seed=st.integers(0, 2**31 - 1))
def test_basic_receiver_partials_equal_np_add_at(n, E, P, hub_share,
                                                 active_share, seed):
    """basic's receiver: n sources' E_cap slots each, sorted by
    destination; slot src·P + dst of the (n·P) partials, PRESORTED (each
    slot's messages contiguous, the invalid ones at the tail). Equal to
    np.add.at of the received messages into those slots, in the order
    they arrived."""
    dp, msg, aact = _inputs(seed, 1, n * E, P, hub_share, active_share)
    recv_dp = torch.from_numpy(np.where(aact, dp, P))
    sdp, order = torch.sort(recv_dp, dim=-1, stable=True)
    smsg = torch.from_numpy(msg).gather(1, order)
    valid = sdp < P
    slot = order // E * P + torch.where(valid, sdp, 0)
    A, cnt = _combine_scatter(PageRank(1), n * P, smsg, slot, valid,
                              PRESORTED)
    src = np.arange(n * E) // E
    idx = (src * P + dp[0])[aact[0]]
    np.testing.assert_array_equal(
        _bits(A[0]), _bits(_add_at(n * P, idx, msg[0][aact[0]])))
    cnt_w = np.zeros(n * P, np.int64)
    np.add.at(cnt_w, idx, 1)
    np.testing.assert_array_equal(cnt[0].numpy(), cnt_w)


@pytest.fixture(scope="module")
def graph():
    g = rmat_graph(scale=9, edge_factor=8, seed=4, weights="uniform")
    return partition_graph(g, 4, edge_block=64, device="cpu")[0]


def test_dst_order_is_the_stable_sort_of_each_group(graph):
    """Each group's slots by destination, stably, the padding last."""
    pg = graph
    order = pg.dst_order
    assert order.dtype == torch.int32 and order.shape == pg.dst_pos.shape
    key = np.where(pg.src_pos.numpy() >= 0, pg.dst_pos.numpy(), pg.P)
    want = np.argsort(key, axis=-1, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    assert pg.dst_order is order  # made once


@pytest.mark.parametrize("dest_shift", [0, 1, 3])
def test_dense_precomputed_order_equals_the_per_call_sort(graph, dest_shift):
    """One ring round's dense call through the partition's precomputed
    order gives the bits of the same call sorting per call, and of
    np.add.at."""
    pg, prog = graph, PageRank(1)
    rng = np.random.default_rng(dest_shift)
    values = torch.from_numpy(rng.random((pg.n_shards, pg.P),
                                         dtype=np.float32))
    active = torch.from_numpy(rng.random((pg.n_shards, pg.P)) < 0.7) \
        & pg.vmask
    ar = torch.arange(pg.n_shards)
    dest = (ar + dest_shift) % pg.n_shards
    A, cnt = _contrib_dense(prog, pg, values, active, 2, dest)
    sp, dp, w = pg.src_pos[ar, dest], pg.dst_pos[ar, dest], \
        pg.eweight[ar, dest]
    msg, aact = _gen_messages(prog, values, pg.degree, sp, w, active, 2)
    A_call, cnt_call = _combine_scatter(prog, pg.P, msg, dp, aact)
    np.testing.assert_array_equal(_bits(A), _bits(A_call))
    assert torch.equal(cnt, cnt_call)
    A_w, _ = _want(pg.P, dp.numpy(), msg.numpy(), aact.numpy())
    np.testing.assert_array_equal(_bits(A), _bits(A_w))


def test_fold_batch_lanes_equal_np_add_at(graph):
    """The streamed mode's batched fold: each lane's accumulator is
    np.add.at of its staged slots."""
    pg = graph
    kern = StreamKernels(PageRank(1), pg.n_shards, pg.n_vertices, pg.P)
    rng = np.random.default_rng(5)
    values = torch.from_numpy(rng.random((pg.n_shards, pg.P),
                                         dtype=np.float32))
    active = pg.vmask.clone()
    G, slots = 3, 200
    src = torch.tensor([0, 2, 1])
    sp = torch.from_numpy(rng.integers(-1, pg.P, (G, slots)).astype(np.int32))
    dp = torch.from_numpy(rng.integers(0, 4, (G, slots)).astype(np.int32))
    w = torch.ones(G, slots)
    A, cnt = kern.fold_batch(values, pg.degree, active, src, sp, dp, w, 1)
    for g in range(G):
        r = int(src[g])
        msg, aact = _gen_messages(PageRank(1), values[r][None],
                                  pg.degree[r][None], sp[g][None],
                                  w[g][None], active[r][None], 1)
        A_w, cnt_w = _want(pg.P, dp[g][None].numpy(), msg.numpy(),
                           aact.numpy())
        np.testing.assert_array_equal(_bits(A[g]), _bits(A_w[0]))
        np.testing.assert_array_equal(cnt[g].numpy(), cnt_w[0])


def test_min_and_integer_combines_keep_their_scatter(graph):
    """Exact in any order, MIN/MAX and integer sums are not reordered:
    Hash-Min's combine is scatter_reduce_'s amin."""
    rng = np.random.default_rng(1)
    dp = torch.from_numpy(rng.integers(0, 20, (2, 300)).astype(np.int32))
    msg = torch.from_numpy(rng.integers(0, 1000, (2, 300)).astype(np.int32))
    aact = torch.from_numpy(rng.random((2, 300)) < 0.6)
    msg = torch.where(aact, msg, HashMin.combiner.e0)
    A, _ = _combine_scatter(HashMin(), 20, msg, dp, aact)
    idx = (dp.long() + torch.arange(2)[:, None] * 20).reshape(-1)
    want = torch.full((40,), HashMin.combiner.e0, dtype=torch.int32)
    want.scatter_reduce_(0, idx, msg.reshape(-1), "amin")
    assert torch.equal(A.reshape(-1), want)


# --------------------------------------------------------------------------
# kernels/run_sum on the CPU: its plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("perm_dtype", [None, torch.int32, torch.int64])
@SETTINGS
@given(rows=st.integers(1, 3), E=st.integers(1, 600), n_out=st.integers(1, 50),
       skip_share=st.sampled_from([0.0, 0.3]), seed=st.integers(0, 2**31 - 1))
def test_run_sum_plain_equals_np_add_at(perm_dtype, rows, E, n_out,
                                        skip_share, seed):
    """Keys in runs (one run a key, -1 skipped), read directly or through
    a row-relative permutation: each key's values added left to right."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, n_out, (rows, E))
    key[rng.random((rows, E)) < skip_share] = -1
    val = (rng.standard_normal((rows, E))
           * 10.0 ** rng.integers(-4, 5, (rows, E))).astype(np.float32)
    perm = np.argsort(key, axis=-1, kind="stable")
    # one run a key across rows too: row r's keys are r's own
    key = np.where(key >= 0, key + np.arange(rows)[:, None] * n_out, -1)
    order = np.take_along_axis(key, perm, -1).ravel()
    vals = np.take_along_axis(val, perm, -1).ravel()
    want = _add_at(rows * n_out + 1, np.where(order >= 0, order,
                                              rows * n_out), vals)
    want = want[:rows * n_out]
    tk, tv = torch.from_numpy(key), torch.from_numpy(val)
    if perm_dtype is None:  # the caller hands the positions in order
        got = run_sum(torch.from_numpy(np.take_along_axis(key, perm, -1)),
                      torch.from_numpy(np.take_along_axis(val, perm, -1)),
                      rows * n_out)
    else:
        got = run_sum(tk, tv, rows * n_out,
                      torch.from_numpy(perm).to(perm_dtype))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_run_sum_checks_its_inputs():
    key = torch.zeros(2, 3, dtype=torch.int64)
    val = torch.zeros(2, 3)
    with pytest.raises(TypeError, match="int64 keys and float32"):
        run_sum(key.int(), val, 4)
    with pytest.raises(TypeError, match="int64 keys and float32"):
        run_sum(key, val.double(), 4)
    with pytest.raises(ValueError, match=r"\(rows, E\)"):
        run_sum(key.reshape(-1), val.reshape(-1), 4)
    with pytest.raises(ValueError, match="perm"):
        run_sum(key, val, 4, torch.zeros(2, 2, dtype=torch.int32))
    assert torch.equal(run_sum_plain(key, val, 0), torch.zeros(0))
    assert run_sum.launches == 0  # the CPU runs the plain version
