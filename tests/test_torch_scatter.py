"""The torch backend's float sums in one stated order, on the CPU:
``core/engine.py::_combine_scatter`` adds each destination slot's messages
left to right as they stand in the flat message array, through
``kernels/run_sum`` (whose plain version runs here), which is the order of
``np.add.at``. Every caller's input shape is held to ``np.add.at`` bit for
bit: the dense groups with their precomputed order, the sparse and
recovery calls that sort per call, ``basic_sc``'s sorted rows, ``basic``'s
receiver partials, the streamed ``fold_batch`` lanes, the streamed
``fold`` of a group over several staged calls (through ``run_sum``'s
accumulating form) and ``segment_sum``'s sorted runs."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.core import HashMin, PageRank, segment_sum
from repro_torch.core.engine import (
    PRESORTED, StreamKernels, _combine_scatter, _combine_sort,
    _contrib_dense, _gen_messages,
)
from repro_torch.graph import partition_graph, rmat_graph
from repro_torch.kernels.run_sum import (
    mark, marked_order, run_sum, run_sum_plain, unmark,
)

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
    """Each group's slots by destination, stably, the padding last; the
    sign bit marks each group's first position and each where the
    destination (or the padding) changes."""
    pg = graph
    order = pg.dst_order
    assert order.dtype == torch.int32 and order.shape == pg.dst_pos.shape
    key = np.where(pg.src_pos.numpy() >= 0, pg.dst_pos.numpy(), pg.P)
    want = np.argsort(key, axis=-1, kind="stable")
    np.testing.assert_array_equal(unmark(order).numpy(), want)
    sorted_key = np.take_along_axis(key, want, -1)
    starts = np.ones_like(sorted_key, dtype=bool)
    starts[..., 1:] = sorted_key[..., 1:] != sorted_key[..., :-1]
    np.testing.assert_array_equal(order.numpy() < 0, starts)
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


@SETTINGS
@given(calls=st.integers(1, 4), slots=st.integers(1, 300),
       P=st.integers(1, 30), hub_share=st.sampled_from([0.0, 0.5]),
       active_share=st.sampled_from([0.0, 0.5, 1.0]),
       seed=st.integers(0, 2**31 - 1))
def test_fold_over_staged_calls_equals_index_add(calls, slots, P, hub_share,
                                                 active_share, seed):
    """The streamed fold of one group a staged batch at a time into one
    accumulator (``fold_groups``' ``fold_staged``): after each call, A's
    bits are those of ``A.index_add_`` of that call's messages (the fold
    before the ordered route), and of np.add.at over every call's slots
    back to back; the counts too."""
    rng = np.random.default_rng(seed)
    prog = PageRank(1)
    kern = StreamKernels(prog, 1, P, P)
    values = torch.from_numpy((rng.standard_normal(P) * 10.0 ** rng.integers(
        -4, 5, P)).astype(np.float32))
    degree = torch.from_numpy(rng.integers(1, 9, P).astype(np.int32))
    active = torch.from_numpy(rng.random(P) < active_share)
    A, cnt = torch.zeros(P), torch.zeros(P, dtype=torch.int32)
    A_old, seen = torch.zeros(P), []
    for _ in range(calls):
        sp = torch.from_numpy(rng.integers(-1, P, slots).astype(np.int32))
        dp = torch.from_numpy(rng.integers(0, P, slots).astype(np.int32))
        dp[torch.from_numpy(rng.random(slots) < hub_share)] = 0
        w = torch.ones(slots)
        msg, aact = _gen_messages(prog, values[None], degree[None], sp[None],
                                  w[None], active[None], 1)
        A_old.index_add_(0, dp.long(), msg[0])
        out = kern.fold(A, cnt, values, degree, active, sp, dp, w, 1)
        assert out[0] is A and out[1] is cnt  # in place
        np.testing.assert_array_equal(_bits(A), _bits(A_old))
        seen.append((dp.numpy(), msg[0].numpy(), aact[0].numpy()))
    dp, msg, aact = (np.concatenate(x)[None] for x in zip(*seen))
    A_w, cnt_w = _want(P, dp, msg, aact)
    np.testing.assert_array_equal(_bits(A), _bits(A_w[0]))
    np.testing.assert_array_equal(cnt.numpy(), cnt_w[0])


def test_fold_min_keeps_its_scatter(graph):
    """Hash-Min's fold is scatter_reduce_'s amin onto what A holds."""
    pg = graph
    kern = StreamKernels(HashMin(), pg.n_shards, pg.n_vertices, pg.P)
    rng = np.random.default_rng(2)
    values = torch.from_numpy(rng.integers(0, 1000, pg.P).astype(np.int32))
    sp = torch.from_numpy(rng.integers(-1, pg.P, 500).astype(np.int32))
    dp = torch.from_numpy(rng.integers(0, pg.P, 500).astype(np.int32))
    A = torch.full((pg.P,), 500, dtype=torch.int32)
    want = A.clone()
    msg, _ = _gen_messages(HashMin(), values[None], pg.degree[0][None],
                           sp[None], torch.ones(1, 500), pg.vmask[0][None], 1)
    want.scatter_reduce_(0, dp.long(), msg[0], "amin")
    kern.fold(A, torch.zeros(pg.P, dtype=torch.int32), values, pg.degree[0],
              pg.vmask[0], sp, dp, torch.ones(500), 1)
    assert torch.equal(A, want)


@SETTINGS
@given(rows=st.integers(1, 4), M=st.integers(1, 300), P=st.integers(1, 30),
       pad_share=st.sampled_from([0.0, 0.4]), seed=st.integers(0, 2**31 - 1))
def test_segment_sum_equals_np_add_at(rows, M, P, pad_share, seed):
    """segment_sum over destination-sorted rows (padding dst == P at the
    tail): each run added left to right, the bits of np.add.at and of the
    index_add_ it replaced; an int32 sum stays exact."""
    rng = np.random.default_rng(seed)
    dst = np.sort(np.where(rng.random((rows, M)) < pad_share, P,
                           rng.integers(0, P, (rows, M))), axis=-1)
    msg = (rng.standard_normal((rows, M))
           * 10.0 ** rng.integers(-4, 5, (rows, M))).astype(np.float32)
    got = segment_sum(torch.from_numpy(dst.astype(np.int32)),
                      torch.from_numpy(msg), P)
    valid = dst < P
    idx = (dst + np.arange(rows)[:, None] * P)[valid]
    np.testing.assert_array_equal(
        _bits(got.reshape(-1)), _bits(_add_at(rows * P, idx, msg[valid])))
    old = torch.zeros(rows * P).index_add_(
        0, torch.from_numpy(np.where(valid, dst, 0)
                            + np.arange(rows)[:, None] * P).reshape(-1).long(),
        torch.from_numpy(np.where(valid, msg, 0)).reshape(-1))
    np.testing.assert_array_equal(_bits(got.reshape(-1)), _bits(old))
    ints = rng.integers(-1000, 1000, (rows, M)).astype(np.int32)
    got_i = segment_sum(torch.from_numpy(dst.astype(np.int32)),
                        torch.from_numpy(ints), P)
    want_i = np.zeros(rows * P, np.int64)
    np.add.at(want_i, idx, ints[valid])
    np.testing.assert_array_equal(got_i.reshape(-1).numpy(), want_i)


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


@pytest.mark.parametrize("perm_dtype", [None, torch.int32, torch.int64])
@SETTINGS
@given(rows=st.integers(1, 3), E=st.integers(1, 600), n_out=st.integers(1, 50),
       skip_share=st.sampled_from([0.0, 0.3]), seed=st.integers(0, 2**31 - 1))
def test_run_sum_accumulating_equals_index_add(perm_dtype, rows, E, n_out,
                                               skip_share, seed):
    """Given ``out``, each run's chain starts from out[k]: the bits of
    ``out.index_add_`` of the values in position order (the skipped keys
    dropped); keys with no run keep their value; ``out`` is updated in
    place and returned."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, n_out, (rows, E))
    key[rng.random((rows, E)) < skip_share] = -1
    val = (rng.standard_normal((rows, E))
           * 10.0 ** rng.integers(-4, 5, (rows, E))).astype(np.float32)
    perm = np.argsort(key, axis=-1, kind="stable")
    key = np.where(key >= 0, key + np.arange(rows)[:, None] * n_out, -1)
    start = (rng.standard_normal(rows * n_out)
             * 10.0 ** rng.integers(-4, 5, rows * n_out)).astype(np.float32)
    order = np.take_along_axis(key, perm, -1).ravel()
    vals = np.take_along_axis(val, perm, -1).ravel()
    want = torch.from_numpy(start.copy()).index_add_(
        0, torch.from_numpy(order[order >= 0]),
        torch.from_numpy(vals[order >= 0]))
    out = torch.from_numpy(start.copy())
    if perm_dtype is None:
        got = run_sum(torch.from_numpy(np.take_along_axis(key, perm, -1)),
                      torch.from_numpy(np.take_along_axis(val, perm, -1)),
                      rows * n_out, out=out)
    else:
        got = run_sum(torch.from_numpy(key), torch.from_numpy(val),
                      rows * n_out, torch.from_numpy(perm).to(perm_dtype),
                      out=out)
    assert got is out
    np.testing.assert_array_equal(_bits(out), _bits(want))
    untouched = np.setdiff1d(np.arange(rows * n_out), order)
    np.testing.assert_array_equal(_bits(out)[untouched], _bits(start)[untouched])


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
    with pytest.raises(ValueError, match="out"):
        run_sum(key, val, 4, out=torch.zeros(3))
    with pytest.raises(ValueError, match="out"):
        run_sum(key, val, 4, out=torch.zeros(4, dtype=torch.float64))
    assert torch.equal(run_sum_plain(key, val, 0), torch.zeros(0))
    assert run_sum.launches == 0  # the CPU runs the plain version


# --------------------------------------------------------------------------
# run_sum's row-local keys and marked runs, through its plain version and
# the callers that hand them over
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("perm_form", [None, "int32", "int64",
                                       "int32 marked", "int64 marked"])
@SETTINGS
@given(rows=st.integers(1, 3), E=st.integers(1, 600), n_out=st.integers(1, 50),
       skip_share=st.sampled_from([0.0, 0.3]), accumulate=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_run_sum_row_local_keys_equal_np_add_at(key_dtype, perm_form, rows,
                                                E, n_out, skip_share,
                                                accumulate, seed):
    """Row-local keys with the row stride (row r's key k adds at
    r * stride + k), read directly, through a permutation, or through one
    whose sign bit marks the runs (``mark``): np.add.at's bits, or
    ``index_add_``'s onto ``out``; the same bits as the flat int64 form."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, n_out, (rows, E))
    key[rng.random((rows, E)) < skip_share] = -1
    val = (rng.standard_normal((rows, E))
           * 10.0 ** rng.integers(-4, 5, (rows, E))).astype(np.float32)
    perm = np.argsort(key, axis=-1, kind="stable")
    flat = np.where(key >= 0, key + np.arange(rows)[:, None] * n_out, -1)
    order = np.take_along_axis(flat, perm, -1).ravel()
    vals = np.take_along_axis(val, perm, -1).ravel()
    start = rng.standard_normal(rows * n_out).astype(np.float32)
    want = torch.from_numpy(start.copy() if accumulate
                            else np.zeros(rows * n_out, np.float32))
    want.index_add_(0, torch.from_numpy(order[order >= 0]),
                    torch.from_numpy(vals[order >= 0]))
    if not accumulate:
        np.testing.assert_array_equal(
            _bits(want),
            _bits(_add_at(rows * n_out, order[order >= 0], vals[order >= 0])))
    tk, tv = torch.from_numpy(key).to(key_dtype), torch.from_numpy(val)
    marked = perm_form is not None and perm_form.endswith("marked")
    if perm_form is None:
        tk, tv, tp = tk.gather(1, torch.from_numpy(perm)), \
            tv.gather(1, torch.from_numpy(perm)), None
    else:
        tp = torch.from_numpy(perm).to(getattr(torch, perm_form.split()[0]))
        if marked:
            tp = mark(tp, tk)
    out = torch.from_numpy(start.copy()) if accumulate else None
    got = run_sum(tk, tv, rows * n_out, tp, out=out, stride=n_out,
                  marked=marked)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    flat_form = run_sum(
        torch.from_numpy(np.take_along_axis(flat, perm, -1)),
        torch.from_numpy(np.take_along_axis(val, perm, -1)), rows * n_out,
        out=torch.from_numpy(start.copy()) if accumulate else None)
    np.testing.assert_array_equal(_bits(got), _bits(flat_form))


@pytest.mark.parametrize("perm_dtype", [torch.int32, torch.int64])
def test_mark_sets_the_sign_bit_at_each_run_start(perm_dtype):
    """``mark``: the sign bit at each row's first position and wherever the
    key read through the permutation changes (a skipped run too);
    ``unmark`` gives the permutation back; ``marked_order`` is the stable
    sort so marked, in int32."""
    key = torch.tensor([[3, -1, 3, 5, 5, -1], [0, 0, 0, 2, 2, 2]])
    perm = torch.sort(key, dim=-1, stable=True).indices.to(perm_dtype)
    marked = mark(perm, key)
    assert torch.equal(marked_order(key), mark(perm.int(), key))
    assert marked.dtype == perm_dtype
    assert torch.equal(unmark(marked), perm)
    assert (marked < 0).tolist() == [[True, False, True, False, True, False],
                                     [True, False, False, True, False,
                                      False]]


def test_run_sum_checks_row_local_and_marked_inputs():
    key = torch.zeros(2, 3, dtype=torch.int32)
    val = torch.zeros(2, 3)
    perm = torch.zeros(2, 3, dtype=torch.int32)
    assert torch.equal(run_sum(key, val, 6, stride=3), torch.zeros(6))
    assert torch.equal(run_sum(key.long(), val, 6, perm, stride=3),
                       torch.zeros(6))
    with pytest.raises(ValueError, match="stride"):
        run_sum(key, val, 6, stride=-1)
    with pytest.raises(ValueError, match="marked"):
        run_sum(key, val, 6, stride=3, marked=True)
    # marks that are not mark()'s over the keys: refused on the CPU
    runs = torch.tensor([[0, 0, 1], [2, 2, 2]], dtype=torch.int32)
    good = marked_order(runs)
    assert torch.equal(run_sum(runs, val, 9, good, stride=3, marked=True),
                       torch.zeros(9))
    for bad in (unmark(good), good | torch.iinfo(torch.int32).min):
        with pytest.raises(ValueError, match="mark"):
            run_sum(runs, val, 9, bad, stride=3, marked=True)
    with pytest.raises(TypeError, match="int32 row-local keys"):
        run_sum(key.short(), val, 6, stride=3)
    assert run_sum.launches == 0  # the CPU runs the plain version


@pytest.mark.parametrize("dst_dtype", [torch.int32, torch.int64])
def test_segment_sum_hands_run_sum_row_local_keys(dst_dtype):
    """segment_sum's float32 sum through run_sum's row-local form, the
    padding (dst == P) skipped, for int32 and int64 destinations: the bits
    of np.add.at over the flat slots."""
    rng = np.random.default_rng(7)
    rows, M, P = 3, 400, 17
    dst = np.sort(np.where(rng.random((rows, M)) < 0.2, P,
                           rng.integers(0, P, (rows, M))), axis=-1)
    msg = (rng.standard_normal((rows, M))
           * 10.0 ** rng.integers(-4, 5, (rows, M))).astype(np.float32)
    got = segment_sum(torch.from_numpy(dst).to(dst_dtype),
                      torch.from_numpy(msg), P)
    valid = dst < P
    idx = (dst + np.arange(rows)[:, None] * P)[valid]
    np.testing.assert_array_equal(
        _bits(got.reshape(-1)), _bits(_add_at(rows * P, idx, msg[valid])))
