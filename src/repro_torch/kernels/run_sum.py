"""Float32 sums in one stated order: each key's values added left to right.

Replaces no TPU kernel. The reference sums A_s with a jnp scatter-add
(``repro/core/engine.py::_combine_scatter``), which XLA runs in one order on
a TPU or a CPU. PyTorch's ``index_add_`` does too on the CPU, where it adds
each slot's values left to right as they stand; on CUDA it sums with atomics
in the order they reach L2, which changes from run to run. This kernel adds
in the CPU's order on the card, so the torch backend's float sums are the
same bits on the card as on the CPU, and the same from run to run
(its callers: ``core/engine.py::_combine_scatter`` and
``StreamKernels.fold``, and ``core/api.py::segment_sum``).

The function: positions ``j`` of a ``(rows, E)`` layout read in order, each
through ``perm`` (row ``r``'s position ``j`` reads slot ``perm[r, j]`` of
row ``r``) where one is given; the keys so read stand in runs, one run a
key, and a negative key is skipped. Keys are flat (int64), or row-local
with a ``stride`` (int32 or int64; row ``r``'s key ``k`` is the flat key
``r * stride + k``), as every caller has them: no caller builds a flat
key. ``out[k]`` is ``((0 + v_1) + v_2) + ...`` over the run of key ``k``, 0
where ``k`` has none. With ``perm`` the stable sort of the keys, that is
``torch.zeros(n_out).index_add_(0, key, val)`` on the CPU, bit for bit.
Given ``out``, the sums accumulate into it: each run's chain starts from
``out[k]``, ``((out[k] + v_1) + v_2) + ...``, and a key with no run keeps its
value, which is ``out.index_add_(0, key, val)`` on the CPU (the streamed
fold, ``core/engine.py::StreamKernels.fold``, folds a long group into one
accumulator a staged batch at a time). ``marked``: perm's sign bit marks
each position whose key is not the one before's (``mark``; the dense
groups' ``PartitionedGraph.dst_order`` is so marked), and the kernel reads a
key only there.

Bound on the card: bytes, and the longest run's chain of dependent adds
(4 cycles each). A position reads its value at a random slot, and its key
there too unless the runs are marked; a slot's sum is written once. The
design (``csrc/run_sum.cu``): one kernel, its blocks claiming tiles of
2,048 positions in order from a counter; a block reads its tile through
the permutation into shared memory (all its random reads in flight at
once, no scratch, nothing read twice), marks the runs' boundaries with
ballots (or takes the marks), and the thread owning a run's first position
adds the run from shared memory; a run that goes on past the tile's end
hands its chain to the next tile (its sum, then a flag), whose first
thread goes on with it. A hub's chain so waits on shared memory, never on
device memory. On an NVIDIA H100 80GB HBM3 at 700 W, one dense ring round
at RMAT scale 24 (33.6 M positions, the longest run 30,197) takes 0.637 ms
for the kernel and 0.665 ms for the call (the zero fill included), against
``index_add_``'s 0.751 unordered and the first design's 2.090
(``chip_smoke.py`` phase 2, ``tools/rs_ablation.py``; PERF.md §6).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def _check(key, val, n_out, perm, out, stride, marked):
    if val.dim() != 2 or key.shape != val.shape:
        raise ValueError(f"run_sum takes (rows, E) key and val, got "
                         f"{tuple(key.shape)} and {tuple(val.shape)}")
    keys = (torch.int64,) if stride is None else (torch.int32, torch.int64)
    if key.dtype not in keys or val.dtype != torch.float32:
        raise TypeError(f"run_sum takes int64 keys and float32 values (or "
                        f"int32 row-local keys with a stride), got "
                        f"{key.dtype} and {val.dtype}")
    if stride is not None and stride < 0:
        raise ValueError(f"stride must be >= 0, got {stride}")
    if perm is not None and (perm.shape != val.shape or perm.dtype not in (
            torch.int32, torch.int64)):
        raise ValueError("perm must be int32 or int64 of val's shape")
    if marked and perm is None:
        raise ValueError("marked needs a perm, whose sign bit marks the runs")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if out is not None and (out.shape != (n_out,)
                            or out.dtype != torch.float32):
        raise ValueError(f"out must be ({n_out},) float32, got "
                         f"{tuple(out.shape)} {out.dtype}")


def mark(perm, key):
    """``perm`` (rows, E) with its sign bit set where the keys it reads,
    ``key.gather(1, perm)``, start a run: at each row's first position and
    wherever a key is not the one before's (see ``run_sum(marked=True)``)."""
    k = key.gather(1, perm.long())
    start = torch.ones_like(k, dtype=torch.bool)
    start[:, 1:] = k[:, 1:] != k[:, :-1]
    return torch.where(start, perm | torch.iinfo(perm.dtype).min, perm)


def marked_order(key):
    """(rows, E) int32: each row's stable sort of ``key`` (its slots in key
    order), marked for ``run_sum(..., marked=True)`` over those keys."""
    return mark(torch.sort(key, dim=-1, stable=True).indices.int(), key)


def unmark(perm):
    """A marked permutation's slots: its values without the sign bit."""
    return perm & torch.iinfo(perm.dtype).max


def run_sum_plain(key, val, n_out: int, perm=None, out=None, stride=None,
                  marked=False):
    """The plain PyTorch version: the values gathered into position order,
    then ``index_add_`` (on the CPU, each key's values left to right), into
    zeros or, given, into ``out``. It reads every key: a marked
    permutation's marks go unread."""
    if perm is not None:
        perm = (unmark(perm) if marked else perm).long()
        key, val = key.gather(1, perm), val.gather(1, perm)
    if stride is not None:  # row-local keys: the flat key r * stride + key
        row = torch.arange(key.shape[0], device=key.device)[:, None]
        key = torch.where(key >= 0, key.long() + row * stride, -1)
    key, val = key.reshape(-1), val.reshape(-1)
    # skipped positions land in one slot past the end, dropped after
    key = torch.where(key >= 0, key, n_out)
    buf = torch.zeros(n_out + 1, dtype=val.dtype, device=val.device)
    if out is None:
        return buf.index_add_(0, key, val)[:n_out]
    buf[:n_out] = out
    return out.copy_(buf.index_add_(0, key, val)[:n_out])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("run_sum")
    lib.run_sum_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.run_sum_f32.restype = ctypes.c_int
    lib.run_sum_tile.argtypes = []
    lib.run_sum_tile.restype = ctypes.c_int
    lib.run_sum_work_bytes.argtypes = [ctypes.c_longlong]
    lib.run_sum_work_bytes.restype = ctypes.c_longlong
    lib.run_sum_error_string.argtypes = [ctypes.c_int]
    lib.run_sum_error_string.restype = ctypes.c_char_p
    return lib


def tile() -> int:
    """The positions a block of the kernel adds; a run longer than the rest
    of its tile is carried to the next (builds the kernel: card only)."""
    return _lib().run_sum_tile()


def _launch(key, val, n_out, perm, out, stride, marked):
    for name, t in (("key", key), ("val", val), ("perm", perm),
                    ("out", out)):
        if t is not None and (t.device != val.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {val.device}")
    rows, E = val.shape
    accumulate = out is not None
    if not accumulate:
        out = torch.zeros(n_out, dtype=torch.float32, device=val.device)
    lib = _lib()
    # the tile counter, and a flag and a carried sum a tile
    work = torch.empty(lib.run_sum_work_bytes(rows * E), dtype=torch.uint8,
                       device=val.device)
    rc = lib.run_sum_f32(
        out.data_ptr(), key.data_ptr(), key.element_size() * 8,
        val.data_ptr(), None if perm is None else perm.data_ptr(),
        0 if perm is None else perm.element_size() * 8, int(marked),
        max(E, 1), rows * E,
        stride or 0, int(accumulate), work.data_ptr(),
        torch.cuda.current_stream(val.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"run_sum launch failed ({rc}): "
                           f"{lib.run_sum_error_string(rc).decode()}")
    run_sum.launches += 1
    return out


def run_sum(key, val, n_out: int, perm=None, out=None, stride=None,
            marked=False):
    """``out`` (n_out,) float32: each key's values added left to right,
    from 0, or from ``out[k]`` where an ``out`` is given (then updated in
    place and returned).

    key (rows, E): int64 flat keys in [0, n_out), or, given a ``stride``,
    int32 or int64 row-local keys, row r's key k standing for the flat key
    ``r * stride + k``; a negative key is skipped. val (rows, E) float32;
    perm (rows, E) int32 or int64 row-relative slots, or None (positions
    are slots). The flat keys read in position order must stand in runs,
    one run a key: on the card two runs of one key would race. ``marked``:
    perm's sign bits are those ``mark`` sets over ``key`` (as
    ``marked_order`` and so ``PartitionedGraph.dst_order`` give them); the
    kernel then reads a key only at a run's first position. On the card
    nothing checks the marks: other marks give other sums.

    CPU tensors take the plain version (which checks the marks, and raises
    ValueError where they are not ``mark``'s); CUDA tensors launch the
    kernel."""
    _check(key, val, n_out, perm, out, stride, marked)
    if val.device.type == "cpu":
        if marked and not torch.equal(mark(unmark(perm), key), perm):
            raise ValueError("marked: perm's sign bits are not the run "
                             "starts that mark() sets over key")
        return run_sum_plain(key, val, n_out, perm, out, stride, marked)
    if val.device.type != "cuda":
        raise ValueError(f"run_sum runs on cpu or cuda, not {val.device}")
    return _launch(key, val, n_out, perm, out, stride, marked)


#: kernel launches (not plain-version calls) since the count was last reset
run_sum.launches = 0
