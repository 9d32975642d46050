"""Float32 sums in one stated order: each key's values added left to right.

Replaces no TPU kernel. The reference sums A_s with a jnp scatter-add
(``repro/core/engine.py::_combine_scatter``), which XLA runs in one order on
a TPU or a CPU. PyTorch's ``index_add_`` does too on the CPU, where it adds
each slot's values left to right as they stand; on CUDA it sums with atomics
in the order they reach L2, which changes from run to run. This kernel adds
in the CPU's order on the card, so the torch backend's float sums are the
same bits on the card as on the CPU, and the same from run to run
(``core/engine.py::_combine_scatter`` is its one caller in the engine).

The function: positions ``j`` of a ``(rows, E)`` layout read in order, each
through ``perm`` (row ``r``'s position ``j`` reads slot ``perm[r, j]`` of
row ``r``) where one is given; the keys so read stand in runs, one run a
key, and a key of -1 is skipped. ``out[k]`` is ``((0 + v_1) + v_2) + ...``
over the run of key ``k``, 0 where ``k`` has none. With ``perm`` the stable
sort of the keys, that is ``torch.zeros(n_out).index_add_(0, key, val)``
on the CPU, bit for bit.

Bound on the card: bytes, and the longest run's chain of dependent adds.
Per position it reads a key (8 B), a value (4 B) and, where given, the
permutation (4 or 8 B); per slot it writes 4 B; one add a position. A
run's sum is one chain, so a run of L values takes L dependent adds
whatever the card. Design (``csrc/run_sum.cu``): with a permutation, a
gather kernel first copies each position's key and value into scratch in
position order (every random read independent, all in flight at once);
then one thread a position: the thread at a run's first position adds the
run left to right in one register, loading 16 contiguous positions a step,
and writes the sum. The gather comes first because walking the runs
through the permutation puts the random reads on a hub's chain (10.4 ms
against ``index_add_``'s 0.75 ms for one dense ring round at RMAT scale 24
on an H100, PERF.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def _check(key, val, n_out, perm):
    if val.dim() != 2 or key.shape != val.shape:
        raise ValueError(f"run_sum takes (rows, E) key and val, got "
                         f"{tuple(key.shape)} and {tuple(val.shape)}")
    if key.dtype != torch.int64 or val.dtype != torch.float32:
        raise TypeError(f"run_sum takes int64 keys and float32 values, got "
                        f"{key.dtype} and {val.dtype}")
    if perm is not None and (perm.shape != val.shape or perm.dtype not in (
            torch.int32, torch.int64)):
        raise ValueError("perm must be int32 or int64 of val's shape")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")


def run_sum_plain(key, val, n_out: int, perm=None):
    """The plain PyTorch version: the values gathered into position order,
    then ``index_add_`` (on the CPU, each key's values left to right)."""
    if perm is not None:
        perm = perm.long()
        key, val = key.gather(1, perm), val.gather(1, perm)
    key, val = key.reshape(-1), val.reshape(-1)
    # skipped positions land in one slot past the end, dropped after
    key = torch.where(key >= 0, key, n_out)
    out = torch.zeros(n_out + 1, dtype=val.dtype, device=val.device)
    return out.index_add_(0, key, val)[:n_out]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("run_sum")
    lib.run_sum_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong] + [
        ctypes.c_void_p] * 3
    lib.run_sum_f32.restype = ctypes.c_int
    lib.run_sum_error_string.argtypes = [ctypes.c_int]
    lib.run_sum_error_string.restype = ctypes.c_char_p
    return lib


def _launch(key, val, n_out, perm):
    for name, t in (("key", key), ("val", val), ("perm", perm)):
        if t is not None and (t.device != val.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {val.device}")
    rows, E = val.shape
    dev = val.device
    out = torch.zeros(n_out, dtype=torch.float32, device=dev)
    if perm is None:
        bits, scratch = 0, (None, None)
    else:  # the keys and values in position order
        bits = perm.element_size() * 8
        scratch = (torch.empty(rows * E, dtype=torch.int64, device=dev),
                   torch.empty(rows * E, dtype=torch.float32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    rc = lib.run_sum_f32(out.data_ptr(), key.data_ptr(), val.data_ptr(),
                         None if perm is None else perm.data_ptr(), bits,
                         max(E, 1), rows * E,
                         *(None if t is None else t.data_ptr()
                           for t in scratch), stream)
    if rc != 0:
        raise RuntimeError(f"run_sum launch failed ({rc}): "
                           f"{lib.run_sum_error_string(rc).decode()}")
    run_sum.launches += 1
    return out


def run_sum(key, val, n_out: int, perm=None):
    """``out`` (n_out,) float32: each key's values added left to right.

    key (rows, E) int64, keys in [0, n_out) or -1 (skipped); val (rows, E)
    float32; perm (rows, E) int32 or int64 row-relative slots, or None
    (positions are slots). The keys read in position order must stand in
    runs, one run a key: on the card two runs of one key would race.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(key, val, n_out, perm)
    if val.device.type == "cpu":
        return run_sum_plain(key, val, n_out, perm)
    if val.device.type != "cuda":
        raise ValueError(f"run_sum runs on cpu or cuda, not {val.device}")
    return _launch(key, val, n_out, perm)


#: kernel launches (not plain-version calls) since the count was last reset
run_sum.launches = 0
