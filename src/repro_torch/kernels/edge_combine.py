"""Fused edge-stream combine (the paper's U_c hot loop, §3.2 + §5), one ring
round for all n shards at once.

Replaces the TPU kernel ``repro/kernels/edge_combine.py::edge_combine_group``
(Pallas, body ``_kernel``), whose contract is ``edge_combine_ref``'s: for
each shard i, over the kept blocks ``blk_ids[i, :n_keep[i]]`` of group
``(i, dest[i])``, gather each edge's source value, degree and active flag,
form the message by ``msg_kind``, mask inactive and padding edges to the
combiner identity, combine into A_s and count the active messages per
destination.

The TPU kernel reads a re-tiled ``KernelLayout`` whose blocks each lie in
one SRC_WIN and one DST_WIN window, because Mosaic has no vector gather or
scatter; at real sizes that layout is mostly padding. Hopper gathers and
scatters natively, so this kernel reads the partition's own source-sorted
blocks in place: ``src_pos/dst_pos/eweight`` viewed as ``(n, n, NB, BLK)``.

Bound on the card: bytes. Per kept edge slot it reads sp (4 B); per edge
whose source is active it gathers the source's state and reads dp (4 B),
and w (4 B) for ``add_w``; per vertex it writes 8 B (A_s, cnt); it does a
few operations per edge, far under the card's compute. What holds it back
in practice is the number of scattered atomics: the L2 takes each as its
own transaction. Design (``csrc/edge_combine.cu``): a persistent grid
walks a work list of every shard's kept blocks, which each CTA builds from
the ``n_keep`` prefix on the card, so skip() costs no host sync and a
sparse frontier no grid of returning CTAs. Float sums may take a paired
path (``pair_counts``: only where ``E_cap`` is below 2^24, so a count
stays exact in float32): the message and its count land as one ``float2``
atomicAdd into an interleaved buffer, half the atomics, and a split pass
writes A_s and the int32 counts. The split costs 16 B per vertex slot, so
the card takes the path only for a launch whose active sources promise
many messages. Other combines take an atomic on A_s and one on cnt; float
min/max use the ordered-int trick. The C entry point also pre-fills the
outputs, so a call is one ctypes call. Float sums land in the order the
atomics reach L2, which changes from run to run, so they are not
bit-reproducible (PageRank holds to 1e-5, as the JAX package's kernel
backend does against its plain one); min, max, int32 and counts are exact.

Two TPU workarounds are not carried over: values are not clamped from ±inf
to ±1e30 (no one-hot product, so unreached SSSP/BFS vertices stay ``inf``),
and int32 values are not cast to float32 (the ``copy`` kind runs natively
in int32, so Hash-Min labels above 2^24 stay exact).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MSG_KINDS = ("div_deg", "add_w", "add_1", "copy", "deg")
COMBINERS = ("sum", "min", "max")
#: message kinds the int32 path takes
INT_KINDS = ("copy",)


def identity(combiner: str, dtype: torch.dtype):
    """The combiner identity e0 in ``dtype`` (int32 or float32)."""
    if dtype == torch.int32:
        return {"sum": 0, "min": 2**31 - 1, "max": -(2**31)}[combiner]
    return {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[combiner]


def pair_counts(dtype: torch.dtype, combiner: str, E_cap: int) -> bool:
    """Whether a launch may take the paired path, which carries each count
    as a float32 beside its message: float32 sums only, and only where a
    count stays exact in float32, i.e. below 2^24. No destination of a group
    receives more than ``E_cap`` messages, so the shape decides; the card
    then takes the path for a launch with many active sources."""
    return dtype == torch.float32 and combiner == "sum" and E_cap < 2**24


def _message(kind: str, vals, degs, w):
    if kind == "div_deg":
        return vals / degs.clamp(min=1).to(vals.dtype)
    if kind == "add_w":
        return vals + w
    if kind == "add_1":
        return vals + 1.0
    if kind == "copy":
        return vals
    return degs.to(vals.dtype)  # "deg"


def _check(values, sp, msg_kind, combiner):
    if msg_kind not in MSG_KINDS or combiner not in COMBINERS:
        raise ValueError(f"unknown msg_kind/combiner {msg_kind!r}/{combiner!r}")
    if values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"values must be float32 or int32, got {values.dtype}")
    if values.dtype == torch.int32 and msg_kind not in INT_KINDS:
        raise ValueError(f"int32 values take msg_kind in {INT_KINDS}, "
                         f"got {msg_kind!r}")
    if sp.dim() != 4 or sp.shape[0] != values.shape[0]:
        raise ValueError(f"sp must be (n, n, NB, BLK) with n = "
                         f"{values.shape[0]}, got {tuple(sp.shape)}")


def edge_combine_plain(values, degree, active, sp, dp, w, dest, blk_ids,
                       n_keep, *, msg_kind: str, combiner: str):
    """The plain PyTorch version of the kernel: the same function, with a
    copy of the kept blocks, gathers and ``index_add_``/``scatter_reduce_``."""
    n, P = values.shape
    NB = sp.shape[2]
    dev = values.device
    ar = torch.arange(n, device=dev)[:, None]
    ids = blk_ids.long()
    keep = (torch.arange(NB, device=dev)[None, :] < n_keep[:, None])[..., None]
    pick = lambda a: a[ar, dest.long()[:, None], ids]  # (n, NB, BLK)
    spf = torch.where(keep, pick(sp), -1).reshape(n, -1)
    dpf = torch.where(keep, pick(dp), 0).reshape(n, -1)
    wf = torch.where(keep, pick(w), 0.0).reshape(n, -1)
    spc = spf.clamp(min=0).long()
    act = (spf >= 0) & active.gather(1, spc)
    e0 = identity(combiner, values.dtype)
    msg = _message(msg_kind, values.gather(1, spc), degree.gather(1, spc), wf)
    msg = torch.where(act, msg, e0).reshape(-1)
    idx = (dpf.long() + ar * P).reshape(-1)
    out = torch.full((n * P,), e0, dtype=values.dtype, device=dev)
    if combiner == "sum":
        out.index_add_(0, idx, msg)
    else:
        out.scatter_reduce_(0, idx, msg, "a" + combiner, include_self=True)
    cnt = torch.zeros(n * P, dtype=torch.int32, device=dev)
    cnt.index_add_(0, idx, act.reshape(-1).to(torch.int32))
    return out.view(n, P), cnt.view(n, P)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("edge_combine")
    ptrs = [ctypes.c_void_p] * 13
    ints = [ctypes.c_int] * 4
    lib.edge_combine_f32.argtypes = ptrs + ints + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.edge_combine_i32.argtypes = ptrs + ints + [ctypes.c_int,
                                                   ctypes.c_void_p]
    lib.edge_combine_f32.restype = lib.edge_combine_i32.restype = ctypes.c_int
    lib.edge_combine_error_string.argtypes = [ctypes.c_int]
    lib.edge_combine_error_string.restype = ctypes.c_char_p
    return lib


_DTYPES = dict(degree=torch.int32, active=torch.bool, sp=torch.int32,
               dp=torch.int32, w=torch.float32, dest=torch.int32,
               blk_ids=torch.int32, n_keep=torch.int32)


def _launch(values, degree, active, sp, dp, w, dest, blk_ids, n_keep,
            msg_kind, combiner):
    args = dict(degree=degree, active=active, sp=sp, dp=dp, w=w, dest=dest,
                blk_ids=blk_ids, n_keep=n_keep)
    for name, t in [("values", values), *args.items()]:
        if t.device != values.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {values.device}")
        if name != "values" and t.dtype != _DTYPES[name]:
            raise TypeError(f"{name} must be {_DTYPES[name]}, got {t.dtype}")
    n, P = values.shape
    _, _, NB, BLK = sp.shape
    if dp.shape != sp.shape or w.shape != sp.shape or \
            blk_ids.shape != (n, NB) or dest.shape != (n,) or \
            n_keep.shape != (n,) or degree.shape != (n, P) or \
            active.shape != (n, P):
        raise ValueError("edge_combine: inconsistent shapes")
    # the C call pre-fills the outputs (or the pairs) itself
    out = torch.empty((n, P), dtype=values.dtype, device=values.device)
    cnt = torch.empty((n, P), dtype=torch.int32, device=values.device)
    pair = pair_counts(values.dtype, combiner, NB * BLK)
    ptrs = [t.data_ptr() for t in (values, degree, active, sp, dp, w, dest,
                                   blk_ids, n_keep, out, cnt)]
    if pair:  # scratch: the pairs and the count of active sources
        pairs = torch.empty((n, P, 2), dtype=torch.float32,
                            device=values.device)
        count = torch.empty(1, dtype=torch.int32, device=values.device)
        ptrs += [pairs.data_ptr(), count.data_ptr()]
    else:
        ptrs += [None, None]
    stream = torch.cuda.current_stream(values.device).cuda_stream
    lib = _lib()
    comb = COMBINERS.index(combiner)
    if values.dtype == torch.int32:
        rc = lib.edge_combine_i32(*ptrs, n, P, NB, BLK, comb, stream)
    else:
        rc = lib.edge_combine_f32(*ptrs, n, P, NB, BLK,
                                  MSG_KINDS.index(msg_kind), comb, int(pair),
                                  stream)
    if rc != 0:
        raise RuntimeError(f"edge_combine launch failed ({rc}): "
                           f"{lib.edge_combine_error_string(rc).decode()}")
    edge_combine.launches += 1
    return out, cnt


def edge_combine(values, degree, active, sp, dp, w, dest, blk_ids, n_keep,
                 *, msg_kind: str, combiner: str):
    """A_s, cnt for group ``(i, dest[i])`` of every shard i.

    values (n, P) float32 or int32; degree (n, P) int32; active (n, P) bool;
    sp/dp (n, n, NB, BLK) int32 and w (n, n, NB, BLK) float32, the
    partition's groups (padding: sp = -1); dest (n,) int32; blk_ids (n, NB)
    int32 with the kept blocks first; n_keep (n,) int32. Returns A_s (n, P)
    in the values' dtype and cnt (n, P) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(values, sp, msg_kind, combiner)
    if values.device.type == "cpu":
        return edge_combine_plain(values, degree, active, sp, dp, w, dest,
                                  blk_ids, n_keep, msg_kind=msg_kind,
                                  combiner=combiner)
    if values.device.type != "cuda":
        raise ValueError(f"edge_combine runs on cpu or cuda, not "
                         f"{values.device}")
    return _launch(values, degree, active, sp, dp, w, dest, blk_ids, n_keep,
                   msg_kind, combiner)


#: kernel launches (not plain-version calls) since the count was last reset
edge_combine.launches = 0
