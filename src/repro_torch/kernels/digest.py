"""Streaming A_r digest (paper §5, in-memory message digesting): the ring's
U_r step, A_r' = combine(A_r, recv) fused with cnt' = cnt + rcnt.

Replaces the TPU kernel ``repro/kernels/digest.py::digest`` (Pallas, body
``_kernel``), which streams the buffers HBM->VMEM in (1, WIN) tiles.

Bound on the card: bytes. Four inputs read once and two outputs written once
(24 B per slot for float32 or int32 values with int32 counts), no reuse, no
atomics, no shared memory. Design: one Triton program per BLOCK slots of the
flattened buffers, with masked block loads and stores; Triton's vectorized
loads reach the card's bandwidth on such a pass with no hand-tuning.
"""

import functools

import torch

COMBINERS = ("sum", "min", "max")
BLOCK = 1024


def digest_plain(A_r, cnt, recv, rcnt, *, combiner: str):
    """The plain PyTorch version of the kernel."""
    if combiner == "sum":
        A = A_r + recv
    elif combiner == "min":
        A = torch.minimum(A_r, recv)
    else:
        A = torch.maximum(A_r, recv)
    return A, cnt + rcnt


@functools.lru_cache(maxsize=None)
def _kernel():
    """Compile-on-first-use Triton kernel. ``triton`` is imported here and
    not at module import, so the module imports where there is no triton;
    ``tl`` is bound at module level because Triton resolves a kernel's names
    through its module globals."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def digest_kernel(a_ptr, c_ptr, r_ptr, rc_ptr, out_ptr, ocnt_ptr, N,
                      COMB: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < N
        a = tl.load(a_ptr + offs, mask=mask)
        r = tl.load(r_ptr + offs, mask=mask)
        if COMB == 0:
            o = a + r
        elif COMB == 1:
            o = tl.minimum(a, r)
        else:
            o = tl.maximum(a, r)
        tl.store(out_ptr + offs, o, mask=mask)
        c = tl.load(c_ptr + offs, mask=mask)
        rc = tl.load(rc_ptr + offs, mask=mask)
        tl.store(ocnt_ptr + offs, c + rc, mask=mask)

    return digest_kernel


def _launch(A_r, cnt, recv, rcnt, combiner):
    for name, t in (("cnt", cnt), ("recv", recv), ("rcnt", rcnt)):
        if t.device != A_r.device or not t.is_contiguous() or \
                t.shape != A_r.shape:
            raise ValueError(f"{name} must be contiguous, of A_r's shape, "
                             f"on {A_r.device}")
    if not A_r.is_contiguous() or recv.dtype != A_r.dtype or \
            A_r.dtype not in (torch.float32, torch.int32) or \
            cnt.dtype != torch.int32 or rcnt.dtype != torch.int32:
        raise TypeError("digest takes contiguous float32/int32 A_r and recv "
                        "and int32 counts")
    out = torch.empty_like(A_r)
    ocnt = torch.empty_like(cnt)
    N = A_r.numel()
    grid = ((N + BLOCK - 1) // BLOCK,)
    with torch.cuda.device(A_r.device):
        _kernel()[grid](A_r, cnt, recv, rcnt, out, ocnt, N,
                        COMB=COMBINERS.index(combiner), BLOCK=BLOCK,
                        num_warps=4)
    digest.launches += 1
    return out, ocnt


def digest(A_r, cnt, recv, rcnt, *, combiner: str):
    """(combine(A_r, recv), cnt + rcnt), elementwise over any equal shapes.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if A_r.device.type == "cpu":
        return digest_plain(A_r, cnt, recv, rcnt, combiner=combiner)
    if A_r.device.type != "cuda":
        raise ValueError(f"digest runs on cpu or cuda, not {A_r.device}")
    return _launch(A_r, cnt, recv, rcnt, combiner)


#: kernel launches (not plain-version calls) since the count was last reset
digest.launches = 0
