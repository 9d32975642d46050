"""Roofline of a GraphD superstep on one NVIDIA H100: the GraphD half of the
reference's ``repro/launch/roofline.py``.

Three terms a rank a superstep, in seconds, from the byte and operation
counts of ``launch/dryrun.py`` (edge_combine's from ``edge_combine_work``) (the reference reads them from XLA's cost
analysis of a lowered superstep; the port has no compiler to ask):

  compute    = operations / FP32 peak      (GraphD's superstep has no
                                            tensor-core work)
  memory     = HBM bytes / HBM rate
  collective = bytes handed the backend / a link rate the caller measured

The rates are the card's, NVIDIA's H100 SXM data sheet (dense, at the full
700 W power limit; ``nvidia-smi --query-gpu=name,power.limit`` says what a
card is set to): 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of
HBM3, 80 GB of it. No link rate is assumed: NVLink's 450 GB/s a direction
is a data-sheet ceiling, not what NCCL's ring achieves, so the collective
term is computed only at a rate the caller passes (``chip_smoke.py``'s
phase 14 times ``ProcessMesh.ring_shift`` under NCCL), and is None without
one.

The reference's ``collective_bytes_from_text`` parses XLA's HLO text and has
no counterpart here. Its language-model branch waits for ROADMAP item 12.4
(the LM dry run).
"""

from __future__ import annotations

#: bytes/s of HBM3 (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: float32 FLOP/s on the CUDA cores, outside the tensor cores (H100 SXM
#: data sheet; it gives no int32 vector rate, and float32's stands in)
F32_FLOPS_PER_S = 67e12
#: bf16 FLOP/s on the tensor cores, dense, without sparsity (H100 SXM data
#: sheet: 989 TFLOP/s); ``chip_smoke.py`` bounds the LM prefill by it
BF16_DENSE_FLOPS_PER_S = 989e12
#: bytes of device memory (H100 SXM data sheet: 80 GB)
HBM_CAPACITY_BYTES = 80e9
#: per source vertex, the state a message kind reads: values 4 B, degree
#: 4 B, active flag 1 B
STATE_BYTES = {"div_deg": 9, "add_w": 5, "add_1": 5, "copy": 5, "deg": 5}


def edge_combine_work(kind: str, n: int, P: int, kept_slots: int,
                      kept_blocks: int, msgs: int, sources: int,
                      active_sources: int) -> tuple[float, float]:
    """(bytes, operations) that one edge_combine launch over n groups must
    move and do: sp of every kept slot; dp (and w for add_w) of each edge
    whose source is active, i.e. of each message; the active flag of each
    source a kept slot names and the rest of the kind's state of each
    active one, once; A_s and cnt written once; the kept block ids, dest
    and n_keep. Each message takes a message op, a combine and a count.
    ``chip_smoke.py`` bounds the kernel by it, and the dry run's HBM term
    counts a rank's groups by it."""
    nbytes = (4 * kept_slots + (8 if kind == "add_w" else 4) * msgs
              + sources + (STATE_BYTES[kind] - 1) * active_sources
              + 8 * n * P + 4 * kept_blocks + 8 * n)
    return nbytes, 3 * msgs


def roofline_terms(cfg, shape_info, *, flops, bytes_accessed,
                   collective_bytes, n_chips, graphd=None,
                   link_bytes_per_s=None) -> dict:
    """The three terms (seconds a superstep a rank), the dominant one, and
    the useful-work ratio of a PageRank superstep, as the reference counts
    it. ``t_collective_s`` is None, and takes no part in ``dominant`` or
    ``roofline_fraction``, where no ``link_bytes_per_s`` is given."""
    if cfg is not None:
        raise NotImplementedError(
            "the language-model roofline waits for ROADMAP item 12.4 (the LM "
            "dry run); the port prices GraphD cells only")
    t_compute = flops / F32_FLOPS_PER_S
    t_memory = bytes_accessed / HBM_BYTES_PER_S
    t_collective = (collective_bytes / link_bytes_per_s
                    if link_bytes_per_s else None)
    terms = dict(compute=t_compute, memory=t_memory)
    if t_collective is not None:
        terms["collective"] = t_collective
    dominant = max(terms, key=terms.get)

    model_flops_per_chip = 0.0
    if graphd is not None:
        # useful work of a PageRank superstep: ~10 flops/edge + 2/vertex
        model_flops_per_chip = (10 * graphd["E"] + 2 * graphd["V"]) / graphd["n"]
    ratio = model_flops_per_chip / flops if flops else 0.0
    return dict(
        t_compute_s=t_compute,
        t_memory_s=t_memory,
        t_collective_s=t_collective,
        dominant=dominant,
        model_flops_per_chip=model_flops_per_chip,
        useful_flops_ratio=ratio,
        roofline_fraction=round(
            model_flops_per_chip / F32_FLOPS_PER_S
            / max(max(terms.values()), 1e-30), 4
        ),
    )
