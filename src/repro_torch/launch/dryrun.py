"""The dry-run GraphD cell: what one PageRank superstep costs a GPU of an
n-GPU mesh at the paper's own sizes, from the partition's shape alone.

The reference (``repro/launch/dryrun.py::run_graphd_cell``) lowers and
compiles one superstep over 256 TPU chips (512 for ``multi_pod``) with
``ShapeDtypeStruct`` inputs and reads XLA's cost and memory analyses. The
port has no compiler to ask, so it counts what ``GraphDEngine(mesh=)`` does
a rank a superstep: the bytes each collective hands the backend (what
``core.collectives.ProcessMesh`` counts), the HBM bytes the superstep's
kernels must move, the operations they do, and the device memory a rank
holds. It is host arithmetic: it builds no device tensor (the abstract
partition lies on ``meta``), starts no process group and imports no
``torch.distributed`` backend.

The record has the reference's keys with the same meaning, less
``lower_s`` and ``compile_s`` (there is nothing to lower or compile), plus
``P``, ``E_cap``, ``n_blocks`` and ``fits`` (``peak_bytes`` within the
card's memory, the role of the reference's memory analysis).

    python -m repro_torch.launch.dryrun --graphd [--multipod]
        [--scale clueweb|webuk] [--mode recoded] [--edge-block 4096]
        [--link-bytes-per-s RATE] [--out FILE]

The language-model cells (``--arch``/``--shape``/``--all``) wait for
ROADMAP item 12.
"""

from __future__ import annotations

import argparse
import json
import math
import os

from repro_torch.launch.roofline import (
    HBM_CAPACITY_BYTES, edge_combine_work, roofline_terms,
)

#: |V|, |E| of the paper's Table 1
SIZES = dict(
    clueweb=(978_408_098, 42_574_107_469),
    webuk=(133_633_040, 5_507_679_822),
)
#: the reference's vertex padding for the cell
VERTEX_PAD = 512
#: the in-memory modes the cell prices; ``superstep_bytes`` also takes
#: ``logged`` (the recoded superstep with a message log)
MODES = ("recoded", "recoded_compact", "basic", "basic_sc")
#: ProcessMesh's five 8-byte integer reductions a superstep: active and
#: message counts, the skip() block density's two sums, its max
REDUCE_BYTES = 5 * 8
#: PageRank's float32 aggregator, gathered from every rank
GATHER_BYTES = 4
#: the torch backend's temporaries a dense group slot: the gathered sp, dp
#: and w, the message and its flag, the int64 index of the counts, the
#: padding-marked dp (run_sum's row-local keys) and the group's row of
#: dst_order (run_sum keeps no scratch a slot)
TORCH_SLOT_TEMP = 12 + 4 + 1 + 8 + 4 + 4


def superstep_bytes(mode: str, n: int, P: int, E_cap: int, *,
                    gather: int = GATHER_BYTES,
                    staged: bool = False) -> dict:
    """What one rank of an n-rank mesh hands its backend in a superstep,
    by ``ProcessMesh.bytes`` kind: the ring's (n-1) rounds of a float32
    value and an int32 count a position (``recoded``, ``basic_sc``);
    ``basic``'s one all_to_all of a payload and a destination an edge slot;
    ``recoded_compact``'s of a bf16 value and an int8 flag a slot and
    destination; the logged step's of a float32 value and an int32 count a
    slot and destination; ``gather`` bytes of aggregator (4 for PageRank, 0
    for a program without one); five 8-byte reductions. ``staged``: gloo
    on the card, where every byte goes to the host and back (counted as
    ``staged``), the gather bringing n partials back; NCCL, and gloo on the
    CPU, stage none."""
    if n == 1:
        return dict(ring=0, all_to_all=0, gather=0, reduce=0, staged=0)
    if mode == "basic":
        ring, a2a = 0, n * E_cap * 8
    elif mode == "recoded_compact":
        ring, a2a = 0, n * P * 3
    elif mode == "logged":
        ring, a2a = 0, n * P * 8
    elif mode in ("recoded", "basic_sc"):
        ring, a2a = (n - 1) * P * 8, 0
    else:
        raise ValueError(f"mode {mode!r}: one of {MODES + ('logged',)}")
    host = (2 * (ring + a2a) + (gather * (n + 1) if gather else 0)
            + 2 * REDUCE_BYTES if staged else 0)
    return dict(ring=ring, all_to_all=a2a, gather=gather,
                reduce=REDUCE_BYTES, staged=host)


def resident_bytes(n: int, P: int, E_cap: int, n_blocks: int, *,
                   dst_order: bool) -> dict:
    """Device bytes one rank holds through a run: its partition rows
    (degree, vmask, old_ids, gids a position; src_pos, dst_pos, eweight a
    slot of n groups; blk_lo, blk_hi a block of them), its state (a
    float32 value and an active flag a position), and, where the torch
    backend adds float sums over the dense groups,
    ``PartitionedGraph.dst_order`` (an int32 a slot)."""
    return dict(partition=21 * P + 12 * n * E_cap + 8 * n * n_blocks,
                state=5 * P,
                dst_order=4 * n * E_cap if dst_order else 0)


def partition_tensor_bytes(pg) -> dict:
    """The same parts measured on a partition's own tensors (every row it
    holds): ``numel·element_size`` over its nine tensors, and over
    ``dst_order`` where it was built (0 otherwise)."""
    size = lambda t: t.numel() * t.element_size()
    built = pg.__dict__.get("dst_order")
    return dict(partition=sum(size(getattr(pg, f)) for f in pg.TENSORS),
                dst_order=0 if built is None else size(built))


def builds_dst_order(mode: str, backend: str) -> bool:
    """Whether a PageRank run builds ``dst_order``: the torch backend's
    dense groups under ``recoded`` and ``recoded_compact``."""
    return backend == "torch" and mode in ("recoded", "recoded_compact")


def _temp_bytes(mode: str, backend: str, n: int, P: int, E_cap: int,
                n_blocks: int) -> int:
    """A model of one rank's working set beyond what it holds: the ring's
    vertex temporaries (the skip prefix, two accumulators and counts, the
    received pair, the new state: 33 B a position), and a group's slot
    temporaries on the torch backend (or the kernel backend's block
    lists); ``recoded_compact`` holds every destination's A_s and count
    and the bf16 wire both ways, ``basic`` its message list both ways and
    the receiver's sort. Not held to the card: ``chip_smoke.py`` prints
    it beside a rank's measured peak."""
    vertex = 33 * P
    group = (TORCH_SLOT_TEMP * E_cap if backend == "torch"
             else 5 * n * n_blocks)
    if mode == "recoded_compact":
        return vertex + group + 8 * n * P + 2 * 3 * n * P
    if mode == "basic":
        return vertex + group + 2 * 8 * n * E_cap + 20 * n * E_cap
    return vertex + group


def _hbm_bytes_and_ops(mode: str, n: int, P: int, E_cap: int,
                       n_blocks: int, edge_block: int,
                       n_edges: int) -> tuple[int, int]:
    """(bytes, operations) one rank's dense PageRank superstep must move
    and do, its share of ``n_edges`` spread evenly over its n groups:
    edge_combine's bound a group (``roofline.edge_combine_work``, div_deg
    at density 1, every source active), the receiver's combine (the
    ring's n-1 digests of four 4-byte reads and two writes a position, or
    one pass over what the all_to_all brought), and the skip prefix's two
    scans (a flag read and an int32 written a position). Three operations
    a message, two a received slot."""
    msgs = n_edges / (n * n)  # a group's messages
    kept_blocks = min(n_blocks, math.ceil(msgs / edge_block))
    sources = min(P, msgs)
    group, group_ops = edge_combine_work(
        "div_deg", 1, P, kept_blocks * edge_block, kept_blocks, msgs,
        sources, sources)
    if mode in ("recoded", "basic_sc"):
        recv, received = (n - 1) * 24 * P, (n - 1) * P
    elif mode == "recoded_compact":
        recv, received = 3 * n * P + 8 * P, n * P
    else:  # basic: the received message list, then A_r and the count
        recv, received = 8 * n * E_cap + 8 * P, n * E_cap
    prefix = 2 * (P + 4 * (P + 1))
    nbytes = n * group + recv + prefix
    ops = n * group_ops + 2 * received
    return int(round(nbytes)), int(round(ops))


def run_graphd_cell(multi_pod: bool = False, scale: str = "clueweb",
                    mode: str = "recoded", edge_block: int = 4096,
                    variant: str = "", *, n: int | None = None,
                    link_bytes_per_s: float | None = None, pg=None,
                    backend: str | None = None) -> dict:
    """One PageRank superstep a rank of an n-GPU mesh (n = 256, or 512 for
    ``multi_pod``, unless ``n`` is given) on an abstract partition of
    Table 1's ``scale`` (``graph.partition.abstract_partitioned_graph``,
    vertex_pad 512), or on ``pg``: a real partition, or one rank's
    ``shard_slice``, whose P, E_cap and blocks replace the abstract ones
    (``edge_block``, ``scale`` and ``n`` are then its own). ``backend``
    defaults to the engine's for the mode (``kernel`` for ``recoded``,
    else ``torch``); it decides whether ``dst_order`` is resident.
    ``link_bytes_per_s`` prices the collective term; without it
    ``t_collective_s`` is None."""
    from repro_torch.graph.partition import abstract_partitioned_graph

    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    backend = backend or ("kernel" if mode == "recoded" else "torch")
    if backend not in ("kernel", "torch") or (
            backend == "kernel" and mode != "recoded"):
        raise ValueError(f"backend {backend!r} does not run mode {mode!r}")
    if pg is None:
        if scale not in SIZES:
            raise ValueError(f"scale {scale!r}: one of {tuple(SIZES)}")
        V, E = SIZES[scale]
        n = n or (512 if multi_pod else 256)
        pg = abstract_partitioned_graph(n, V, E, edge_block=edge_block,
                                        vertex_pad=VERTEX_PAD)
        arch = f"graphd-pagerank-{scale}"
    else:
        arch = f"graphd-pagerank-{pg.n_vertices}v-{pg.n_edges}e"
    n, P, E_cap, nb = pg.n_shards, pg.P, pg.E_cap, pg.n_blocks
    V, E = pg.n_vertices, pg.n_edges

    coll = superstep_bytes(mode, n, P, E_cap)
    breakdown = {k: b for k, b in coll.items() if b and k != "staged"}
    coll_total = sum(breakdown.values())
    res = resident_bytes(n, P, E_cap, nb,
                         dst_order=builds_dst_order(mode, backend))
    arg_bytes = sum(res.values())
    temp = _temp_bytes(mode, backend, n, P, E_cap, nb)
    nbytes, ops = _hbm_bytes_and_ops(mode, n, P, E_cap, nb, pg.edge_block, E)
    terms = roofline_terms(
        None, dict(kind="graphd", seq_len=0, global_batch=0),
        flops=ops, bytes_accessed=nbytes, collective_bytes=coll_total,
        n_chips=n, graphd=dict(V=V, E=E, n=n),
        link_bytes_per_s=link_bytes_per_s,
    )
    return dict(
        arch=arch, shape="superstep", variant=variant, mode=mode,
        edge_block=pg.edge_block, mesh=f"n{n}", ok=True,
        flops_per_chip=ops,
        bytes_per_chip=nbytes,
        collective_bytes_per_chip=coll_total,
        collective_breakdown=breakdown,
        argument_bytes=arg_bytes,
        temp_bytes=temp,
        peak_bytes=arg_bytes + temp,
        P=P, E_cap=E_cap, n_blocks=nb,
        fits=arg_bytes + temp <= HBM_CAPACITY_BYTES,
        **terms,
    )


def summary(rec: dict) -> str:
    """One line of a record: the shape, a rank's bytes to its backend, and
    its resident bytes without ``dst_order`` and on the torch backend
    (with it, where the mode builds it)."""
    n, P, E_cap, nb = (int(rec["mesh"][1:]), rec["P"], rec["E_cap"],
                       rec["n_blocks"])
    kern = resident_bytes(n, P, E_cap, nb, dst_order=False)
    torch_ = resident_bytes(n, P, E_cap, nb,
                            dst_order=builds_dst_order(rec["mode"], "torch"))
    coll = ", ".join(f"{k} {b}" for k, b in rec["collective_breakdown"].items())
    t_coll = rec["t_collective_s"]
    return (f"{rec['arch'][len('graphd-pagerank-'):]} {rec['mesh']} "
            f"{rec['mode']}{' ' + rec['variant'] if rec['variant'] else ''}:"
            f" P {P}, E_cap {E_cap}, {nb} blocks of {rec['edge_block']}; "
            f"{rec['collective_bytes_per_chip']} B to the backend a "
            f"superstep ({coll}); resident {sum(kern.values())} B, "
            f"{sum(torch_.values())} B on the torch backend (dst_order "
            f"{torch_['dst_order']}); peak {rec['peak_bytes']} B, fits "
            f"{rec['fits']}; t_memory {rec['t_memory_s'] * 1e3:.4f} ms, "
            "t_collective "
            + (f"{t_coll * 1e3:.4f} ms" if t_coll is not None else "none"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--graphd", action="store_true")
    ap.add_argument("--scale", default="clueweb", choices=tuple(SIZES))
    ap.add_argument("--mode", default="recoded", choices=MODES)
    ap.add_argument("--edge-block", type=int, default=4096)
    ap.add_argument("--link-bytes-per-s", type=float, default=None,
                    help="a measured link rate (e.g. chip_smoke.py's NCCL "
                         "ring); none: no collective term")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)
    if not args.graphd:
        raise NotImplementedError(
            "the language-model dry-run cells (--arch/--shape/--all) wait "
            "for ROADMAP item 12; the port prices --graphd only")

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    rec = run_graphd_cell(args.multipod, scale=args.scale, mode=args.mode,
                          edge_block=args.edge_block,
                          link_bytes_per_s=args.link_bytes_per_s)
    results[:] = [r for r in results
                  if (r["arch"], r["shape"], r["mesh"])
                  != (rec["arch"], rec["shape"], rec["mesh"])]
    results.append(rec)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(rec, indent=1))
    print(summary(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
