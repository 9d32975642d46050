"""The dry run: what a step of each (arch × shape) LM cell, and one
PageRank superstep of the paper's GraphD cell, costs a GPU of a 256- or
512-GPU mesh, from the shapes alone.

The reference (``repro/launch/dryrun.py``) lowers and compiles each cell on
its (16, 16) and (2, 16, 16) meshes with ``ShapeDtypeStruct`` inputs and
reads XLA's memory and cost analyses and the collectives of the HLO. The
port has no compiler to ask, so it counts. It is host arithmetic: it
builds no device tensor (parameters, caches and partitions lie on
``meta``), starts no process group and imports no ``torch.distributed``
backend.

**LM cells** (``run_cell``): ten archs × four ``SHAPES`` × two meshes, the
reference's 80, of which 14 are its declared skips (``long_500k`` outside
``LONG_CONTEXT_ARCHS``). The meshes are 256 and 512 H100s in the
reference's (data, model) layout: its 16-way ``model`` axis spans two
8-GPU NVLink domains. What is exact, and held to the reference's trees in
the tests: the sharding specs (``launch/lm_mesh.py``), ``argument_bytes``
(each argument leaf's bytes over the mesh-axis sizes its spec names), the
skips, and the useful-work terms. The rest is the port's stated model:
``flops_per_chip`` and ``bytes_per_chip`` layer by layer
(``roofline.lm_work``, each product divided by the mesh axes that shard it,
``_divisor``), the collectives of ``_collectives`` (result-shape bytes, an
all-reduce counted twice, ring factors ignored, as the reference's HLO
parser counts them), and ``peak_bytes_model``, the reference's
``_activation_model_bytes`` added to the arguments.

**The GraphD cell** (``run_graphd_cell``) counts what
``GraphDEngine(mesh=)`` does a rank a superstep: the bytes each collective
hands the backend (what ``core.collectives.ProcessMesh`` counts), the HBM
bytes the superstep's kernels must move, the operations they do, and the
device memory a rank holds.

The records have the reference's keys with the same meaning, less
``lower_s``, ``compile_s`` and ``cpu_temp_bytes`` (nothing is compiled),
plus ``fits`` (the peak within the card's 80 GB, the role of the
reference's memory analysis); an LM record also has
``f32_flops_per_chip``, the float32 share of its operations, and a
GraphD one ``P``, ``E_cap`` and ``n_blocks``.

    python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multipod]
        [--link-bytes-per-s RATE] [--out FILE]
    python -m repro_torch.launch.dryrun --graphd [--multipod]
        [--scale clueweb|webuk] [--mode recoded] [--edge-block 4096]
        [--link-bytes-per-s RATE] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback

from repro_torch.launch.lm_mesh import (
    abstract_mesh, batch_specs_tree, cache_leaf_spec, cache_specs_tree,
    dp_axes, make_production_mesh, param_specs, shard_count, spec_axes,
)
from repro_torch.launch.roofline import (
    HBM_CAPACITY_BYTES, edge_combine_work, lm_optimizer_bytes, lm_work,
    roofline_terms, train_passes,
)
from repro_torch.models import sharding
from repro_torch.models.sharding import act_spec, logical_spec

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


# --------------------------------------------------------------------------
# the LM cells
# --------------------------------------------------------------------------

#: Whisper's decoder context; its cross K/V cover the shape's ``seq_len``
#: encoder frames
WHISPER_SELF_LEN = 448
#: the training step's four float32 metrics (loss, aux, grad_norm, lr)
METRIC_BYTES = 4 * 4
#: the layers' output projections, whose partial sums a TP 'model' axis
#: reduces (row-parallel: 'model' on their input dimension)
TP_OUT = ("wo", "out_proj", "ws_down", "w_down")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _media_len(cfg, S: int, info: dict | None = None) -> int:
    """Media tokens a sample: ``info["media_len"]`` where given; else
    Whisper's encoder frames are the shape's sequence length and the VLM's
    patches its config's."""
    if info and "media_len" in info:
        return info["media_len"]
    return S if cfg.family == "audio" else cfg.n_media_tokens


def cell_arguments(cfg, info: dict, mesh, param_mode: str = "train"):
    """A cell's arguments as the reference's ``lower_cell`` passes them,
    ``{group: {name: (meta tensor, spec)}}``: ``params`` (and for
    ``train`` the optimizer's ``mu``, ``nu``, ``step`` and, with
    ``grad_compress``, ``err``, sharded as the weights, and the batch:
    tokens, labels and the media of a media arch); for ``prefill`` the
    parameters, the caches, the tokens and the media of ``audio`` and
    ``vlm``; for ``decode`` the parameters, the caches, the token and its
    position. Whisper's decoder holds 448 positions, its cross caches the
    shape's frames. ``info["cache_len"]``, where given, sets the caches'
    positions (the smoke's prefill caches hold its decode steps too)."""
    import torch

    from repro_torch.data.tokens import batch_specs
    from repro_torch.models.transformer import abstract_params
    from repro_torch.serving.cache import abstract_caches, cache_leaves

    S, B, kind = info["seq_len"], info["global_batch"], info["kind"]
    audio = cfg.family == "audio"
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    params = abstract_params(cfg)
    pspecs = param_specs(cfg, mesh, param_mode)
    out = {"params": {k: (t, pspecs[k]) for k, t in params.items()}}
    if kind == "train":
        states = ["mu", "nu"] + (["err"] if cfg.grad_compress else [])
        for st in states:
            out[st] = {k: (meta(t.shape, torch.float32), pspecs[k])
                       for k, t in params.items()}
        out["step"] = {"step": (meta((), torch.int32), ())}
        batch = batch_specs(cfg, S, B)
        if audio or "media_len" in info:
            batch["media"] = meta((B, _media_len(cfg, S, info), cfg.d_model),
                                  cfg.dtype)
        bspecs = batch_specs_tree(batch, mesh)
        out["batch"] = {k: (t, bspecs[k]) for k, t in batch.items()}
        return out
    self_len = WHISPER_SELF_LEN if audio else S
    caches = abstract_caches(cfg, B, info.get("cache_len", self_len),
                             n_media=S if audio else None)
    cspecs = cache_specs_tree(caches, mesh)
    out["caches"] = {k: (t, cspecs[k]) for k, t in cache_leaves(caches)}
    if kind == "prefill":
        toks = meta((B, self_len), torch.int32)
        out["tokens"] = {"tokens": (toks, batch_specs_tree(toks, mesh))}
        if cfg.family in ("audio", "vlm"):
            media = meta((B, _media_len(cfg, S, info), cfg.d_model),
                         cfg.dtype)
            out["media"] = {"media": (media, batch_specs_tree(media, mesh))}
    else:
        tok = meta((B, 1), torch.int32)
        out["tokens"] = {"token": (tok, batch_specs_tree(tok, mesh)),
                         "pos": (meta((), torch.int32), ())}
    return out


def sharded_bytes(group: dict, mesh) -> int:
    """A GPU's bytes of ``{name: (tensor, spec)}``: each leaf's bytes over
    the product of the mesh-axis sizes its spec names."""
    return sum(_nbytes(t) // shard_count(spec, mesh)
               for t, spec in group.values())


def _activation_model_bytes(cfg, info, n_chips: int) -> int:
    """Remat activation model: G checkpointed layer inputs + ~4 working
    buffers of one pattern group, batch/seq sharded across the mesh."""
    S, B, kind = info["seq_len"], info["global_batch"], info["kind"]
    if kind != "train":
        S_act = 1 if kind == "decode" else S
    else:
        S_act = S
    tokens_per_chip = max(B * S_act // n_chips, 1)
    a = tokens_per_chip * cfg.d_model * 2  # bf16 layer input
    G = cfg.n_pattern_groups
    work = 4 * a * len(cfg.pattern) + tokens_per_chip * max(
        cfg.d_ff, cfg.moe_dff, cfg.d_ssm_inner if cfg.ssm_state else 0, 1
    ) * 2
    logits = tokens_per_chip * cfg.vocab * 4 // 16  # vocab TP-sharded
    return int(G * a + work + logits)


def _fsdp(param_mode: str) -> tuple:
    """The mesh axes a weight's spec shards it over for storage only (FSDP:
    gathered before each use, the work not split): 'data' under the
    ``train`` specs; none under ``serve``, whose 'data' axis splits the
    expert banks' ff dimension (tensor parallel, as 'model' does)."""
    return ("data",) if param_mode == "train" else ()


def _tp_axes(spec, param_mode: str) -> set:
    """The mesh axes that split the product of a weight with ``spec``."""
    return spec_axes(spec) - set(_fsdp(param_mode))


def _divisor(w, pspecs: dict, mesh, kind: str, param_mode: str,
             flat_heads: bool) -> int:
    """How many GPUs share one product of ``roofline.lm_work``, under the
    rules set: the batch over the DP axes where B divides; a weight's
    product over its spec's TP axes (``_tp_axes``); the attention logits
    and PV, in decode, as the K/V cache is sharded (``cache_leaf_spec``:
    the batch over the DP axes, the sequence over 'model', the reference's
    sequence-parallel decode), else over 'model' on the KV heads (grouped:
    Hkv, which a 16-way axis does not divide for 8 or fewer) or, with
    ``flat_heads`` (the reference's ``set_flat_heads(True)``: K and V
    repeated to H heads), on the H query heads; the MoE buffer as
    ``act_ecd`` pins it (E over 'model', C not split: every DP replica
    computes it) and over the banks' other TP axes; the SSD scan over the
    batch and its heads; the logits as ``act_logits`` pins them. What no
    axis shards is computed on every GPU."""
    if w.kind == "w":
        tp = _tp_axes(pspecs[w.name], param_mode)
        batch = spec_axes(logical_spec(w.dims, "batch")) - tp
        return mesh.axis_size(tuple(tp | batch))
    if w.kind == "attn":
        B, H, Hkv, Sq, T, _ = w.dims
        if kind == "decode":
            spec = cache_leaf_spec("k", (B, T), mesh)
        elif flat_heads:
            spec = logical_spec((B, H, Sq, T), "batch", "model", None, None)
        else:
            spec = logical_spec((B, Hkv, H // Hkv, Sq, T), "batch", "model",
                                None, None, None)
    elif w.kind == "moe":
        spec = act_spec("ecd", w.dims)
        banks = _tp_axes(pspecs[f"{w.name}.w_gate"], param_mode)
        return shard_count(spec, mesh) * mesh.axis_size(
            tuple(banks - spec_axes(spec)))
    elif w.kind == "scan":
        spec = logical_spec(w.dims, "batch", "model")
    else:
        spec = act_spec("logits", w.dims)
    return shard_count(spec, mesh)


def _collectives(cfg, info: dict, mesh, pspecs: dict, params: dict,
                 work: list, param_mode: str) -> dict:
    """A GPU's collective bytes a step, by the reference's op names, as its
    HLO parser counts them (result-shape bytes; an all-reduce twice):

    * ``all-gather``: every leaf whose spec shards it over an FSDP axis
      (``_fsdp``: 'data' under the ``train`` specs, none under ``serve``),
      gathered once a pass (forward; with remat the recomputation;
      backward): its bytes over its spec's other axes;
    * ``reduce-scatter`` (train): those leaves' gradients, each GPU's
      shard (the leaf's bytes over all its spec's axes); on a mesh with a
      'pod' axis, ``all-reduce`` of that shard over the pods;
      ``all-reduce`` of the other leaves' gradients over the DP axes;
    * ``all-reduce`` (TP): each output projection (``TP_OUT``) with
      'model' on its input dimension sums its partial products over
      'model', once a pass, in ``cfg.dtype``: X = the projection's
      (B, S, d) output on a GPU. Where ``act_btd`` (``fit``) shards the
      sequence over 'model' (``cfg.seq_shard``), that is a
      ``reduce-scatter`` of X over 'model' and an ``all-gather`` of X
      back for the next layer; else an all-reduce of X;
    * ``all-reduce`` (serve): where the expert banks split their ff
      dimension over an axis beyond the buffer's (the ``serve`` specs'
      'data'), each MoE layer sums its experts' partial outputs over it:
      a GPU's slice of the (E, C, d) buffer;
    * ``all-reduce`` (decode): where the K/V cache's sequence axis is
      sharded over 'model', each attention layer combines its partial
      softmax over it: the (B, 1, H, hd) partial output in ``cfg.dtype``
      and its float32 running max and sum a (batch, head), over the
      batch's DP split;
    * ``all-to-all``: each MoE layer's dispatch and combine over 'model'
      move a GPU's slice of the (E, C, d) buffer, once each a pass.

    The gradient compressor (``grad_compress``) runs after the reduction
    in the reference's step (it quantizes the summed gradients), so it
    changes no wire bytes here."""
    kind = info["kind"]
    passes = (train_passes(cfg) - 1) if kind == "train" else 1
    model = mesh.axis_size("model")
    fsdp_axes = [a for a in _fsdp(param_mode) if mesh.axis_size(a) > 1]
    dp = mesh.axis_size(tuple(a for a in ("pod", "data")
                              if a in mesh.axis_names))
    isz = cfg.dtype.itemsize
    by = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all"), 0)
    for name, t in params.items():
        spec, nb = pspecs[name], _nbytes(t)
        fsdp = bool(spec_axes(spec) & set(fsdp_axes))
        if fsdp:
            by["all-gather"] += passes * nb // shard_count(spec, mesh,
                                                           fsdp_axes)
        if kind != "train":
            continue
        shard = nb // shard_count(spec, mesh)
        if fsdp:
            by["reduce-scatter"] += shard
            if "pod" in mesh.axis_names and mesh.axis_size("pod") > 1:
                by["all-reduce"] += 2 * shard
        elif dp > 1:
            by["all-reduce"] += 2 * shard
    for w in work:
        if w.kind == "moe":
            ecd = act_spec("ecd", w.dims)
            buf = math.prod(w.dims) * isz // shard_count(ecd, mesh)
            if model > 1:
                by["all-to-all"] += passes * 2 * buf
            banks = _tp_axes(pspecs[f"{w.name}.w_gate"], param_mode)
            if banks - spec_axes(ecd):
                by["all-reduce"] += passes * 2 * buf
        if w.kind == "attn" and kind == "decode" and not w.f32:
            B, H, _, Sq, T, hd = w.dims
            spec = cache_leaf_spec("k", (B, T), mesh)
            if spec[1] is not None:
                part = B * Sq * H * (hd * isz + 2 * 4)
                by["all-reduce"] += 2 * part // shard_count(spec[:1], mesh)
        if (w.kind != "w" or w.name.rsplit(".", 1)[-1] not in TP_OUT
                or len(params[w.name].shape) != 2 or model == 1
                or pspecs[w.name][0] != "model"):
            continue
        din, d = params[w.name].shape
        n_tok = w.ops // (2 * din * d)
        B = w.dims[0]
        btd = act_spec("btd", (B, n_tok // B, d))
        x = n_tok * d * isz // shard_count((btd[0],), mesh)
        if btd[1] is not None:
            by["reduce-scatter"] += passes * x // shard_count((btd[1],),
                                                              mesh)
            by["all-gather"] += passes * x
        else:
            by["all-reduce"] += passes * 2 * x
    return {k: v for k, v in by.items() if v}


def _mesh_name(mesh, multi_pod: bool, mesh_shape) -> str:
    if mesh_shape is None:
        return "multipod" if multi_pod else "singlepod"
    return "x".join(str(s) for s in mesh.shape)


def run_cell(arch: str, shape: str, multi_pod: bool = False, cfg=None,
             param_mode: str = "train", variant: str = "", *,
             mesh_shape=None, shape_info: dict | None = None,
             link_bytes_per_s: float | None = None,
             flat_heads: bool = False) -> dict:
    """One (arch × shape) cell a GPU of the (16, 16) mesh, or (2, 16, 16)
    for ``multi_pod``, or ``mesh_shape`` (e.g. ``(1, 1)``: one GPU); the
    shape ``SHAPES[shape]`` or ``shape_info`` (``seq_len``,
    ``global_batch``, ``kind``, optionally ``cache_len`` and
    ``media_len``, a sample's media tokens), which skips
    ``cell_supported``'s check. ``param_mode="serve"`` takes the
    weight-stationary specs; ``flat_heads`` prices the attention of
    ``train`` and ``prefill`` as the reference's ``set_flat_heads(True)``
    runs it (``_divisor``). A skipped cell's record is the reference's.

    A GPU's operations are ``roofline.lm_work``'s, each over its
    ``_divisor``, a training step's passes ``train_passes`` times (the
    ``unembed`` three times); its HBM bytes the same products'
    activations, each weight read once a pass at the share a GPU holds
    once its FSDP axes are gathered (``_fsdp``), and AdamW's bytes over
    the GPU's shards (``train``) or the GPU's share of the caches once
    (``prefill`` writes them, ``decode`` reads them: the only count of
    the K/V that decode attends)."""
    from repro_torch.configs import SHAPES, cell_supported, get_config

    mesh = (make_production_mesh(multi_pod=multi_pod) if mesh_shape is None
            else abstract_mesh(mesh_shape))
    mesh_name = _mesh_name(mesh, multi_pod, mesh_shape)
    if shape_info is None:
        ok, why = cell_supported(arch, shape)
        if not ok:
            return dict(arch=arch, shape=shape, mesh=mesh_name, ok=False,
                        skipped=True, reason=why)
        info = SHAPES[shape]
    else:
        info = shape_info
    cfg = cfg or get_config(arch)
    S, B, kind = info["seq_len"], info["global_batch"], info["kind"]
    dp = dp_axes(mesh)
    with sharding.rules(batch=dp if len(dp) > 1 else dp[0], model="model",
                        seq="model" if cfg.seq_shard else None, mesh=mesh):
        args = cell_arguments(cfg, info, mesh, param_mode)
        arg_bytes = sum(sharded_bytes(g, mesh) for g in args.values())
        if kind == "train":
            out_bytes = arg_bytes - sharded_bytes(args["batch"], mesh) \
                + METRIC_BYTES
        else:
            logits = B * cfg.vocab * 4
            out_bytes = sharded_bytes(args["caches"], mesh) + logits \
                // shard_count(batch_specs_tree((B, cfg.vocab), mesh), mesh)
        params = {k: t for k, (t, _) in args["params"].items()}
        pspecs = {k: s for k, (_, s) in args["params"].items()}
        audio = cfg.family == "audio"
        tok_len = WHISPER_SELF_LEN if audio and kind == "prefill" else S
        work = lm_work(cfg, B, tok_len, kind, _media_len(cfg, S, info),
                       info.get("cache_len", WHISPER_SELF_LEN if audio
                                else S))
        flops = f32 = act = 0.0
        for w in work:
            mult = 3 if (kind == "train" and w.kind == "unembed") else (
                train_passes(cfg) if kind == "train" else 1)
            div = _divisor(w, pspecs, mesh, kind, param_mode, flat_heads)
            flops += mult * w.ops / div
            f32 += mult * w.ops / div if w.f32 else 0.0
            act += mult * w.nbytes / div
        coll = _collectives(cfg, info, mesh, pspecs, params, work,
                            param_mode)
    reads = train_passes(cfg) if kind == "train" else 1
    weights = reads * sum(_nbytes(t) // shard_count(pspecs[k], mesh,
                                                    _fsdp(param_mode))
                          for k, t in params.items())
    if kind == "train":
        state = lm_optimizer_bytes(cfg, {k: shard_count(s, mesh)
                                         for k, s in pspecs.items()})
    else:
        state = sharded_bytes(args["caches"], mesh)
    nbytes = act + weights + state
    coll_total = sum(coll.values())
    peak = arg_bytes + _activation_model_bytes(cfg, info, mesh.size)
    terms = roofline_terms(
        cfg, info, flops=flops, bytes_accessed=nbytes,
        collective_bytes=coll_total, n_chips=mesh.size,
        link_bytes_per_s=link_bytes_per_s, f32_flops=f32)
    rec = dict(
        arch=arch, shape=shape, mesh=mesh_name, ok=True,
        flops_per_chip=flops,
        f32_flops_per_chip=f32,
        bytes_per_chip=nbytes,
        collective_bytes_per_chip=coll_total,
        collective_breakdown=coll,
        argument_bytes=arg_bytes,
        output_bytes=out_bytes,
        peak_bytes_model=peak,
        fits=peak <= HBM_CAPACITY_BYTES,
        **terms,
    )
    if variant:
        rec["variant"] = variant
    return rec


def cell_line(rec: dict) -> str:
    """One line of an LM record."""
    head = (f"{rec['arch']} x {rec['shape']} on {rec['mesh']}"
            + (f" {rec['variant']}" if rec.get("variant") else ""))
    if not rec.get("ok"):
        return f"{head}: " + (f"SKIP ({rec['reason']})" if rec.get("skipped")
                              else f"FAIL ({rec.get('error')})")
    t_coll = rec["t_collective_s"]
    return (f"{head}: args {rec['argument_bytes']} B, peak model "
            f"{rec['peak_bytes_model']} B, fits {rec['fits']}; "
            f"{rec['flops_per_chip']:.6g} operations "
            f"({rec['f32_flops_per_chip']:.6g} float32), "
            f"{rec['bytes_per_chip']:.6g} HBM bytes, "
            f"{rec['collective_bytes_per_chip']} collective bytes; "
            f"t_compute {rec['t_compute_s'] * 1e3:.4f} ms, t_memory "
            f"{rec['t_memory_s'] * 1e3:.4f} ms, t_collective "
            + (f"{t_coll * 1e3:.4f} ms" if t_coll is not None else "none")
            + f"; useful/counted {rec['useful_flops_ratio']:.4f}")


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
    from repro_torch.configs import ARCHS, SHAPES

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
    if not (args.graphd or args.all or (args.arch and args.shape)):
        ap.error("--arch and --shape, --all, or --graphd")

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    def record(rec):
        results[:] = [r for r in results
                      if (r["arch"], r["shape"], r["mesh"])
                      != (rec["arch"], rec["shape"], rec["mesh"])]
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    if args.graphd:
        rec = run_graphd_cell(args.multipod, scale=args.scale,
                              mode=args.mode, edge_block=args.edge_block,
                              link_bytes_per_s=args.link_bytes_per_s)
        record(rec)
        print(json.dumps(rec, indent=1))
        print(summary(rec))
        return 0

    def one(arch, shape):
        mesh_name = "multipod" if args.multipod else "singlepod"
        if (arch, shape, mesh_name) in done:
            print(f"[skip] {(arch, shape, mesh_name)} already done")
            return
        try:
            rec = run_cell(arch, shape, args.multipod,
                           link_bytes_per_s=args.link_bytes_per_s)
        except Exception as e:  # a cell's fault is recorded; the sweep goes on
            traceback.print_exc()
            rec = dict(arch=arch, shape=shape, mesh=mesh_name, ok=False,
                       error=f"{type(e).__name__}: {e}")
        record(rec)
        print(cell_line(rec), flush=True)

    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                one(arch, shape)
    else:
        one(args.arch, args.shape)
    return 0 if all(r.get("ok") or r.get("skipped") for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
