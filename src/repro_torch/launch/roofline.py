"""Roofline of a step on one NVIDIA H100: the port of the reference's
``repro/launch/roofline.py``, for the GraphD superstep and the LM cells.

Three terms a GPU a step, in seconds, from the byte and operation counts of
``launch/dryrun.py`` (the reference reads them from XLA's cost analysis of
a lowered step; the port has no compiler to ask, and counts):

  compute    = operations / peak rate   (GraphD: all at the float32 rate,
                                         its superstep has no tensor-core
                                         work; LM: the ``cfg.dtype`` ones at
                                         the dense bf16 rate plus the
                                         float32 ones at the float32 rate)
  memory     = HBM bytes / HBM rate
  collective = bytes handed the backend / a link rate the caller measured

The rates are the card's, NVIDIA's H100 SXM data sheet (dense, at the full
700 W power limit; ``nvidia-smi --query-gpu=name,power.limit`` says what a
card is set to): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
outside them, 3.35 TB/s of HBM3, 80 GB of it. No link rate is assumed:
NVLink's 450 GB/s a direction is a data-sheet ceiling, not what NCCL's
ring achieves, so the collective term is computed only at a rate the
caller passes (``chip_smoke.py``'s phase 14 times ``ProcessMesh.ring_shift``
under NCCL), and is None without one.

The LM counts (``lm_work`` and the sums over it) are the one count of what
a prefill, a decode step and a training step compute: ``chip_smoke.py``'s
bounds (phases 16-18) and the dry run's cells both read them. The
reference's ``collective_bytes_from_text`` parses XLA's HLO text and has no
counterpart here: the dry run counts its collectives from the specs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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


def _causal_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs a causal mask over S positions keeps, each query
    seeing at most ``window`` keys: sum over p < S of min(p + 1, window)."""
    w = window or S
    if w >= S:
        return S * (S + 1) // 2
    return w * (w + 1) // 2 + (S - w) * w


class Work(NamedTuple):
    """One product of an LM step: ``ops`` operations, in float32 where
    ``f32`` (else in ``cfg.dtype``), reading and writing ``nbytes`` of
    activations. ``kind`` and ``dims`` say what a mesh splits it by (the
    dry run's ``_divisor``): ``w``, a product with the weight ``name``, over
    a batch of ``dims = (B,)``; ``attn``, a layer's attention logits or
    probabilities times values, ``dims = (B, H, Hkv, S, T, hd)`` (hd the
    width of a value head); ``moe``, the
    experts over their ``(E, C, d)`` buffer; ``scan``, the SSD scan or
    state update over ``(B, heads)``; ``unembed``, the logits ``(B, S, V)``
    or ``(B, V)``."""
    kind: str
    name: str
    ops: int
    f32: bool
    nbytes: int
    dims: tuple


def lm_work(cfg, B: int, S: int, mode: str = "prefill", n_media: int = 0,
            cache_len: int | None = None) -> list[Work]:
    """Layer by layer, what one pass of ``mode`` computes over a batch of B:

    * ``prefill``: the causal forward over S positions (its logits at the
      last position only); ``train``: the same with the logits at every
      position; ``decode``: one token a sequence against caches of
      ``cache_len`` positions, every slot of each layer's ring (``window``
      or ``cache_len``) attended, as the port computes it.
    * Two operations a weight a token it meets; QK and PV over the (query,
      key) pairs each causal mask keeps (every slot in decode; MLA's keys
      are hd + rd wide, its latent expanded through ``w_ukv`` over every
      key, every step); the media's (or the encoder's ``n_media`` frames')
      K/V projected once a pass (not in decode: the caches hold them) and
      the cross pairs; the encoder over the frames (bidirectional; not in
      decode); the SSD scan's chunked products, or in decode its state
      update (five operations a state element); the MoE router and the
      experts over their whole (E, C, d) buffers (the port runs all E),
      C = int(capacity_factor·k·T/E) + 1 of the call's T tokens.
    * In float32, as the port computes them: the attention logits, the
      router, the SSD scan and the ``unembed``; the rest in ``cfg.dtype``.
    * Activation bytes: each product reads its activation input and
      writes its output once; attention writes and reads its logits in
      float32 and its probabilities in ``cfg.dtype``. Weights, caches and
      the optimizer are the dry run's to count: in decode the K/V that
      attention reads, and the latent MLA expands, are the caches, and are
      not counted here."""
    from repro_torch.models.ssm import pick_chunk
    from repro_torch.models.transformer import ENCODER_SPEC, layer_specs

    if mode not in ("prefill", "train", "decode"):
        raise ValueError(f"mode {mode!r}: prefill, train or decode")
    decode = mode == "decode"
    if decode and not cache_len:
        raise ValueError("decode needs cache_len")
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    isz = cfg.dtype.itemsize
    Sq = 1 if decode else S
    tok, T = B * Sq, n_media
    out: list[Work] = []

    def proj(name, n_tok, din, dout, f32=False, reads=True):
        out.append(Work("w", name, 2 * n_tok * din * dout, f32,
                        n_tok * ((din if reads else 0) + dout)
                        * (4 if f32 else isz), (B,)))

    def core(layer, Sq_, Tk, n_pairs, heads, kv_heads, qk_w, v_w,
             kv_reads=True):
        """QK (float32 logits) and PV over ``n_pairs`` (query, key) pairs;
        ``kv_reads``: K and V are activations to count (not caches)."""
        dims = (B, heads, kv_heads, Sq_, Tk, v_w)
        kv = B * Tk * kv_heads * isz if kv_reads else 0
        q_bytes = B * Sq_ * heads * qk_w * isz
        out.append(Work("attn", layer, 2 * heads * qk_w * n_pairs, True,
                        q_bytes + kv * qk_w + 8 * heads * n_pairs, dims))
        out.append(Work("attn", layer, 2 * heads * v_w * n_pairs, False,
                        2 * isz * heads * n_pairs + kv * v_w
                        + B * Sq_ * heads * v_w * isz, dims))

    def gqa(pre, n_tok, Sq_, Tk, n_pairs, kv_tok):
        proj(f"{pre}.wq", n_tok, d, H * hd)
        if kv_tok:
            proj(f"{pre}.wk", kv_tok, d, Hkv * hd)
            proj(f"{pre}.wv", kv_tok, d, Hkv * hd)
        core(pre, Sq_, Tk, n_pairs, H, Hkv, hd, hd, kv_reads=not decode)
        proj(f"{pre}.wo", n_tok, H * hd, d)

    def self_pairs(window):
        if decode:
            return B * (window or cache_len)
        return B * _causal_pairs(S, window)

    def ssm(pre):
        di, N, nh, K = (cfg.d_ssm_inner, cfg.ssm_state, cfg.n_ssm_heads,
                        cfg.ssm_conv)
        shd = cfg.ssm_head_dim
        proj(f"{pre}.in_proj", tok, d, 2 * di + 2 * N + nh)
        out.append(Work("w", f"{pre}.conv_w", 2 * tok * K * (di + 2 * N),
                        False, 2 * tok * (di + 2 * N) * isz, (B,)))
        if decode:
            ops, nbytes = 5 * tok * nh * shd * N, 8 * tok * nh * shd * N
        else:
            L = pick_chunk(S, cfg.ssm_chunk)
            ops = 2 * tok * (L * N + nh * L * shd + 2 * nh * shd * N)
            nbytes = 4 * tok * (2 * N + 2 * nh * shd + nh * L)
        out.append(Work("scan", pre, ops, True, nbytes, (B, nh)))
        proj(f"{pre}.out_proj", tok, di, d)

    def ffn(pre, spec, n_tok):
        if spec.ffn == "none":
            return
        if spec.ffn == "dense":
            f = cfg.d_ff
            proj(f"{pre}.w_gate", n_tok, d, f)
            proj(f"{pre}.w_up", n_tok, d, f)
            proj(f"{pre}.w_down", n_tok, f, d)
            return
        E, f, k = cfg.n_experts, cfg.moe_dff, cfg.topk
        C = int(cfg.capacity_factor * k * n_tok / E) + 1
        proj(f"{pre}.router", n_tok, d, E, f32=True)
        out.append(Work("moe", pre, 2 * E * C * 3 * d * f, False,
                        E * C * (3 * d + 3 * f) * isz, (E, C, d)))
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            proj(f"{pre}.ws_gate", n_tok, d, fs)
            proj(f"{pre}.ws_up", n_tok, d, fs)
            proj(f"{pre}.ws_down", n_tok, fs, d)

    for i, spec in enumerate(layer_specs(cfg)):
        pre = f"layers.{i}"
        if spec.kind in ("attn", "hybrid"):
            gqa(f"{pre}.attn", tok, Sq,
                (spec.window or cache_len) if decode else S,
                self_pairs(spec.window), tok)
        if spec.kind in ("ssm", "hybrid"):
            ssm(f"{pre}.ssm")
        if spec.kind == "cross":
            gqa(f"{pre}.attn", tok, Sq, T, B * Sq * T, 0 if decode else B * T)
        if spec.kind == "mla":
            r, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
            Tk = cache_len if decode else S
            a = f"{pre}.attn"
            proj(f"{a}.wq", tok, d, H * (hd + rd))
            proj(f"{a}.w_dkv", tok, d, r)
            proj(f"{a}.w_krope", tok, d, rd)
            proj(f"{a}.w_ukv", B * Tk, r, H * 2 * hd, reads=not decode)
            core(a, Sq, Tk, self_pairs(None), H, H, hd + rd, hd)
            proj(f"{a}.wo", tok, H * hd, d)
        if cfg.n_enc_layers:
            gqa(f"{pre}.xattn", tok, Sq, T, B * Sq * T,
                0 if decode else B * T)
        ffn(f"{pre}.ffn", spec, tok)
    if not decode:
        for j in range(cfg.n_enc_layers):
            pre = f"encoder.{j}"
            gqa(f"{pre}.attn", B * T, T, T, B * T * T, B * T)
            ffn(f"{pre}.ffn", ENCODER_SPEC, B * T)
    n_logits = B * S if mode == "train" else B
    out.append(Work("unembed", "unembed", 2 * n_logits * d * cfg.vocab, True,
                    n_logits * (d * isz + 4 * cfg.vocab),
                    (B, S, cfg.vocab) if mode == "train" else (B, cfg.vocab)))
    return out


def lm_prefill_flops(cfg, B: int, S: int, n_media: int = 0) -> int:
    """What a prefill of B × S tokens (and ``n_media`` media or encoder
    frames) must compute: ``lm_work``'s operations summed."""
    return sum(w.ops for w in lm_work(cfg, B, S, "prefill", n_media))


def train_passes(cfg) -> int:
    """A training step's passes over the layers in units of a forward: the
    forward, the backward's two, and with ``cfg.remat`` the recomputed
    forward."""
    return 4 if cfg.remat else 3


def lm_train_flops(cfg, B: int, S: int, n_media: int = 0) -> dict:
    """What a training step over B × S tokens must compute: ``lm_work``'s
    ``train`` pass over the layers ``train_passes`` times, the ``unembed``
    three times (it is not recomputed). Returns ``{"low": operations in
    cfg.dtype, "f32": float32 ones}``."""
    low = f32 = 0
    for w in lm_work(cfg, B, S, "train", n_media):
        n = w.ops * (3 if w.kind == "unembed" else train_passes(cfg))
        if w.f32:
            f32 += n
        else:
            low += n
    return {"low": low, "f32": f32}


def lm_weight_bytes(cfg) -> int:
    """The bytes of a config's weights, each in its dtype."""
    from repro_torch.models.transformer import param_dtype, param_shapes

    return sum(math.prod(s) * param_dtype(cfg, k).itemsize
               for k, s in param_shapes(cfg).items())


def lm_optimizer_bytes(cfg, split=None) -> int:
    """AdamW's bytes: each weight, its gradient and its float32 moments
    read once, the weight and the moments written once (with
    ``cfg.grad_compress`` the float32 error buffer read and written too).
    ``split``: ``{weight name: shards}``, a GPU's share of each leaf (the
    dry run's; the whole leaf by default)."""
    from repro_torch.models.transformer import param_dtype, param_shapes

    extra = 8 if cfg.grad_compress else 0
    return sum(math.prod(s) * (3 * param_dtype(cfg, k).itemsize + 16 + extra)
               // (split[k] if split else 1)
               for k, s in param_shapes(cfg).items())


def lm_train_bound_ms(cfg, B: int, S: int) -> dict:
    """A training step's bound on one card, by term: ``lm_train_flops``'s
    bf16 operations at the dense bf16 rate, its float32 ones at the float32
    rate, and ``lm_optimizer_bytes`` at the HBM rate, each in ms (their
    sum is the bound: the terms do not overlap)."""
    flops = lm_train_flops(cfg, B, S)
    return dict(low_ms=flops["low"] / BF16_DENSE_FLOPS_PER_S * 1e3,
                f32_ms=flops["f32"] / F32_FLOPS_PER_S * 1e3,
                bytes_ms=lm_optimizer_bytes(cfg) / HBM_BYTES_PER_S * 1e3)


def lm_prefill_bound_ms(cfg, B: int, S: int, n_media: int = 0) -> float:
    """A prefill's bound on one card: the larger of its operations at the
    dense bf16 rate and its weight bytes at the HBM rate, in ms."""
    return max(lm_prefill_flops(cfg, B, S, n_media) / BF16_DENSE_FLOPS_PER_S,
               lm_weight_bytes(cfg) / HBM_BYTES_PER_S) * 1e3


def roofline_terms(cfg, shape_info, *, flops, bytes_accessed,
                   collective_bytes, n_chips, graphd=None,
                   link_bytes_per_s=None, f32_flops=0.0) -> dict:
    """The three terms (seconds a step a GPU), the dominant one, and the
    useful-work ratio, as the reference counts it: for a PageRank
    superstep ``graphd``'s ~10 operations an edge and 2 a vertex; for an LM
    cell (``cfg``) 6·N·D a GPU for ``train``, 2·N·D for ``prefill`` and
    2·N·B for ``decode``, N = ``cfg.n_active_params()``. An LM cell's
    compute term is its ``cfg.dtype`` operations (``flops`` less
    ``f32_flops``) at the dense bf16 rate plus ``f32_flops`` at the
    float32 rate; ``roofline_fraction`` takes the useful work at the bf16
    rate (GraphD's at the float32 rate). ``t_collective_s`` is None, and
    takes no part in ``dominant`` or ``roofline_fraction``, where no
    ``link_bytes_per_s`` is given."""
    if cfg is None:
        t_compute = flops / F32_FLOPS_PER_S
        peak = F32_FLOPS_PER_S
    else:
        t_compute = ((flops - f32_flops) / BF16_DENSE_FLOPS_PER_S
                     + f32_flops / F32_FLOPS_PER_S)
        peak = BF16_DENSE_FLOPS_PER_S
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
    elif cfg is not None:
        N = cfg.n_active_params()
        kind = shape_info["kind"]
        S, B = shape_info["seq_len"], shape_info["global_batch"]
        if kind == "train":
            tokens = S * B
            model_flops = 6 * N * tokens
        elif kind == "prefill":
            tokens = S * B
            model_flops = 2 * N * tokens
        else:  # decode: one token per sequence
            model_flops = 2 * N * B
        model_flops_per_chip = model_flops / n_chips
    ratio = model_flops_per_chip / flops if flops else 0.0
    return dict(
        t_compute_s=t_compute,
        t_memory_s=t_memory,
        t_collective_s=t_collective,
        dominant=dominant,
        model_flops_per_chip=model_flops_per_chip,
        useful_flops_ratio=ratio,
        roofline_fraction=round(
            model_flops_per_chip / peak
            / max(max(terms.values()), 1e-30), 4
        ),
    )
