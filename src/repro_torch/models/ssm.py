"""Mamba2: the state-space duality (SSD) chunked scan (arXiv:2405.21060),
the port of the JAX package's ``models/ssm.py``.

The sequence is cut into chunks; within a chunk the work is dense
(quadratic in the chunk), and a small float32 state (B, H, hd, N) is
carried from chunk to chunk, here by a Python loop (the reference's
``lax.scan``). Decode keeps that state and the causal conv's last K-1 inputs
(in ``cfg.dtype``), O(1) a token whatever the context.

Shapes: x (B, S, d_inner) split into H heads of hd; B/C (B, S, N), one
group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.layers import row_parallel, silu
from repro_torch.models.sharding import copy_to


@dataclass
class SSMCache:
    state: torch.Tensor  # (B, H, hd, N) float32
    conv: torch.Tensor  # (B, K-1, d_inner + 2N) the conv's last inputs

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.state, self.conv


def make_ssm_cache(cfg, B: int, device) -> SSMCache:
    H, hd, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    K, di = cfg.ssm_conv, cfg.d_ssm_inner
    return SSMCache(
        state=torch.zeros((B, H, hd, N), dtype=torch.float32, device=device),
        conv=torch.zeros((B, K - 1, di + 2 * N), dtype=cfg.dtype,
                         device=device),
    )


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = sum_{j<k<=i} x[..., k] (lower-triangular, -inf
    above the diagonal)."""
    L = log_a.shape[-1]
    cs = log_a.cumsum(-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=log_a.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def pick_chunk(S: int, chunk: int) -> int:
    """Largest divisor of S that is <= chunk."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def ssd_scan(x, dt, A, Bm, Cm, chunk: int):
    """SSD forward.

    x:  (B, S, H, hd)   values
    dt: (B, S, H)       softplus'd step sizes
    A:  (H,)            negative decay rates
    Bm: (B, S, N)       input gates  (single group)
    Cm: (B, S, N)       output gates
    Returns y (B, S, H, hd), final_state (B, H, hd, N).
    """
    Bsz, S, H, hd = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide S = {S}")
    nc = S // chunk

    def r(t):
        return t.reshape(Bsz, nc, chunk, *t.shape[2:])

    xc, dtc, Bc, Cc = r(x), r(dt), r(Bm), r(Cm)
    dA = dtc * A  # (B, nc, L, H) log-decay a step
    dA_cs = dA.cumsum(2)

    # --- intra-chunk (dense): Y_diag = (C B^T ∘ L) (dt x) ------------------
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (B, nc, H, L, L)
    CB = Cc @ Bc.transpose(-1, -2)  # (B, nc, L, L)
    M = CB[:, :, None] * L  # (B, nc, H, L, L)
    xdt = xc * dtc[..., None]  # (B, nc, L, H, hd)
    y_diag = (M @ xdt.transpose(2, 3)).transpose(2, 3)  # (B, nc, L, H, hd)

    # --- chunk states: decay-to-end weighted outer products ---------------
    decay_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (B, nc, L, H)
    w = (dtc * decay_end).permute(0, 1, 3, 2)[..., None]  # (B, nc, H, L, 1)
    states = (xc.permute(0, 1, 3, 4, 2) @ (Bc[:, :, None] * w))  # (B,nc,H,hd,N)

    # --- inter-chunk recurrence (the carried state) -----------------------
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (B, nc, H)
    s = torch.zeros((Bsz, H, hd, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)  # (B, nc, H, hd, N)

    # --- inter-chunk output: y_off = C · decayed prev state ---------------
    decay_in = torch.exp(dA_cs)  # (B, nc, L, H)
    y_off = (prev_states @ Cc[:, :, None].transpose(-1, -2)).permute(
        0, 1, 4, 2, 3) * decay_in[..., None]  # (B, nc, L, H, hd)
    y = (y_diag + y_off).reshape(Bsz, S, H, hd)
    return y, s


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token SSD update: state' = e^{dt A} state + dt B x^T; y = C state'.

    state: (B, H, hd, N); x: (B, 1, H, hd); dt: (B, 1, H); Bm/Cm: (B, 1, N).
    Returns y (B, 1, H, hd) and the new state.
    """
    dec = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
    upd = (dt[:, 0, :, None, None] * x[:, 0, :, :, None]) * Bm[:, 0, None, None, :]
    new_state = state * dec + upd
    y = (new_state @ Cm[:, 0, None, :, None]).squeeze(-1)  # (B, H, hd)
    return y[:, None], new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` (no linear cut-off above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _own_heads(p: dict, cfg, grid):
    """A grid rank's part of the block: its H/m heads' ``z``, ``x`` and
    ``dt`` columns of the whole ``in_proj`` and its ``x`` channels of the
    whole ``conv_w``/``conv_b``, with the ``B`` and ``C`` every head
    shares, in the block's layout; ``(in_proj, conv_w, conv_b, d_inner,
    heads)`` of this rank. Slices joined, so the backward copies."""
    di, N, H = cfg.d_ssm_inner, cfg.ssm_state, cfg.n_ssm_heads
    hd, m = cfg.ssm_head_dim, grid.size("model")
    Hl = H // m
    lo = grid.index("model") * Hl
    xs = slice(lo * hd, (lo + Hl) * hd)  # this rank's heads' channels
    w = p["in_proj"]
    w_in = torch.cat([w[:, xs], w[:, di + xs.start:di + xs.stop],
                      w[:, 2 * di:2 * di + 2 * N],
                      w[:, 2 * di + 2 * N + lo:2 * di + 2 * N + lo + Hl]], 1)
    conv_w = torch.cat([p["conv_w"][:, xs], p["conv_w"][:, di:]], 1)
    conv_b = torch.cat([p["conv_b"][xs], p["conv_b"][di:]])
    return w_in, conv_w, conv_b, Hl * hd, Hl


def mamba_block(p: dict, x, *, cfg, cache: SSMCache | None = None,
                grid=None):
    """The Mamba2 block: in_proj -> causal depthwise conv -> SSD -> gated
    out_proj. With ``cache`` a call of S > 1 tokens is a prefill from
    position 0 (it leaves the final state and the conv's last inputs in the
    cache) and a call of one token a decode step against it; both write
    the cache in place.

    On a live ``grid`` (training forward only) the rank runs its H/m heads:
    ``in_proj``, ``conv_w`` and ``conv_b`` come whole (the caller gathers
    them over 'model', or passes them through ``copy_to`` where the spec
    leaves them whole: each rank's heads give a part of their gradients)
    and ``_own_heads`` takes the rank's columns; ``A_log``, ``dt_bias``,
    ``D`` and ``out_proj``'s rows are the rank's heads' shard, and
    ``out_proj`` is row-parallel."""
    Bsz, S, d = x.shape
    di, N, H = cfg.d_ssm_inner, cfg.ssm_state, cfg.n_ssm_heads
    hd, K = cfg.ssm_head_dim, cfg.ssm_conv
    w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    if grid is not None:
        x = copy_to(x, grid, "model")
        w_in, conv_w, conv_b, di, H = _own_heads(p, cfg, grid)

    # projection layout: z (di) | xBC (di + 2N) | dt (H)
    zxbcdt = x @ w_in
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]

    # depthwise causal conv over xBC (an explicit window sum; K small)
    decoding = cache is not None and S == 1
    if decoding:
        pads = torch.cat([cache.conv, xbc], dim=1)  # (B, K, .)
    else:
        pads = torch.nn.functional.pad(xbc, (0, 0, K - 1, 0))
    new_conv = pads[:, pads.shape[1] - (K - 1):]
    conv = pads[:, 0:S] * conv_w[0]
    for i in range(1, K):
        conv = conv + pads[:, i:i + S] * conv_w[i]
    conv = silu(conv + conv_b)

    xs = conv[..., :di].reshape(Bsz, S, H, hd)
    Bm = conv[..., di:di + N].float()
    Cm = conv[..., di + N:].float()
    A = -torch.exp(p["A_log"].float())  # (H,)
    dt = softplus(dt.float() + p["dt_bias"])  # (B, S, H)

    if decoding:
        y, new_state = ssd_decode_step(cache.state, xs.float(), dt, A, Bm, Cm)
    else:
        y, new_state = ssd_scan(xs.float(), dt, A, Bm, Cm,
                                chunk=pick_chunk(S, cfg.ssm_chunk))
    if cache is not None:
        cache.state.copy_(new_state)
        cache.conv.copy_(new_conv)
    y = y + xs.float() * p["D"][:, None]
    y = y.reshape(Bsz, S, di).to(x.dtype) * silu(z)
    if grid is not None:
        return row_parallel(y, p["out_proj"], grid)
    return y @ p["out_proj"]
