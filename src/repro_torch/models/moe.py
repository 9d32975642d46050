"""Mixture-of-experts FFN: the port of the JAX package's ``models/moe.py``.

Top-k routing in float32, each token's copies grouped by destination expert
into capacity-bounded buffers, every expert's SwiGLU over its buffer, and a
gate-weighted sum back to the tokens. Copies past an expert's capacity are
dropped and counted. The capacity ``C = int(capacity_factor·k·T/E) + 1``
depends on T, the tokens of the call, as in the reference: a decode step of
a few requests keeps only C copies an expert, so decode is not ``forward``
for a MoE model, and the port computes that function, drops included.

The combine adds a token's k copies one after another, in copy order, from
zero, in the activations' dtype: the reference's scatter-add, whose copies
of one token stand together. It is not ``index_add_``, whose atomics on the
card add in no fixed order; so two runs on the card give the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import silu


def route(logits: torch.Tensor, topk: int):
    """Float32 softmax, then the ``topk`` largest probabilities a token and
    their experts, ties to the lower expert index first (``lax.top_k``'s
    order), the gates renormalised to sum to 1."""
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    eidx = order[:, :topk]
    gate = probs.gather(1, eidx)
    return probs, gate / gate.sum(dim=-1, keepdim=True), eidx


def moe_ffn(p: dict, x, *, n_experts: int, topk: int,
            capacity_factor: float = 1.25, n_shared: int = 0):
    """x: (B, S, d) -> (y, (aux, dropped)): the Switch load-balance loss and
    the fraction of copies dropped, float32 scalars on x's device. ``p``
    holds ``router`` (d, E) float32, ``w_gate``/``w_up`` (E, d, f),
    ``w_down`` (E, f, d) and, with shared experts, ``ws_gate``/``ws_up``
    (d, fs) and ``ws_down`` (fs, d)."""
    B, S, d = x.shape
    T, E = B * S, n_experts
    xt = x.reshape(T, d)
    probs, gate, eidx = route(xt.float() @ p["router"].float(), topk)

    # --- dispatch: group token copies by destination expert ---------------
    C = int(capacity_factor * topk * T / E) + 1
    flat_e = eidx.reshape(-1)  # (T*k,) a token's copies together
    flat_t = torch.arange(T, device=x.device).repeat_interleave(topk)
    flat_g = gate.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1  # rank within its expert
    keep = pos < C
    dropped = 1.0 - keep.float().mean()
    slot = torch.where(keep, flat_e * C + pos, E * C)  # E*C: the trash row
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=x.device)
    buf[slot] = xt[flat_t]
    xe = buf[:E * C].reshape(E, C, d)

    # --- every expert's FFN over its buffer -------------------------------
    h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    yflat = torch.bmm(h, p["w_down"]).reshape(E * C, d)

    # --- combine: a token's k weighted copies added in order, from 0 ------
    contrib = torch.where(keep[:, None], yflat[slot.clamp(0, E * C - 1)],
                          0.0) * flat_g[:, None].to(yflat.dtype)
    contrib = contrib.to(x.dtype).reshape(T, topk, d)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(topk):
        y = y + contrib[:, j]

    if n_shared:
        hs = silu(xt @ p["ws_gate"]) * (xt @ p["ws_up"])
        y = y + hs @ p["ws_down"]

    # load-balance aux (Switch): E * sum_e f_e * p_e
    me = torch.nn.functional.one_hot(eidx, E).float().mean(dim=(0, 1))
    aux = E * (me * probs.mean(dim=0)).sum()
    return y.reshape(B, S, d), (aux, dropped)
