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

On a live grid (``moe_ffn(..., grid=)``) the function is the global
batch's, as the reference's sharded step computes it: the capacity and each
copy's slot count every data rank's tokens, the experts run over 'model'
(EP) and the combine runs the same way on every rank. Under the ``serve``
specs each expert's ff is split over 'data' too (``ff_grid``).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import silu, swiglu_ffn
from repro_torch.models.sharding import copy_to, join, reduce_from


def route(logits: torch.Tensor, topk: int):
    """Float32 softmax, then the ``topk`` largest probabilities a token and
    their experts, ties to the lower expert index first (``lax.top_k``'s
    order), the gates renormalised to sum to 1."""
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    eidx = order[:, :topk]
    gate = probs.gather(1, eidx)
    return probs, gate / gate.sum(dim=-1, keepdim=True), eidx


def _combine(yflat, slot, keep, flat_g, T: int, topk: int, dtype):
    """A token's k weighted copies added in copy order, from 0, in
    ``dtype``: ``yflat`` the experts' outputs a slot, ``slot`` a copy's."""
    contrib = torch.where(keep[:, None],
                          yflat[slot.clamp(0, yflat.shape[0] - 1)],
                          0.0) * flat_g[:, None].to(yflat.dtype)
    contrib = contrib.to(dtype).reshape(T, topk, -1)
    y = torch.zeros((T, contrib.shape[-1]), dtype=dtype,
                    device=contrib.device)
    for j in range(topk):
        y = y + contrib[:, j]
    return y


def _serve_experts(p: dict, xt, probs_fn, *, n_experts: int, topk: int,
                   capacity_factor: float, grid):
    """``moe_ffn``'s routed experts where the banks split each expert's ff
    over 'data' (``ff_grid``): every data rank's rows gathered, routed as
    one process routes the global batch (its capacity, its slots), this
    rank's experts run on every kept copy over its ff slice, the partials
    summed over 'data' in float32 in rank order, joined over 'model';
    returns this data rank's rows of the combine, the global batch's
    ``(probs, eidx, dropped, load)``."""
    T, d = xt.shape
    E = n_experts
    xg = grid.all_gather(xt, "data", 0)  # every data rank's rows, in order
    Tg = xg.shape[0]
    probs, gate, eidx = probs_fn(xg)
    C = int(capacity_factor * topk * Tg / E) + 1
    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(Tg, device=xt.device).repeat_interleave(topk)
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    keep = pos < C
    El = p["w_gate"].shape[0]
    e0 = grid.index("model") * El if El < E else 0
    mine = keep & (flat_e >= e0) & (flat_e < e0 + El)
    slot = torch.where(mine, (flat_e - e0) * C + pos, El * C)
    buf = torch.zeros((El * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf[slot] = xg[flat_t]
    xe = buf[:El * C].reshape(El, C, d)
    h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = grid.all_sum(torch.bmm(h.float(), p["w_down"].float()),
                      "data").to(xt.dtype)
    if El < E:
        ye = grid.all_gather(ye, "model", 0)  # (E, C, d)
    own = slice(grid.index("data") * T * topk, (grid.index("data") + 1)
                * T * topk)  # this data rank's copies
    slot = torch.where(keep, flat_e * C + pos, E * C)[own]
    y = _combine(ye.reshape(E * C, d), slot, keep[own],
                 gate.reshape(-1)[own], T, topk, xt.dtype)
    return y, (probs, eidx, 1.0 - keep.float().mean(), onehot.sum(0))


def moe_ffn(p: dict, x, *, n_experts: int, topk: int,
            capacity_factor: float = 1.25, n_shared: int = 0, grid=None,
            shared_grid=None, ff_grid=None):
    """x: (B, S, d) -> (y, (aux, dropped), load): the Switch load-balance
    loss and the fraction of copies dropped, float32 scalars on x's
    device, and the (E,) copies bound for each expert before the capacity
    (the global batch's on a grid). ``p`` holds ``router`` (d, E)
    float32, ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d) and,
    with shared experts, ``ws_gate``/``ws_up`` (d, fs) and ``ws_down``
    (fs, d).

    On a live ``grid`` ``x`` holds this data rank's
    rows, the same on every 'model' rank, and the function is the global
    batch's, drops included:

    * **Capacity.** ``C`` is the global batch's (T = the rows of every data
      rank), and a copy's slot is its rank among every copy bound for its
      expert in global token order, data rank by data rank: the per-expert
      counts of the data ranks before this one (one integer all_gather
      over 'data') plus its rank here. ``dropped`` is over every copy, and
      the aux loss's means are global: the partial sums added in rank order
      over 'data' (``reduce_from``: each rank's gradient reaches only its
      tokens, so the aux counts once in the global loss).
    * **Experts.** Where ``w_*`` hold E/m experts (the spec splits the bank
      over 'model': EP) the rank runs them on its own kept copies in a
      (E/m, min(C, T_local), d) buffer, and their outputs are joined over
      'model' (``join``); where they hold all E every rank runs the whole
      bank. Every rank then runs the same combine, a token's k copies
      added in copy order.
    * **Shared experts** tensor-parallel over ``shared_grid`` (the grid
      where the spec splits them over 'model'), else whole.
    * **The ff over 'data'** (``ff_grid``, the ``serve`` specs): every rank
      runs its experts' ff slice on the global batch's kept copies
      (``_serve_experts``), and the losses are the global batch's.
    """
    B, S, d = x.shape
    T, E = B * S, n_experts

    def probs_fn(rows):
        return route(rows.float() @ p["router"].float(), topk)

    xt = x.reshape(T, d)
    if ff_grid is not None:
        y, (probs, eidx, dropped, load) = _serve_experts(
            p, xt, probs_fn, n_experts=E, topk=topk,
            capacity_factor=capacity_factor, grid=ff_grid)
        if n_shared:
            y = y + swiglu_ffn(xt, p["ws_gate"], p["ws_up"], p["ws_down"],
                               silu, shared_grid)
        me = torch.nn.functional.one_hot(eidx, E).float().mean(dim=(0, 1))
        aux = E * (me * probs.mean(dim=0)).sum()
        return y.reshape(B, S, d), (aux, dropped), load
    probs, gate, eidx = probs_fn(xt)
    Tg = T if grid is None else T * grid.size("data")  # equal rows a rank

    # --- dispatch: group token copies by destination expert ---------------
    C = int(capacity_factor * topk * Tg / E) + 1
    flat_e = eidx.reshape(-1)  # (T*k,) a token's copies together
    flat_t = torch.arange(T, device=x.device).repeat_interleave(topk)
    flat_g = gate.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1  # rank within its expert
    if grid is None:
        keep = pos < C
        dropped = 1.0 - keep.float().mean()
        Cl, load = C, onehot.sum(0)
    else:  # the copies of the data ranks before this one come first
        counts = grid.all_gather(onehot.sum(0)[None], "data", 0)
        keep = counts[:grid.index("data")].sum(0)[flat_e] + pos < C
        load = counts.sum(0)
        kept = grid.all_sum(keep.sum(), "data")
        dropped = 1.0 - kept.to(torch.float32) / (Tg * topk)
        Cl = min(C, T)  # an expert takes at most a copy a token from here
    El = p["w_gate"].shape[0]
    ep = El < E  # this rank holds E/m experts
    e0 = grid.index("model") * El if ep else 0
    mine = keep & (flat_e >= e0) & (flat_e < e0 + El)
    slot = torch.where(mine, (flat_e - e0) * Cl + pos, El * Cl)  # trash row
    src = copy_to(xt, grid, "model") if ep else xt
    buf = torch.zeros((El * Cl + 1, d), dtype=xt.dtype, device=x.device)
    buf[slot] = src[flat_t]
    xe = buf[:El * Cl].reshape(El, Cl, d)

    # --- every expert's FFN over its buffer, joined over 'model' ----------
    h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])
    if ep:
        ye = join(ye, grid, "model", 0)  # (E, Cl, d)

    # --- combine: a token's k weighted copies added in order, from 0 ------
    slot = torch.where(keep, flat_e * Cl + pos, E * Cl)
    y = _combine(ye.reshape(E * Cl, d), slot, keep, flat_g, T, topk, x.dtype)

    if n_shared:
        y = y + swiglu_ffn(xt, p["ws_gate"], p["ws_up"], p["ws_down"], silu,
                           shared_grid)

    # load-balance aux (Switch): E * sum_e f_e * p_e, over the global batch
    if grid is None:
        me = torch.nn.functional.one_hot(eidx, E).float().mean(dim=(0, 1))
        aux = E * (me * probs.mean(dim=0)).sum()
    else:
        sums = reduce_from(torch.stack([
            torch.nn.functional.one_hot(eidx, E).float().sum(dim=(0, 1)),
            probs.sum(dim=0)]), grid, "data")
        aux = E * (sums[0] / (Tg * topk) * (sums[1] / Tg)).sum()
    return y.reshape(B, S, d), (aux, dropped), load
