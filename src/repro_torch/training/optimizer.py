"""AdamW, the port of the JAX package's ``training/optimizer.py``: float32
moments over the weights (bf16 for the bf16 configs, with no float32 master
copy, so an update below a bf16 step rounds away, as in the reference),
global-norm clipping and a linear-warmup cosine schedule.

The state is ``{"mu": {name: float32}, "nu": {name: float32}, "step":
int32}``, the moments keyed by the model's parameter names. ``step`` and
the learning rate stay tensors on the weights' device, so a step never
waits for the card. ``adamw_update`` writes the weights and the moments in
place, a leaf at a time and the largest leaves a chunk at a time, with the
reference's arithmetic element by element: its float32 temporaries are a
few chunks, not a copy of a leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

#: elements of a leaf updated at a time (float32 temporaries of 256 MiB each)
CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def init_opt_state(params: dict[str, torch.Tensor]) -> dict:
    """Zero float32 moments a weight and step 0, on the weights' device."""
    device = next(iter(params.values())).device
    f32 = {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
           for k, p in params.items()}
    return dict(mu=f32, nu={k: torch.zeros_like(v) for k, v in f32.items()},
                step=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), float32: linear
    warmup, then a cosine from 1 to 0.1 of ``cfg.lr``."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        yield flat[lo:lo + CHUNK]


def global_norm(tree: dict[str, torch.Tensor], owned=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, the leaves added
    in the dict's order from 0 (the reference adds its sorted leaves: the
    same terms, in another order).

    On a grid, ``owned`` is ``(grid, names)``: the shards this rank counts,
    each element of a leaf once (a leaf replicated over an axis counts on
    that axis's coordinate 0, ``ProcessGrid.owns``); the ranks' sums are
    added in rank order."""
    total = None
    names = tree if owned is None else owned[1]
    for k in names:
        for c in _chunks(tree[k]):
            sq = torch.sum(torch.square(c.to(torch.float32)))
            total = sq if total is None else total + sq
    if owned is not None:
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=next(iter(tree.values())).device)
        total = owned[0].all_sum(total, "world")
    return torch.sqrt(total)


def _update(cfg: AdamWConfig, p, g, mu, nu, scale, lr, bc1, bc2) -> None:
    """One chunk of the reference's ``upd``, in place, its operations in
    its order."""
    g = g.to(torch.float32) * scale
    mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    nu.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
    delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
    delta = delta + cfg.weight_decay * p.to(torch.float32)
    p.copy_(p.to(torch.float32) - lr * delta)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict, owned=None):
    """One AdamW step over ``params`` (written in place) from ``grads`` (the
    same names; any dtype, widened to float32). Returns ``(params, state',
    {"grad_norm", "lr"})``: the moments are updated in place, ``step``
    advanced. Weight decay applies to every leaf, norms included. On a
    grid ``params`` are this rank's shards and ``owned`` as
    ``global_norm``'s: the norm spans every shard."""
    step = state["step"] + 1
    gn = global_norm(grads, owned)
    scale = torch.clamp(gn.new_tensor(cfg.clip_norm) / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    for k, p in params.items():
        for pc, gc, mc, nc in zip(_chunks(p), _chunks(grads[k]),
                                  _chunks(state["mu"][k]),
                                  _chunks(state["nu"][k])):
            _update(cfg, pc, gc, mc, nc, scale, lr, bc1, bc2)
    return params, dict(state, step=step), dict(grad_norm=gn, lr=lr)
