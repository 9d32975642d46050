"""The training step, the port of the JAX package's ``training/train.py``:
next-token cross entropy plus the MoE load-balance loss, AdamW, microbatch
accumulation and optional int8 error-feedback compression.

``make_train_step(cfg, opt_cfg, microbatches)`` returns ``train_step(model,
opt, batch) -> (model, opt', metrics)``. The step writes the model's
weights and ``opt``'s moments in place (a full-width model has no room for
a second copy of either) and returns them. The weights' gradients are on
only inside the step, so a model serves as before between steps.

With microbatches the batch is cut into equal slices along its rows; each
slice's gradients are added into float32 accumulators in slice order and
the sums divided by the count. The reported ``loss`` and ``aux`` are the
last slice's, as the reference's ``lax.scan`` carry leaves them.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import max_over, reduce_from
from repro_torch.models.transformer import tree_slots
from repro_torch.training.compress import (
    compress_tree, decompress_tree, init_error_buffer,
)
from repro_torch.training.optimizer import (
    AdamWConfig, adamw_update, init_opt_state,
)


def ce_loss(model, batch: dict):
    """Next-token cross entropy (+ 0.01 · the MoE load-balance loss), as the
    reference writes it: float32 ``log_softmax``, the labels' entries
    gathered, the mean over ``labels >= 0``. Returns ``(total, {"loss",
    "aux"})``."""
    logits, aux = model(batch["tokens"], batch.get("media"), with_aux=True)
    labels = batch["labels"].long()
    grid, vocab_grid = model.grid, model.vocab_grid
    if vocab_grid is None or vocab_grid.size("model") == 1:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    else:
        nll = _vocab_parallel_nll(logits, labels.clamp(min=0), vocab_grid)
    mask = (labels >= 0).to(torch.float32)
    if grid is None:
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        total = reduce_from(torch.sum(nll * mask), grid, "data")
        loss = total / torch.clamp(grid.all_sum(torch.sum(mask), "data"),
                                   min=1.0)
    return loss + 0.01 * aux, dict(loss=loss, aux=aux)


def _vocab_parallel_nll(logits, labels, grid):
    """``-log_softmax(logits)[label]`` where ``logits`` holds this rank's
    vocab columns: the max and the sum of exponentials over 'model', each
    label's logit from the rank that owns it."""
    V = logits.shape[-1]
    m = max_over(torch.amax(logits.detach(), dim=-1, keepdim=True), grid,
                 "model")
    lse = m + torch.log(reduce_from(
        torch.sum(torch.exp(logits - m), dim=-1, keepdim=True), grid,
        "model"))
    local = labels - grid.index("model") * V
    own = (local >= 0) & (local < V)
    picked = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    picked = reduce_from(torch.where(own, picked, 0.0), grid, "model")
    return lse[..., 0] - picked


def _grads(model, batch: dict) -> tuple[dict, dict]:
    """One backward: the gradient of every weight in the model's order (a
    weight the loss does not reach gets zeros, as ``jax.grad`` gives) and
    the detached metrics. The weights' gradients are on only meanwhile."""
    params = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        total, metrics = ce_loss(model, batch)
        total.backward()
    finally:
        model.requires_grad_(False)
    grads = {}
    for k, p in params.items():
        grads[k] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    grid = model.grid
    if grid is not None:  # a leaf replicated over 'data' saw its rows only
        for k, g in grads.items():
            if "data" not in model.specs[k]:
                grads[k] = grid.all_sum(g, "data")
    return grads, {k: v.detach() for k, v in metrics.items()}


def compute_grads(model, batch: dict, microbatches: int = 1):
    """``(grads, metrics)`` over the batch: one backward, or with
    ``microbatches`` > 1 the mean of the slices' gradients, accumulated in
    float32 in slice order, and the last slice's metrics."""
    if microbatches == 1:
        return _grads(model, batch)
    grid = model.grid
    n, at = 1, 0  # the data ranks a global slice is split over; this one's
    if grid is not None:
        n, at = grid.size("data"), grid.index("data")
        batch = {k: grid.all_gather(v, "data", 0) for k, v in batch.items()}
    B = batch["tokens"].shape[0]
    if B % (microbatches * n):
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{microbatches} microbatches"
                         + (f" of {n} data ranks each" if n > 1 else ""))
    mb = B // microbatches
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in model.named_parameters()}
    for m in range(microbatches):
        lo = m * mb + at * (mb // n)
        micro = {k: v[lo:lo + mb // n] for k, v in batch.items()}
        grads, metrics = _grads(model, micro)
        for k, g in grads.items():
            acc[k].add_(g.to(torch.float32))
        del grads
    return {k: a.div_(microbatches) for k, a in acc.items()}, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """Returns ``train_step(model, opt, batch) -> (model, opt', metrics)``,
    metrics ``loss``, ``aux``, ``grad_norm`` and ``lr`` (device scalars)."""
    by_leaf: dict[tuple, list[str]] = {}  # the reference's leaves: a scale each
    for name, (path, _) in tree_slots(cfg).items():
        by_leaf.setdefault(path, []).append(name)
    leaves = list(by_leaf.values())

    def train_step(model, opt: dict, batch: dict):
        grads, metrics = compute_grads(model, batch, microbatches)
        opt = dict(opt)
        err = opt.pop("err", None)
        if cfg.grad_compress:
            # int8 error-feedback quantization, where a data-parallel
            # reduction would carry the codes
            qs, scales, err = compress_tree(grads, err, leaves, model.grid)
            grads = decompress_tree(qs, scales)
        params = dict(model.named_parameters())
        _, opt, stats = adamw_update(opt_cfg, params, grads, opt,
                                     _owned(model))
        if err is not None:
            opt["err"] = err
        metrics.update(stats)
        return model, opt, metrics

    return train_step


def _owned(model):
    """On a grid, the grid and the leaves this rank counts in the global
    norm (``optimizer.global_norm``); None for one process."""
    grid = model.grid
    if grid is None:
        return None
    return grid, [k for k, spec in model.specs.items() if grid.owns(spec)]


def init_train_state(cfg: ModelConfig, model) -> dict:
    """AdamW's state for the model's weights, and the error buffer when
    ``cfg.grad_compress``."""
    params = dict(model.named_parameters())
    opt = init_opt_state(params)
    if cfg.grad_compress:
        opt["err"] = init_error_buffer(params)
    return opt
