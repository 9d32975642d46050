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
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + 0.01 * aux, dict(loss=loss, aux=aux)


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
    return grads, {k: v.detach() for k, v in metrics.items()}


def compute_grads(model, batch: dict, microbatches: int = 1):
    """``(grads, metrics)`` over the batch: one backward, or with
    ``microbatches`` > 1 the mean of the slices' gradients, accumulated in
    float32 in slice order, and the last slice's metrics."""
    if microbatches == 1:
        return _grads(model, batch)
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{microbatches} microbatches")
    mb = B // microbatches
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in model.named_parameters()}
    for m in range(microbatches):
        micro = {k: v[m * mb:(m + 1) * mb] for k, v in batch.items()}
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
            qs, scales, err = compress_tree(grads, err, leaves)
            grads = decompress_tree(qs, scales)
        params = dict(model.named_parameters())
        _, opt, stats = adamw_update(opt_cfg, params, grads, opt)
        if err is not None:
            opt["err"] = err
        metrics.update(stats)
        return model, opt, metrics

    return train_step


def init_train_state(cfg: ModelConfig, model) -> dict:
    """AdamW's state for the model's weights, and the error buffer when
    ``cfg.grad_compress``."""
    params = dict(model.named_parameters())
    opt = init_opt_state(params)
    if cfg.grad_compress:
        opt["err"] = init_error_buffer(params)
    return opt
