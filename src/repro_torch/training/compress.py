"""int8 error-feedback gradient compression, the port of the JAX package's
``training/compress.py``.

Each leaf is quantized to int8 with a float32 scale a leaf; the quantization
error is kept in an error buffer and added back the next step. As the
reference's step, the port quantizes the reduced gradients and dequantizes
them (on a grid, each rank its shards, with the leaf's one scale): the
codes carry no wire bytes here.
"""

from __future__ import annotations

import torch


def init_error_buffer(params: dict[str, torch.Tensor]) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _codes(g32: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, g32 - q.to(torch.float32) * scale


def quantize(g: torch.Tensor, err: torch.Tensor):
    """Returns (int8 codes, float32 scale, new error): ``scale = max|g +
    err| / 127 + 1e-12``, codes rounded half to even (``jnp.round``) and
    clipped to ±127."""
    g32 = g.to(torch.float32) + err
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-12
    q, new_err = _codes(g32, scale)
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_tree(grads: dict, errs: dict, leaves: list[list[str]],
                  grid=None):
    """Quantize every gradient with its error: (codes, scales, new errors),
    dicts of the same names. ``leaves`` lists the names that share one
    scale, a leaf of the reference's tree each (a pattern position's
    layers are one stacked leaf there, ``models.transformer.tree_slots``).
    On a grid each name is this rank's shard, and the scale is the max
    over every rank's shards of the leaf."""
    qs, scales, new = {}, {}, {}
    for names in leaves:
        g32 = {k: grads[k].to(torch.float32) + errs[k] for k in names}
        top = torch.max(torch.stack([torch.max(torch.abs(v))
                                     for v in g32.values()]))
        if grid is not None:
            top = grid.all_max(top, "world")
        scale = top / 127.0 + 1e-12
        for k, v in g32.items():
            qs[k], new[k] = _codes(v, scale)
            scales[k] = scale
    return qs, scales, new


def decompress_tree(qs: dict, scales: dict) -> dict:
    """The float32 gradients the codes stand for."""
    return {k: dequantize(q, scales[k], torch.float32) for k, q in qs.items()}
