"""Deterministic synthetic token pipeline, a copy of the JAX package's
``data/tokens.py``: the same numpy generator, so the same tokens.

Each data-parallel host slice draws its deterministic slice of the global
batch from a counter-based generator (no state to checkpoint beyond the step
counter: restart-safe by construction)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def synthetic_batch(cfg, step: int, seq_len: int, global_batch: int,
                    with_media: bool = False, n_media: int | None = None,
                    device=None) -> dict[str, torch.Tensor]:
    """Counter-based batch: tokens[i, t] = f(step, i, t), reproducible at any
    restart point without replaying the stream. ``media`` (cfg.dtype) is
    drawn as the reference draws it."""
    device = resolve_device(device)
    rng = np.random.default_rng(np.uint64(0xC0FFEE) + np.uint64(step))
    tokens = rng.integers(
        0, cfg.vocab, size=(global_batch, seq_len), dtype=np.int32
    )
    batch = dict(
        tokens=torch.from_numpy(tokens).to(device),
        labels=torch.from_numpy(np.roll(tokens, -1, axis=1)).to(device),
    )
    if with_media or cfg.n_media_tokens:
        nm = n_media or cfg.n_media_tokens
        media = rng.standard_normal(
            (global_batch, nm, cfg.d_model), dtype=np.float32
        )
        batch["media"] = torch.from_numpy(media).to(device, cfg.dtype)
    return batch
