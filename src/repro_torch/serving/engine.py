"""Serving: prefill, decode steps and a batched greedy loop, the port of
the JAX package's ``serving/engine.py``.

``prefill(model, tokens, caches)`` runs the causal forward and fills the
caches; ``decode_step(model, caches, token, pos)`` advances the whole batch
one token against them. Caches are written in place. Tokens are chosen on
the device: the loop never waits for the card to pick one.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.layers import embed, rms_norm, unembed
from repro_torch.models.transformer import Transformer


def _refuse_media(model: Transformer, media) -> None:
    if media is not None:
        raise NotImplementedError(
            f"{model.cfg.name}: media inputs (cross-attention and encoder "
            "states) are ROADMAP item 12.1b")


def prefill(model: Transformer, tokens: torch.Tensor, caches: list[KVCache],
            media=None) -> torch.Tensor:
    """Logits (B, vocab) for the prompt's last position; fills ``caches``
    with positions 0..S-1."""
    _refuse_media(model, media)
    cfg = model.cfg
    B, S = tokens.shape
    x = embed(tokens, model.embed).to(cfg.dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = model.apply_stack(x, positions, caches)
    x = rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    return unembed(x, model.table)[:, 0]


def decode_step(model: Transformer, caches: list[KVCache],
                token: torch.Tensor, pos: int) -> torch.Tensor:
    """token: (B, 1); ``pos``: the Python int position of every sequence
    of the batch (continuous-batching slots padded to a common position).
    Returns logits (B, vocab)."""
    cfg = model.cfg
    B = token.shape[0]
    x = embed(token, model.embed).to(cfg.dtype)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
    x = model.apply_stack(x, positions, caches, pos)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return unembed(x, model.table)[:, 0]


def greedy_generate(model: Transformer, prompt: torch.Tensor,
                    caches: list[KVCache], steps: int,
                    media=None) -> torch.Tensor:
    """Batched greedy decoding: (B, steps) int32 tokens, the first chosen
    from the prefill's logits."""
    logits = prefill(model, prompt, caches, media)
    tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    out = [tok]
    pos = prompt.shape[1]
    for _ in range(steps - 1):
        logits = decode_step(model, caches, tok, pos)
        tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1)
