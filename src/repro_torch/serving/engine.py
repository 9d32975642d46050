"""Serving: prefill, decode steps and a batched greedy loop, the port of
the JAX package's ``serving/engine.py``.

``prefill(model, tokens, caches, media)`` runs the causal forward and fills
the caches; ``decode_step(model, caches, token, pos)`` advances the whole
batch one token against them. Caches are written in place. Tokens are chosen
on the device: the loop never waits for the card to pick one. The same
functions serve a rank of a live grid (a ``Transformer`` built with
``mode="serve"`` and ``make_caches(..., grid=)``): its rows of the batch,
its shards of the weights and caches, and logits over the whole vocab
(``Transformer.head_logits``).

**Where the port departs from the reference: the media reach the output.**
The reference makes the cross K/V caches (``xkv`` of the VLM's cross
layers, ``ekv`` of Whisper's decoder) as zeros, and its layers take a cache
entry that is present as already projected (``models/transformer.py``'s
``_apply_layer``), so its prefill never projects the media: the cross layers
attend to zero keys and values at prefill and decode alike, and Whisper's
encoder output is computed and dropped. Here ``prefill`` projects the media
(or the encoder's states) into those caches, and ``decode_step`` reads them;
a decode step before such a prefill raises. Prefill and decode then equal
the ``forward`` over the same tokens and media.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import LayerCache, Transformer


def prefill(model: Transformer, tokens: torch.Tensor,
            caches: list[LayerCache], media=None) -> torch.Tensor:
    """Logits (B, vocab) for the prompt's last position; fills ``caches``
    with positions 0..S-1 and, for a model that reads media (B, T, d), with
    their cross K/V."""
    cfg = model.cfg
    B, S = tokens.shape
    states = model.media_states(media)
    x = model.embed_tokens(tokens)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x, _ = model.apply_stack(x, positions, caches, **states)
    x = rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    return model.head_logits(x)[:, 0]


def decode_step(model: Transformer, caches: list[LayerCache],
                token: torch.Tensor, pos: int) -> torch.Tensor:
    """token: (B, 1); ``pos``: the Python int position of every sequence
    of the batch (continuous-batching slots padded to a common position).
    Returns logits (B, vocab)."""
    cfg = model.cfg
    B = token.shape[0]
    x = model.embed_tokens(token)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
    x, _ = model.apply_stack(x, positions, caches, pos)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return model.head_logits(x)[:, 0]


def greedy_generate(model: Transformer, prompt: torch.Tensor,
                    caches: list[LayerCache], steps: int,
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
