"""KV cache construction a config: one ring-buffer GQA cache a layer, the
serving slice of the JAX package's ``serving/cache.py``."""

from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache, make_gqa_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_supported, layer_specs


def make_caches(cfg: ModelConfig, B: int, max_len: int,
                device=None) -> list[KVCache]:
    """One cache a layer, in stack order: ``Lc = window`` for a
    sliding-window layer, ``max_len`` for a global one."""
    check_supported(cfg)
    device = resolve_device(device)
    return [make_gqa_cache(B, spec.window or max_len, cfg.n_kv_heads,
                           cfg.head_dim, cfg.dtype, device)
            for spec in layer_specs(cfg)]


def cache_bytes(caches: list[KVCache]) -> int:
    return sum(t.numel() * t.element_size()
               for c in caches for t in c.tensors())
