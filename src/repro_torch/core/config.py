"""Typed engine configuration: the fields the in-memory recoded path reads.

The JAX package's ``EngineConfig`` (``repro/core/config.py``) also carries the
streamed, spill, channel and recovery sub-configs; the port grows them with
the modes that read them. ``kernel_windows`` is not ported: the JAX kernel
backend needs SRC_WIN/DST_WIN windows because Mosaic has no vector gather,
and the port's kernel gathers and scatters natively on the partition's own
blocks, so it has no windows to size.
"""

from __future__ import annotations

from dataclasses import dataclass

#: the one mode of this slice, and where the JAX package's other modes land
MODES = ("recoded",)
LATER_MODES = {
    "recoded_compact": "slice 2 (the other in-memory modes)",
    "basic": "slice 2 (the other in-memory modes)",
    "basic_sc": "slice 2 (the other in-memory modes)",
    "streamed": "slice 3 (the out-of-core mode)",
}
#: "torch" = plain PyTorch ops; "kernel" = the hand-written CUDA/Triton
#: kernels (on CPU tensors the kernel wrappers run their plain versions)
BACKENDS = ("torch", "kernel")


class ConfigError(ValueError):
    """A config field (or a combination of fields) is invalid."""


@dataclass
class EngineConfig:
    mode: str = "recoded"
    backend: str = "kernel"
    sparse_cap_frac: float = 0.25  # skip(): max gathered blocks fraction
    adapt_threshold: float = 0.125  # dense->sparse dispatch density

    def finalize(self) -> "EngineConfig":
        """Validate every field; returns ``self``."""
        if self.mode in LATER_MODES:
            raise ConfigError(
                f"mode={self.mode!r} is not ported yet; it comes with "
                f"{LATER_MODES[self.mode]}"
            )
        if self.mode not in MODES:
            raise ConfigError(f"unknown mode={self.mode!r}; pick one of {MODES}")
        if self.backend not in BACKENDS:
            raise ConfigError(
                f"unknown backend={self.backend!r}; pick one of {BACKENDS}"
            )
        if not 0 < self.sparse_cap_frac <= 1:
            raise ConfigError("sparse_cap_frac must be in (0, 1]")
        if not 0 <= self.adapt_threshold <= 1:
            raise ConfigError("adapt_threshold must be in [0, 1]")
        return self
