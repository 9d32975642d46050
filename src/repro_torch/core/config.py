"""Typed engine configuration: the fields the in-memory modes read.

The JAX package's ``EngineConfig`` (``repro/core/config.py``) also carries the
streamed, spill, channel and recovery sub-configs; the port grows them with
the modes that read them. ``kernel_windows`` is not ported: the JAX kernel
backend needs SRC_WIN/DST_WIN windows because Mosaic has no vector gather,
and the port's kernel gathers and scatters natively on the partition's own
blocks, so it has no windows to size.

Checks that need the program or the partition (a combiner, float messages,
edge groups in memory) stay in the engine: a config cannot know them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

#: the in-memory modes, and where the JAX package's other mode lands
MODES = ("recoded", "recoded_compact", "basic", "basic_sc")
LATER_MODES = {
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
    #: None resolves in ``finalize()``: "kernel" for ``recoded`` (the one
    #: mode the kernels serve), "torch" for the others
    backend: str | None = None
    sparse_cap_frac: float = 0.25  # skip(): max gathered blocks fraction
    adapt_threshold: float = 0.125  # dense->sparse dispatch density

    def finalize(self) -> "EngineConfig":
        """Validate every field; returns the config with its backend
        resolved (``self`` when it was given)."""
        if self.mode in LATER_MODES:
            raise ConfigError(
                f"mode={self.mode!r} is not ported yet; it comes with "
                f"{LATER_MODES[self.mode]}"
            )
        if self.mode not in MODES:
            raise ConfigError(f"unknown mode={self.mode!r}; pick one of {MODES}")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ConfigError(
                f"unknown backend={self.backend!r}; pick one of {BACKENDS}"
            )
        if self.backend == "kernel" and self.mode != "recoded":
            raise ConfigError("backend='kernel' needs mode='recoded'")
        if not 0 < self.sparse_cap_frac <= 1:
            raise ConfigError("sparse_cap_frac must be in (0, 1]")
        if not 0 <= self.adapt_threshold <= 1:
            raise ConfigError("adapt_threshold must be in [0, 1]")
        if self.backend is None:
            return dataclasses.replace(
                self, backend="kernel" if self.mode == "recoded" else "torch")
        return self
