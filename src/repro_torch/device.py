"""Device choice for the port's entry points.

``partition_graph`` and ``GraphDEngine`` run on the card unless the caller
asks for another device: ``device=None`` means CUDA, and raises when there is
none, so a run never drops to the CPU without being asked to.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
