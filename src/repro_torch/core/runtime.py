"""Runtime context threaded through model code (counterpart of
``src/repro/core/runtime.py``, without a mesh until the 2D-Attention slice).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.topology import ParallelConfig


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  With no card it raises rather than run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Runtime:
    pc: ParallelConfig = ParallelConfig()
    impl: str = "auto"          # attention impl: auto | cuda | ref
    device: torch.device | str | None = None

    def __post_init__(self):
        self.pc.validate()
        object.__setattr__(self, "device", resolve_device(self.device))
