"""Parallel layout of the LoongTrain mesh (counterpart of
``src/repro/core/topology.py``).

Axes (canonical order): ``("pod", "data", "head", "outer", "inner")``;
``d_cp = outer * inner`` and ``d_sp = hp * cp``.  The device mesh and its
placement strategies come with the 2D-Attention slice (ROADMAP queue 1,
item 5); this module holds the layout only.
"""
from __future__ import annotations

import dataclasses

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_HP = "head"
AXIS_OUTER = "outer"
AXIS_INNER = "inner"
MESH_AXES = (AXIS_POD, AXIS_DATA, AXIS_HP, AXIS_OUTER, AXIS_INNER)

#: Data-parallel axes (the global batch is sharded over these).
BATCH_AXES = (AXIS_POD, AXIS_DATA)
#: Sequence-parallel axes, major-to-minor for the S dimension.
SEQ_AXES = (AXIS_OUTER, AXIS_INNER, AXIS_HP)
#: All non-batch axes (hybrid-ZeRO sharding of params and optimizer state).
MODEL_AXES = (AXIS_HP, AXIS_OUTER, AXIS_INNER)
ZERO_AXES = (AXIS_DATA,) + MODEL_AXES


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """LoongTrain parallel layout.  d_sp = hp * cp_outer * cp_inner."""
    dp: int = 1
    hp: int = 1
    cp_outer: int = 1
    cp_inner: int = 1
    pods: int = 1
    placement: str = "head_first"      # or "context_first"

    @property
    def cp(self) -> int:
        return self.cp_outer * self.cp_inner

    @property
    def sp(self) -> int:
        return self.hp * self.cp

    @property
    def model_size(self) -> int:
        return self.sp

    @property
    def num_devices(self) -> int:
        return self.pods * self.dp * self.sp

    def validate(self):
        if self.placement not in ("head_first", "context_first"):
            raise ValueError(f"unknown placement {self.placement!r}")
        for v in (self.dp, self.hp, self.cp_outer, self.cp_inner, self.pods):
            if v < 1:
                raise ValueError(f"every extent must be >= 1: {self}")
