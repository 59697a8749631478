"""Mesh topology: the 5-axis LoongTrain mesh and rank placement
(counterpart of ``src/repro/core/topology.py``).

Axes (canonical order): ``("pod", "data", "head", "outer", "inner")``;
``d_cp = outer * inner`` and ``d_sp = hp * cp``.

The port runs one process per rank.  ``rank_grid`` lays the ranks out as
the reference lays out its devices, so placement decides which axis is
minor (contiguous in rank order, the ranks most likely to share a node):

* head-first:    the model axis reshaped ``(outer, inner, head)``: head
                 minor, so the SeqAlltoAll group is the most-local set.
* context-first: the model axis reshaped ``(head, outer, inner)``: inner
                 minor, so the inner ring is the most-local set.

``make_mesh`` builds a ``DeviceMesh`` over that grid, one process group
per axis.  ``init_device_mesh`` would lay the ranks out row-major, which
is wrong for head-first.  Each rank holds one shard of every activation:
``batch_slice`` and ``seq_slice`` give it (the reference's ``batch_spec``
and ``seq_sharded_spec``).  Hybrid ZeRO shards parameters over several
axes at once: ``axes_rank_groups`` lists the ranks of each such group in
shard order (row-major over the axes, as named).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

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


class MeshCoord(NamedTuple):
    """A rank's coordinates on the 5-axis mesh."""
    pod: int = 0
    data: int = 0
    head: int = 0
    outer: int = 0
    inner: int = 0


def _reshape_model_axis(dev: np.ndarray, pc: ParallelConfig) -> np.ndarray:
    """dev: (pods, dp, model) -> (pods, dp, hp, outer, inner)."""
    pods, dp, model = dev.shape
    if model != pc.sp:
        raise ValueError(f"model axis {model} != hp * cp = {pc.sp}")
    if pc.placement == "head_first":
        d = dev.reshape(pods, dp, pc.cp_outer, pc.cp_inner, pc.hp)
        return d.transpose(0, 1, 4, 2, 3)
    return dev.reshape(pods, dp, pc.hp, pc.cp_outer, pc.cp_inner)


def rank_grid(pc: ParallelConfig) -> np.ndarray:
    """The ``(pods, dp, hp, outer, inner)`` array of global ranks: ranks
    ``0..n-1`` in the order the reference's ``make_mesh`` takes devices."""
    pc.validate()
    ranks = np.arange(pc.num_devices).reshape(pc.pods, pc.dp, pc.sp)
    return _reshape_model_axis(ranks, pc)


def rank_coords(pc: ParallelConfig, rank: int) -> MeshCoord:
    """The mesh coordinates of global ``rank``; no process group needed."""
    where = np.argwhere(rank_grid(pc) == rank)
    if len(where) != 1:
        raise ValueError(f"rank {rank} is not on a mesh of "
                         f"{pc.num_devices} ranks")
    return MeshCoord(*(int(c) for c in where[0]))


def refine_mesh(base, pc: ParallelConfig):
    """Split a ``(data, model)`` / ``(pod, data, model)`` ``DeviceMesh``
    into the 5-axis LoongTrain mesh without changing rank order."""
    pc.validate()
    ranks = base.mesh.cpu().numpy()
    if ranks.ndim == 2:
        ranks = ranks[np.newaxis]
    if ranks.shape[:2] != (pc.pods, pc.dp):
        raise ValueError(f"base mesh {ranks.shape} does not match {pc}")
    grid = _reshape_model_axis(ranks, pc)
    return DeviceMesh(base.device_type, torch.as_tensor(grid),
                      mesh_dim_names=MESH_AXES)


def axes_rank_groups(pc: ParallelConfig, axes) -> list:
    """The groups of ranks that span ``axes``: one list per value of the
    other axes, each in shard order: row-major over ``axes`` in the order
    named (``PartitionSpec`` semantics)."""
    grid = rank_grid(pc)
    idx = [MESH_AXES.index(a) for a in axes]
    rest = [i for i in range(len(MESH_AXES)) if i not in idx]
    size = math.prod(grid.shape[i] for i in idx)
    return grid.transpose(rest + idx).reshape(-1, size).tolist()


def make_mesh(pc: ParallelConfig, device_type: str = "cpu"):
    """The 5-axis ``DeviceMesh`` over ``rank_grid(pc)``: one process group
    per axis.  ``torch.distributed`` must be initialised with exactly
    ``pc.num_devices`` ranks.  ``device_type`` is ``"cuda"`` for NCCL and
    ``"cpu"`` for gloo (also where gloo serves CUDA tensors through host
    staging)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised")
    if dist.get_world_size() != pc.num_devices:
        raise ValueError(f"{pc} needs {pc.num_devices} ranks, the world has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.as_tensor(rank_grid(pc)),
                      mesh_dim_names=MESH_AXES)


def batch_slice(pc: ParallelConfig, coord: MeshCoord, n: int) -> slice:
    """This rank's rows of a batch of ``n``, sharded over ``BATCH_AXES``."""
    parts = pc.pods * pc.dp
    if n % parts:
        raise ValueError(f"batch {n} is not a multiple of pods * dp = "
                         f"{parts}")
    size = n // parts
    i = coord.pod * pc.dp + coord.data
    return slice(i * size, (i + 1) * size)


def seq_slice(pc: ParallelConfig, coord: MeshCoord, n: int) -> slice:
    """This rank's piece of a sequence of ``n`` (physical layout), sharded
    over ``SEQ_AXES``: piece ``(outer * w + inner) * hp + head`` of
    ``d_sp``.  Head is minor, so the head all-to-all's concatenation gives
    every context rank one contiguous ``n / d_cp`` block."""
    if n % pc.sp:
        raise ValueError(f"sequence {n} is not a multiple of d_sp = "
                         f"{pc.sp}")
    size = n // pc.sp
    i = (coord.outer * pc.cp_inner + coord.inner) * pc.hp + coord.head
    return slice(i * size, (i + 1) * size)


def factor_cp(cp: int, inner: int | None = None) -> tuple[int, int]:
    """``(outer, inner)`` for a given cp; default inner = gcd(cp, 4), the
    paper's 'w = number of NICs' heuristic."""
    if inner is None:
        inner = math.gcd(cp, 4)
    if cp % inner:
        raise ValueError(f"inner {inner} does not divide cp {cp}")
    return cp // inner, inner
