"""The world mesh of a ``torchrun`` launch (counterpart of
``src/repro/launch/mesh.py``).

``torchrun --nproc-per-node N`` starts one process a rank and sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``.  ``init_world`` starts the process group from them: NCCL
with one card a rank, or gloo for ``device="cpu"``.  ``world_pc`` derives
the grid as the reference's launcher does, with the world size in place of
its 16-chip slice; ``production_plan`` does both and hands the grid to
``build_plan``, which builds the 5-axis mesh over the world.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.core.plan import ExecutionPlan, build_plan
from repro_torch.core.topology import ParallelConfig, factor_cp


def world_size() -> int:
    """The launch's world size: the process group's, else ``torchrun``'s
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_world(device="cuda") -> torch.device:
    """Start the process group of a ``torchrun`` world of more than one
    rank and return this rank's device: ``cuda:LOCAL_RANK`` on NCCL (a
    world larger than the machine's card count raises), the CPU on gloo."""
    world = world_size()
    dev = torch.device(device)
    if world == 1 or dist.is_initialized():
        return dev
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"a world of {world} ranks needs {world} cards on NCCL (one "
                f"card a rank); this machine has {cards}.  Several ranks on "
                "one card run over gloo with host-staged collectives, as "
                "chip_smoke.py phase 9 does")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return dev


def world_pc(world: int, hp: int | None = None, inner: int | None = None,
             placement: str | None = None) -> ParallelConfig:
    """``cp = world // hp``, ``inner = inner or min(cp, 4)``, ``dp = 1``."""
    hp = hp or 1
    if world % hp:
        raise ValueError(f"hp {hp} does not divide a world of {world} "
                         "ranks: launch hp * cp ranks with torchrun "
                         "--nproc-per-node")
    cp = world // hp
    outer, inner = factor_cp(cp, inner or min(cp, 4))
    return ParallelConfig(dp=1, hp=hp, cp_outer=outer, cp_inner=inner,
                          placement=placement or "head_first")


def production_plan(cfg, *, hp: int | None = None, inner: int | None = None,
                    placement: str | None = None, device="cuda",
                    **kw) -> ExecutionPlan:
    """The plan of this ``torchrun`` world: its process group
    (``init_world``), its grid (``world_pc``) and ``build_plan`` over
    it; ``kw`` goes to ``build_plan``."""
    device = init_world(device)
    pc = world_pc(world_size(), hp, inner, placement)
    return build_plan(cfg, pc, device=device, **kw)
