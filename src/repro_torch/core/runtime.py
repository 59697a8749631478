"""Runtime context threaded through model code, and the collectives every
module shares (counterpart of ``src/repro/core/runtime.py``).

The reference runs global arrays under ``shard_map``; the port runs one
process per rank, each holding its shard, with explicit collectives on the
``torch.distributed`` process groups of the mesh (one group per axis,
``core/topology.py``), each created once per world (``per_world``).  The
helpers here are the port's ``lax`` collectives: ``shift``
(``ppermute`` around a ring), ``all_to_all``, ``all_gather`` and
``all_reduce_``; ``sum_over_world`` and ``gather_stack`` are the two that
autograd differentiates.  Hybrid ZeRO adds groups that span several axes
(``axes_groups``, every rank creating every group in one fixed order) and
their collectives: ``gather_shards`` (the all-gather, in shard order) and
``reduce_scatter_``.  ``dist.new_group`` orders a group by global rank,
which is not shard order on a head-first mesh, so parts are placed through
``AxesGroup.shard_of``, never by group rank.

Backends: NCCL with one card a rank, or gloo.  gloo takes host tensors
only, so a ``Runtime`` whose backend is gloo and whose device is a card
(several ranks sharing one card, ``chip_smoke.py`` phase 9) stages every
collective through host memory.  That is decided once, from the backend
the caller initialised and the device it named (``Runtime.stage_host``);
nothing switches backend or device on failure.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.topology import (MeshCoord, ParallelConfig,
                                       axes_rank_groups, make_mesh,
                                       rank_coords)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  With no card it raises rather than run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """``mesh`` is None on one device; on a mesh, ``backend`` names the
    ``torch.distributed`` backend and ``coord`` is this rank's place."""
    pc: ParallelConfig = ParallelConfig()
    impl: str = "auto"          # attention impl: auto | cuda | plain | ref
    device: torch.device | str | None = None
    mesh: object = None         # torch.distributed DeviceMesh
    backend: str | None = None
    coord: MeshCoord = MeshCoord()

    def __post_init__(self):
        self.pc.validate()
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        if self.mesh is None:
            if self.pc.num_devices > 1:
                raise ValueError(f"{self.pc} spans {self.pc.num_devices} "
                                 "ranks: build the Runtime with its mesh "
                                 "(world_runtime)")
            return
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")
        if self.backend == "nccl" and dev.type != "cuda":
            raise ValueError(f"NCCL needs a CUDA device, got {dev}")

    @property
    def stage_host(self) -> bool:
        """True where gloo serves tensors on a card: every collective
        copies to host memory and back."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def group(self, axis: str):
        """The process group of one mesh axis."""
        return self.mesh.get_group(axis)


#: What the world's ranks created or agreed on together, kept for the
#: world's life (``per_world``); the entry ``"world"`` names that world.
_PER_WORLD: dict = {}


def per_world(key, make):
    """``make()`` once per initialised world and ``key``: process groups
    (each a communicator under NCCL) and what the ranks agreed on stay for
    the world's life, so building plans again creates nothing new.
    ``make`` may be collective: every rank asks for the same keys in the
    same order."""
    if _PER_WORLD.get("world") is not dist.group.WORLD:
        _PER_WORLD.clear()
        _PER_WORLD["world"] = dist.group.WORLD
    if key not in _PER_WORLD:
        _PER_WORLD[key] = make()
    return _PER_WORLD[key]


def world_runtime(pc: ParallelConfig, *, impl: str = "auto",
                  device=None) -> Runtime:
    """The ``Runtime`` of this rank on the mesh ``pc`` describes, over the
    initialised ``torch.distributed`` world (whose backend it keeps).  The
    mesh is made once per world and grid."""
    backend = dist.get_backend()
    kind = "cuda" if backend == "nccl" else "cpu"
    mesh = per_world(("mesh", pc, kind), lambda: make_mesh(pc, kind))
    return Runtime(pc=pc, impl=impl, device=device, mesh=mesh,
                   backend=backend, coord=rank_coords(pc, dist.get_rank()))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _wire(x, rt: Runtime):
    """The tensor a collective sends: host memory under ``stage_host``."""
    return x.cpu() if rt.stage_host else x.contiguous()


class Arrived:
    """Tensors in flight from a ring neighbour; ``wait()`` returns them on
    the runtime's device.  The sent tensors are held until then."""

    def __init__(self, works, recv, sent, device):
        self._works, self._recv, self._sent = works, recv, sent
        self._device = device

    def wait(self) -> list:
        for w in self._works:
            w.wait()
        self._sent = None
        if self._device is None:
            return self._recv
        return [x.to(self._device, non_blocking=True) for x in self._recv]


def shift(tensors, group, rt: Runtime, tag: int = 0) -> Arrived:
    """Ring shift over ``group``: axis index ``r`` sends to ``(r+1) % n``
    and receives from ``(r-1) % n`` (the reference's ``ppermute``).  Ranks
    map through the group, never through arithmetic on rank numbers.
    Returns at once; the caller waits just before it uses the result.
    Tensor ``i`` travels with tag ``tag + i``, so two shifts in flight on
    one group stay apart."""
    n = dist.get_world_size(group)
    if n == 1:
        return Arrived([], list(tensors), None, None)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + 1) % n)
    src = dist.get_global_rank(group, (r - 1) % n)
    sent = [_wire(x, rt) for x in tensors]
    recv = [torch.empty_like(x) for x in sent]
    ops = [dist.P2POp(dist.isend, x, dst, group, tag=tag + i)
           for i, x in enumerate(sent)]
    ops += [dist.P2POp(dist.irecv, x, src, group, tag=tag + i)
            for i, x in enumerate(recv)]
    works = dist.batch_isend_irecv(ops)
    return Arrived(works, recv, sent, rt.device if rt.stage_host else None)


def all_to_all(x, group, rt: Runtime):
    """``x`` ``(n, ...)``: block ``j`` goes to axis index ``j``; block
    ``j`` of the result came from axis index ``j``."""
    src = _wire(x, rt)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if rt.stage_host else out


def all_gather(x, group, rt: Runtime, dim: int):
    """Concatenation along ``dim`` of every axis index's ``x``, in index
    order (the reference's tiled ``all_gather``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = _wire(x, rt)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_reduce_(x, rt: Runtime, group=None, op=dist.ReduceOp.SUM):
    """Reduce ``x`` over ``group`` (default: the world) in place: the sum,
    or ``op`` (``dist.ReduceOp.MAX`` is the reference's ``pmax``)."""
    if not rt.stage_host:
        dist.all_reduce(x, op=op, group=group)
        return x
    host = x.cpu()
    dist.all_reduce(host, op=op, group=group)
    return x.copy_(host)


class AxesGroup(NamedTuple):
    """This rank's group over mesh ``axes``: ``ranks`` are its global
    ranks in shard order, ``index`` is this rank's shard index and
    ``shard_of[j]`` the shard index of group rank ``j``.  ``group`` is
    None where the group is this rank alone."""
    axes: tuple
    group: object
    ranks: tuple
    index: int
    shard_of: tuple

    @property
    def size(self) -> int:
        return len(self.ranks)


def axes_groups(rt: Runtime, axes_list) -> dict:
    """``{axes: AxesGroup}`` of this rank for every axes tuple in
    ``axes_list``.  ``dist.new_group`` is collective over the world, so
    every rank must call this with the same list: each creates every group
    of every tuple, in the list's order, once per world (a set of ranks
    that two tuples share is one group)."""
    me, world = dist.get_rank(), rt.pc.num_devices
    out = {}
    for axes in axes_list:
        mine = None
        for ranks in axes_rank_groups(rt.pc, axes):
            if len(ranks) == 1:
                group = None
            elif len(ranks) == world:
                group = dist.group.WORLD
            else:
                group = per_world(("group", tuple(sorted(ranks))),
                                  lambda ranks=ranks: dist.new_group(ranks))
            if me in ranks:
                mine = group, ranks
        group, ranks = mine
        order = (dist.get_process_group_ranks(group) if group is not None
                 else ranks)
        out[axes] = AxesGroup(tuple(axes), group, tuple(ranks),
                              ranks.index(me),
                              tuple(ranks.index(r) for r in order))
    return out


def gather_shards(x, ag: AxesGroup, rt: Runtime, dim: int):
    """The concatenation along ``dim`` of the group's shards, in shard
    order (the inverse of taking this rank's slice)."""
    if ag.size == 1:
        return x
    src = _wire(x, rt)
    parts = [torch.empty_like(src) for _ in range(ag.size)]
    dist.all_gather(parts, src, group=ag.group)
    by_shard = [None] * ag.size
    for j, s in enumerate(ag.shard_of):
        by_shard[s] = parts[j]
    return torch.cat(by_shard, dim=dim).to(x.device)


def reduce_scatter_(x, ag: AxesGroup, rt: Runtime, dim: int):
    """This rank's shard (its slice along ``dim``) of the sum of ``x`` over
    the group.  ``x`` is consumed: the caller drops it."""
    n = ag.size
    if n == 1:
        return x
    chunks = x.chunk(n, dim)
    size = chunks[0].numel()
    send = torch.empty(n * size, dtype=x.dtype,
                       device="cpu" if rt.stage_host else x.device)
    for j, s in enumerate(ag.shard_of):      # group rank j gets shard s
        send[j * size:(j + 1) * size].view(chunks[s].shape).copy_(chunks[s])
    out = torch.empty(size, dtype=x.dtype, device=send.device)
    dist.reduce_scatter_tensor(out, send, group=ag.group)
    return out.view(chunks[0].shape).to(x.device)


def broadcast_(x, src: int, ag: AxesGroup, rt: Runtime):
    """``x`` of global rank ``src`` on every rank of the group, in
    place."""
    if ag.size == 1:
        return x
    host = _wire(x, rt)
    dist.broadcast(host, src, group=ag.group)
    return x.copy_(host) if rt.stage_host else host


class _SumOverWorld(torch.autograd.Function):
    """Forward: the sum over every rank.  Backward: the identity, so each
    rank back-propagates only its own term, and the sum over ranks of their
    parameter grads is the grad of the global sum."""

    @staticmethod
    def forward(ctx, x, rt):
        return all_reduce_(x.clone(), rt)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_world(x, rt: Runtime):
    return _SumOverWorld.apply(x, rt)


class _GatherStack(torch.autograd.Function):
    """Forward: every group member's ``x``, stacked on a new leading dim in
    shard order.  Backward: each rank's loss term saw every shard, so the
    grad of this rank's ``x`` is the sum over the group of the gathered
    grads' slice for this rank (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, ag, rt):
        ctx.ag, ctx.rt = ag, rt
        return gather_shards(x.unsqueeze(0), ag, rt, 0)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_(g.contiguous(), ctx.ag, ctx.rt, 0)[0], None,
                None)


def gather_stack(x, ag: AxesGroup, rt: Runtime):
    """``(n, *x.shape)``: the group's ``x`` in shard order (the reference's
    untiled ``lax.all_gather``), differentiable; a group of one gives
    ``x[None]``."""
    if ag.size == 1:
        return x.unsqueeze(0)
    return _GatherStack.apply(x, ag, rt)
