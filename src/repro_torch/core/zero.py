"""Hybrid ZeRO (paper §5.1) over the mesh's process groups (counterpart of
``src/repro/core/zero.py``).

LoongTrain / AMSP shard the optimizer and parameter state over ``dp x
sp``, at an extent that trades memory against collective latency
(Full-Replica, Partial- or Full-Sharding).  The reference states this as a
``PartitionSpec`` per parameter leaf and lets XLA emit the collectives.
The port keeps the reference's rule on the reference's leaves:
``leaf_spec`` takes the shape of a leaf of the reference's tree
(``convert.ref_param_shapes``: each period slot's layers stacked over a
group axis, linear weights ``(d_in, d_out)``), picks the largest dim that
the group's size divides, falls back to sub-groups that drop minor axes,
and replicates leaves under ``min_elems``.  A spec is a ``LeafSpec``: the
sharded dim of the reference leaf and the mesh axes over it, major first;
``REPLICATE`` shards nothing.  Sharding crosses ``pod`` only where the
plan's groups name it (``include_pod``).

``ZeroLayout`` carries the specs to the port's leaves (one dict a layer,
PyTorch's ``(d_out, d_in)``) and does what XLA does for the reference:

* a rank's shard of a port leaf is its contiguous slice along the port
  dim the reference's sharded dim maps to, at shard index = the row-major
  position of the rank's coordinates over the spec's axes, in the order
  the spec names them.  Where the reference shards a stacked layer axis,
  one layer lies whole in one shard: its owner holds the leaf and the
  group's other ranks an empty slice of it;
* ``shard`` / ``gather``: a full leaf to this rank's shard and back
  (``shard_params`` / ``gather_params`` for a whole tree);
* ``reduce``: a full grad to this rank's shard of its sum over the world:
  a reduce-scatter over the spec's group, then an all-reduce over the
  complement axes; a replicated leaf is all-reduced over the world;
* ``grad_norm``: the global norm of a sharded tree, each element counted
  once (on the rank whose complement coordinates are all zero).

``GatherAtUse`` runs the step's gathers where the model uses each leaf
(the train step hands it to ``forward_loss``): an autograd Function
gathers a leaf from this rank's compute-dtype shard, and its backward
hands the full grad to the step (``sink``), which reduces it into the
shard as it comes or, with several microbatches, sums it first.  Nothing
keeps a gathered leaf past its layer: the checkpointed functions drop
what they saved and gather again in their recompute, and without remat
``out_of_saved`` stores a handle in the saved set and gathers again when
the backward unpacks it.  A leaf used several times a forward is gathered
once and kept for its uses (the tied table; the hybrid family's shared
block, 13 uses in zamba2-7b), so its grad is summed by autograd and
reaches the sink, and its reduction, once.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch import convert
from repro_torch.core.runtime import (all_reduce_, axes_groups, broadcast_,
                                      gather_shards, reduce_scatter_)
from repro_torch.core.topology import (AXIS_DATA, AXIS_HP, AXIS_INNER,
                                       AXIS_OUTER, MESH_AXES)

#: preference-ordered sharding groups (AMSP: full > partial > replica)
_DEFAULT_GROUPS = (
    (AXIS_DATA, AXIS_HP, AXIS_OUTER, AXIS_INNER),   # full dp x sp sharding
    (AXIS_HP, AXIS_OUTER, AXIS_INNER),              # sp-only
    (AXIS_DATA,),                                   # dp-only
)


class LeafSpec(NamedTuple):
    """The reference leaf's sharded ``dim`` and the mesh ``axes`` over it
    (major first); ``REPLICATE`` when nothing is sharded."""
    dim: int | None = None
    axes: tuple = ()


REPLICATE = LeafSpec()


def _group_size(mesh, group) -> int:
    """``mesh`` is anything whose ``shape`` maps an axis to its size
    (``plan._ShapeOnlyMesh``)."""
    return int(np.prod([mesh.shape[a] for a in group]))


def _spec_for_group(shape, mesh, group) -> LeafSpec | None:
    g = _group_size(mesh, group)
    if g <= 1:
        return None
    # largest dim divisible by the group size wins (the first on a tie)
    cands = [(d, s) for d, s in enumerate(shape) if s % g == 0 and s >= g]
    if not cands:
        return None
    return LeafSpec(max(cands, key=lambda t: t[1])[0], tuple(group))


def leaf_spec(shape, mesh, groups=_DEFAULT_GROUPS,
              min_elems: int = 2 ** 12) -> LeafSpec:
    """The spec of one reference leaf: the first group (in preference
    order) that divides one of its dims; a group that divides none falls
    back to its largest divisible sub-group, dropping axes from the minor
    end (``inner`` first), before the next group is tried."""
    if np.prod(shape, dtype=np.int64) < min_elems:
        return REPLICATE
    for group in groups:
        for end in range(len(group), 0, -1):
            spec = _spec_for_group(shape, mesh, group[:end])
            if spec is not None:
                return spec
    return REPLICATE


def leaf_extent(shape, mesh, groups=_DEFAULT_GROUPS,
                min_elems: int = 2 ** 12) -> tuple[int, tuple]:
    """``(extent, axes)`` of the spec ``leaf_spec`` picks."""
    spec = leaf_spec(shape, mesh, groups, min_elems)
    if not spec.axes:
        return 1, ()
    return _group_size(mesh, spec.axes), spec.axes


def zero_shardings(shapes: dict, mesh, groups) -> dict:
    """``{path: LeafSpec}`` over a tree of shapes (the reference's,
    ``convert.ref_param_shapes``) under ``groups``, the preference order
    that ``core/plan.py``'s memory model chose."""
    return {path: leaf_spec(shape, mesh, groups)
            for path, shape in shapes.items()}


def replicated_shardings(shapes: dict, mesh) -> dict:
    """Full-Replica mode (ZeRO off)."""
    return {path: REPLICATE for path in shapes}


def tp_shardings(shapes: dict, mesh) -> dict:
    """Weight-stationary shardings for serving: each weight sharded over
    the model axes only and never gathered (ROADMAP item 12 reads them)."""
    groups = ((AXIS_HP, AXIS_OUTER, AXIS_INNER),)
    return {path: leaf_spec(shape, mesh, groups)
            for path, shape in shapes.items()}


# ---------------------------------------------------------------------------
# The port's leaves under the specs
# ---------------------------------------------------------------------------

class Place(NamedTuple):
    """One port leaf under its spec: ``dim`` is the port dim cut into
    shards (None when unsharded, or when the reference shards a stacked
    layer axis: then the shard index ``owner`` holds the whole leaf);
    ``shape`` is the port leaf's full shape."""
    axes: tuple
    dim: int | None
    owner: int | None
    shape: tuple


def _place(ref, ref_shape, spec: LeafSpec, mesh, shape) -> Place:
    if not spec.axes:
        return Place((), None, None, shape)
    d = spec.dim
    if d < len(ref.idx):    # a stacked layer axis: whole layers a shard
        per = ref_shape[d] // _group_size(mesh, spec.axes)
        return Place(spec.axes, None, ref.idx[d] // per, shape)
    d -= len(ref.idx)
    return Place(spec.axes, 1 - d if ref.transposed else d, None, shape)


def _complement(axes) -> tuple:
    return tuple(a for a in MESH_AXES if a not in axes)


class ZeroLayout:
    """The reference leaves' ``specs`` (``{path: LeafSpec}``, computed once
    by ``build_plan``), every port leaf's place (``convert.ref_leaf_map``
    order) and this rank's process groups: on a mesh, those of every axes
    tuple the specs use and of their complements, created on every rank in
    one fixed order."""

    def __init__(self, cfg, specs: dict, mesh, rt):
        refs = convert.ref_leaf_map(cfg)
        shapes = convert.ref_param_shapes(cfg)
        port = convert.port_leaves(cfg)
        self.specs = specs
        self.paths = [path for path, _ in port]
        self.places = [_place(r, shapes[r.path], specs[r.path], mesh, s)
                       for r, (_, s) in zip(refs, port)]
        self.decay = convert.decay_mask(cfg)
        self.rt = rt
        used = sorted({p.axes for p in self.places})
        axes = sorted(set(used) | {_complement(a) for a in used})
        self.groups = axes_groups(rt, axes) if rt.mesh is not None else {}

    def extent(self, i: int) -> int:
        """How many shards leaf ``i`` is cut into."""
        axes = self.places[i].axes
        return self.groups[axes].size if axes else 1

    def _bounds(self, i: int) -> tuple[int, int, int]:
        """``(dim, start, length)`` of this rank's slice of sharded leaf
        ``i``."""
        p = self.places[i]
        ag = self.groups[p.axes]
        if p.dim is None:
            return 0, 0, p.shape[0] if ag.index == p.owner else 0
        n = p.shape[p.dim] // ag.size
        return p.dim, ag.index * n, n

    def shard(self, i: int, x):
        """This rank's shard of full leaf ``i`` (a new contiguous tensor
        where it is sharded)."""
        if not self.places[i].axes:
            return x
        dim, start, n = self._bounds(i)
        return x.narrow(dim, start, n).clone(
            memory_format=torch.contiguous_format)

    def gather(self, i: int, x):
        """Full leaf ``i`` from every rank's shard ``x``."""
        p = self.places[i]
        if not p.axes:
            return x
        ag = self.groups[p.axes]
        if p.dim is not None:
            return gather_shards(x, ag, self.rt, p.dim)
        if ag.index != p.owner:
            x = torch.empty(p.shape, dtype=x.dtype, device=x.device)
        return broadcast_(x, ag.ranks[p.owner], ag, self.rt)

    def reduce(self, i: int, g):
        """This rank's shard of the sum over the world of the full grads
        ``g`` of leaf ``i`` (``g`` is consumed)."""
        p = self.places[i]
        if self.rt.mesh is None:
            return g
        if not p.axes:
            return all_reduce_(g, self.rt)
        ag = self.groups[p.axes]
        if p.dim is not None:
            g = reduce_scatter_(g, ag, self.rt, p.dim)
        else:
            all_reduce_(g, self.rt, ag.group)
            g = g if ag.index == p.owner else g[:0]
        comp = self.groups[_complement(p.axes)]
        if comp.size > 1:
            all_reduce_(g, self.rt, comp.group)
        return g

    def counts_once(self, i: int) -> bool:
        """Whether this rank's shard of leaf ``i`` is the one copy of it
        that a sum over the world counts: the copy whose complement
        coordinates are all zero."""
        coord = self.rt.coord
        return all(getattr(coord, a) == 0
                   for a in _complement(self.places[i].axes))

    def grad_norm(self, grads: list):
        """The global fp32 L2 norm of a tree of grad shards, as a device
        scalar."""
        norms = [torch.linalg.vector_norm(g.float()) for i, g in
                 enumerate(grads) if self.counts_once(i)]
        sq = (torch.linalg.vector_norm(torch.stack(norms)) ** 2 if norms
              else torch.zeros((), device=self.rt.device))
        if self.rt.mesh is not None:
            all_reduce_(sq, self.rt)
        return sq.sqrt()


def shard_params(full: dict, plan) -> dict:
    """This rank's shards of a full parameter tree (fp32 masters, in the
    port's leaf order: ``init_params`` / ``convert.from_jax_params``)
    under ``plan``'s layout; the leaves no rank shards are kept as they
    are."""
    layout = plan.zero
    if convert.tree_paths(full) != layout.paths:
        raise ValueError("the tree's leaves are not the port's, in its "
                         "order (init_params)")
    leaves, spec = tree_flatten(full)
    return tree_unflatten([layout.shard(i, x) for i, x in
                           enumerate(leaves)], spec)


def gather_params(shards: dict, plan) -> dict:
    """The full tree from every rank's shards (collective: every rank of
    the plan's world calls it)."""
    leaves, spec = tree_flatten(shards)
    layout = plan.zero
    return tree_unflatten([layout.gather(i, x) for i, x in
                           enumerate(leaves)], spec)


# ---------------------------------------------------------------------------
# Gathers at use
# ---------------------------------------------------------------------------

class _GatherLeaf(torch.autograd.Function):
    """Forward: the full leaf ``i`` from this rank's shard.  Backward:
    the full grad goes to the step's ``sink``; the shard gets none from
    autograd, since the step collects them from the sink."""

    @staticmethod
    def forward(ctx, shard, at, i):
        ctx.at, ctx.i = at, i
        full = at.layout.gather(i, shard)
        if full is shard:     # replicated, or held whole by this rank
            return shard.view_as(shard)
        if at._held is not None:
            at._held[full.untyped_storage().data_ptr()] = i
        return full

    @staticmethod
    def backward(ctx, g):
        ctx.at.sink(ctx.i, g)
        return None, None, None


class GatherAtUse:
    """Gathers of one forward over the shards ``leaves`` (the port's leaf
    order, each requiring grad); ``sink(i, g)`` takes leaf ``i``'s full
    grad in the backward.  Called on a dict of shards, it returns the
    dict of their full leaves."""

    def __init__(self, layout: ZeroLayout, leaves: list, sink):
        self.layout, self.leaves, self.sink = layout, leaves, sink
        self.index = {id(x): i for i, x in enumerate(leaves)}
        self._held = None     # storage -> leaf, inside ``out_of_saved``

    def __call__(self, tree):
        return tree_map(lambda x: _GatherLeaf.apply(x, self,
                                                    self.index[id(x)]),
                        tree)

    def _pack(self, t):
        i = self._held.get(t.untyped_storage().data_ptr())
        if i is None:
            return t
        return i, t.size(), t.stride(), t.storage_offset()

    def _unpack(self, saved):
        if isinstance(saved, torch.Tensor):
            return saved
        i, size, stride, offset = saved
        with torch.no_grad():
            full = self.layout.gather(i, self.leaves[i].detach())
        return full.as_strided(size, stride, offset)

    @contextlib.contextmanager
    def out_of_saved(self):
        """The leaves gathered in this context stay out of autograd's
        saved set: a saved view of one is stored as a handle and gathered
        again when the backward unpacks it (a forward without remat)."""
        self._held = {}
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self._held = None
