"""Weight bridge from the JAX package's parameter tree to the port's.

The JAX package stores linear weights ``(d_in, d_out)`` and stacks the
layers of each period slot over a leading group axis
(``params["blocks"][slot][leaf][group]``).  The port keeps PyTorch's
``(d_out, d_in)`` and one dict per layer (``params["layers"][i]``, layer
``i = group * period + slot``).  The tree comes in as nested dicts and
lists of numpy arrays (``jax.tree.map(np.asarray, params)``), so this
module needs no JAX.

``ref_param_shapes`` gives the reference's tree as shapes alone and
``ref_leaf_map`` places each port leaf in it: hybrid ZeRO
(``core/zero.py``), the memory model (``core/plan.py``) and AdamW's
weight decay read the reference's leaves, not the port's.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import (tree_flatten, tree_flatten_with_path,
                                 tree_unflatten)

from repro_torch.models.model import ModelConfig, init_params, require_ported


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def from_jax_params(tree, cfg: ModelConfig, *, device=None) -> dict:
    """The port's parameters from the JAX package's tree (numpy leaves),
    in the port's own structure and leaf order (``init_params``')."""
    require_ported(cfg)
    leaves = []
    for ref in ref_leaf_map(cfg):
        x = tree
        for k in ref.path:
            x = x[k]
        x = np.asarray(x) if ref.g is None else np.asarray(x)[ref.g]
        leaves.append(_tensor(np.swapaxes(x, -1, -2) if ref.transposed
                              else x, device))
    return tree_unflatten(leaves, _port_tree(cfg)[1])


def to_jax_params(params, cfg: ModelConfig) -> dict:
    """The inverse of ``from_jax_params``: the JAX package's tree (nested
    dicts, the blocks a list of period slots, numpy leaves stacked over
    the group axis, linear weights ``(d_in, d_out)``) from the port's
    full parameters."""
    require_ported(cfg)
    shapes = ref_param_shapes(cfg)
    flat = {}
    for ref, x in zip(ref_leaf_map(cfg), tree_flatten(params)[0]):
        x = x.detach().cpu().numpy()
        x = x.T if ref.transposed else x
        if ref.g is None:
            flat[ref.path] = np.ascontiguousarray(x)
        else:
            if ref.path not in flat:
                flat[ref.path] = np.empty(shapes[ref.path], x.dtype)
            flat[ref.path][ref.g] = x
    tree: dict = {}
    for path in shapes:                # sorted: list slots fill in order
        node = tree
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                if k == len(node):
                    node.append([] if isinstance(nxt, int) else {})
                node = node[k]
            else:
                node = node.setdefault(k, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = flat[path]
    return tree


def caches_to_numpy(caches):
    """The port's caches as nested dicts and lists of fp32 numpy arrays, in
    the JAX package's structure (the two already share it)."""
    if isinstance(caches, dict):
        return {k: caches_to_numpy(v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return [caches_to_numpy(v) for v in caches]
    return caches.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# The reference's logical parameter tree
# ---------------------------------------------------------------------------

class RefLeaf(NamedTuple):
    """Where a port leaf lives in the reference's tree: its ``path``
    (``("blocks", slot, ...)`` for a layer's leaf), its index ``g`` on the
    stacked group axis (None outside the blocks), and whether the port
    leaf is the transpose of the reference's (a linear weight)."""
    path: tuple
    g: int | None
    transposed: bool


def tree_paths(tree) -> list:
    """The path of every leaf of a parameter tree, in ``tree_flatten``
    order, as a tuple of its dict keys and list indices."""
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=32)
def _port_tree(cfg: ModelConfig) -> tuple:
    """``((path, shape) of every leaf, TreeSpec)`` of ``init_params(cfg)``
    in ``tree_flatten`` order, from parameters on the meta device (nothing
    is allocated)."""
    params = init_params(cfg, torch.Generator(), device="meta")
    leaves, spec = tree_flatten(params)
    return tuple(zip(tree_paths(params),
                     (tuple(x.shape) for x in leaves))), spec


def port_leaves(cfg: ModelConfig) -> tuple:
    """``(path, shape)`` of every port leaf, in ``tree_flatten`` order."""
    return _port_tree(cfg)[0]


@functools.lru_cache(maxsize=32)
def ref_leaf_map(cfg: ModelConfig) -> tuple:
    """One ``RefLeaf`` per port leaf, in the port's ``tree_flatten``
    order: layer ``i`` is group ``i // period`` of slot ``i % period``,
    and a 2-D ``w`` is stored transposed."""
    out = []
    for path, shape in port_leaves(cfg):
        transposed = path[-1] == "w" and len(shape) == 2
        if path[0] == "layers":
            g, slot = divmod(path[1], cfg.period)
            out.append(RefLeaf(("blocks", slot) + path[2:], g, transposed))
        else:
            out.append(RefLeaf(path, None, transposed))
    return tuple(out)


@functools.lru_cache(maxsize=32)
def ref_param_shapes(cfg: ModelConfig) -> dict:
    """``{path: shape}`` of the reference's tree for ``cfg``, in its
    flatten order (sorted keys): the blocks of each period slot stacked
    over ``G = num_layers / period``, linear weights ``(d_in, d_out)``.
    Nothing is allocated."""
    require_ported(cfg)
    groups = cfg.num_layers // cfg.period
    shapes = {}
    for ref, (_, shape) in zip(ref_leaf_map(cfg), port_leaves(cfg)):
        shape = shape[::-1] if ref.transposed else shape
        shapes[ref.path] = ((groups,) + shape if ref.g is not None
                            else shape)
    return dict(sorted(shapes.items()))


def param_count(cfg: ModelConfig) -> int:
    """The element count of the reference's tree (its ``_param_count``)."""
    return sum(math.prod(s) for s in ref_param_shapes(cfg).values())


def decay_mask(cfg: ModelConfig) -> list:
    """Per port leaf: whether AdamW decays it.  The reference decays
    leaves of two dims or more, and its stacked per-layer norm weights
    are ``(G, d)``, so they decay too."""
    shapes = ref_param_shapes(cfg)
    return [len(shapes[ref.path]) >= 2 for ref in ref_leaf_map(cfg)]
