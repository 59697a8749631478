"""Weight bridge from the JAX package's parameter tree to the port's.

The JAX package stores linear weights ``(d_in, d_out)`` and stacks its
layers over leading axes: the dense and MoE families each period slot's
layers over a group axis (``params["blocks"][slot][leaf][group]``, layer
``i = group * period + slot``), the SSM family every layer
(``params["blocks"][leaf][i]``), the hybrid family its whole groups over
``(G, attn_every)`` (``params["blocks"][leaf][g, j]``, layer ``i = g *
attn_every + j``) and the rest over ``blocks_tail``; its ``shared_attn``
is not stacked; the encoder-decoder family its encoder and decoder layers
over ``enc_blocks`` and ``dec_blocks`` (``enc_norm`` and ``dec_pos``
unstacked).  The port keeps PyTorch's ``(d_out, d_in)`` and one dict per
layer (``params["layers"][i]``; ``params["enc_layers"][i]`` and
``params["dec_layers"][i]``).  The tree comes in as nested dicts
and lists of numpy arrays (``jax.tree.map(np.asarray, params)``), so this
module needs no JAX.

``ref_param_shapes`` gives the reference's tree as shapes alone and
``ref_leaf_map`` places each port leaf in it: hybrid ZeRO
(``core/zero.py``), the memory model (``core/plan.py``), checkpoints,
AdamW's weight decay and the bf16 cast (``cast_paths``) read the
reference's leaves, not the port's.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import (tree_flatten, tree_flatten_with_path,
                                 tree_unflatten)

from repro_torch.models.model import (ModelConfig, hybrid_groups,
                                      init_params, require_ported)


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
        x = np.asarray(x)[ref.idx]
        leaves.append(_tensor(np.swapaxes(x, -1, -2) if ref.transposed
                              else x, device))
    return tree_unflatten(leaves, _port_tree(cfg)[1])


def to_jax_params(params, cfg: ModelConfig) -> dict:
    """The inverse of ``from_jax_params``: the JAX package's tree (nested
    dicts, the dense blocks a list of period slots, numpy leaves stacked
    over the layer axes, linear weights ``(d_in, d_out)``) from the port's
    full parameters."""
    require_ported(cfg)
    shapes = ref_param_shapes(cfg)
    flat = {}
    for ref, x in zip(ref_leaf_map(cfg), tree_flatten(params)[0]):
        x = x.detach().cpu().numpy()
        x = x.T if ref.transposed else x
        if not ref.idx:
            flat[ref.path] = np.ascontiguousarray(x)
        else:
            if ref.path not in flat:
                flat[ref.path] = np.empty(shapes[ref.path], x.dtype)
            flat[ref.path][ref.idx] = x
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
    (``("blocks", slot, ...)`` for a dense layer's leaf, ``("blocks",
    ...)`` or ``("blocks_tail", ...)`` for a Mamba block's), its index
    ``idx`` on the stacked layer axes (``(g,)``, ``(g, j)`` for the hybrid
    family's groups, ``()`` for an unstacked leaf), and whether the port
    leaf is the transpose of the reference's (a linear weight)."""
    path: tuple
    idx: tuple
    transposed: bool

    @property
    def g(self) -> int | None:
        """The index on the leading layer axis (None when unstacked), the
        one stack index of the dense and SSM families' leaves."""
        return self.idx[0] if self.idx else None


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


#: the port's per-layer lists -> the reference's stacked subtree
STACKS = {"layers": "blocks", "enc_layers": "enc_blocks",
          "dec_layers": "dec_blocks"}


def _layer_place(cfg: ModelConfig, i: int, stack: str = "layers") -> tuple:
    """``(path prefix, idx)`` of layer ``i`` of the port's list ``stack``
    in the reference's tree."""
    if stack != "layers":          # encdec: one stack index a layer
        return (STACKS[stack],), (i,)
    if cfg.family in ("dense", "moe"):
        g, slot = divmod(i, cfg.period)
        return ("blocks", slot), (g,)
    if cfg.family == "ssm":
        return ("blocks",), (i,)
    whole = hybrid_groups(cfg)[0] * cfg.attn_every
    if i < whole:
        return ("blocks",), divmod(i, cfg.attn_every)
    return ("blocks_tail",), (i - whole,)


@functools.lru_cache(maxsize=32)
def ref_leaf_map(cfg: ModelConfig) -> tuple:
    """One ``RefLeaf`` per port leaf, in the port's ``tree_flatten``
    order (``_layer_place`` puts each layer), and a 2-D ``w`` is stored
    transposed."""
    out = []
    for path, shape in port_leaves(cfg):
        transposed = path[-1] == "w" and len(shape) == 2
        if path[0] in STACKS:
            prefix, idx = _layer_place(cfg, path[1], path[0])
            out.append(RefLeaf(prefix + path[2:], idx, transposed))
        else:
            out.append(RefLeaf(path, (), transposed))
    return tuple(out)


@functools.lru_cache(maxsize=32)
def ref_param_shapes(cfg: ModelConfig) -> dict:
    """``{path: shape}`` of the reference's tree for ``cfg``, in its
    flatten order (sorted keys): each stacked leaf's layer axes (one past
    the largest ``idx`` of its layers) before the layer's shape, linear
    weights ``(d_in, d_out)``.  Nothing is allocated."""
    require_ported(cfg)
    refs = ref_leaf_map(cfg)
    stack = {}
    for ref in refs:
        top = stack.get(ref.path, (0,) * len(ref.idx))
        stack[ref.path] = tuple(max(t, j + 1) for t, j in zip(top, ref.idx))
    shapes = {}
    for ref, (_, shape) in zip(refs, port_leaves(cfg)):
        shapes[ref.path] = stack[ref.path] + (shape[::-1] if ref.transposed
                                              else shape)
    return dict(sorted(shapes.items()))


def param_count(cfg: ModelConfig) -> int:
    """The element count of the reference's tree (its ``_param_count``)."""
    return sum(math.prod(s) for s in ref_param_shapes(cfg).values())


def decay_mask(cfg: ModelConfig) -> list:
    """Per port leaf: whether AdamW decays it.  The reference decays
    leaves of two dims or more, and its stacked per-layer vectors (norm
    weights, ``A_log``, ``D``, ...) are ``(G, d)`` or ``(G, p, d)``, so
    they decay too; the hybrid family's unstacked ``shared_attn`` norms
    do not."""
    shapes = ref_param_shapes(cfg)
    return [len(shapes[ref.path]) >= 2 for ref in ref_leaf_map(cfg)]


@functools.lru_cache(maxsize=32)
def cast_paths(cfg: ModelConfig) -> frozenset:
    """The port paths of the leaves the reference's ``cast_params_once``
    casts to the compute dtype: two dims or more in its tree, and not
    ``A_log``."""
    shapes = ref_param_shapes(cfg)
    return frozenset(
        path for (path, _), ref in zip(port_leaves(cfg), ref_leaf_map(cfg))
        if len(shapes[ref.path]) >= 2 and "A_log" not in ref.path)
