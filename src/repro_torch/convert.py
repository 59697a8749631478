"""Weight bridge from the JAX package's parameter tree to the port's.

The JAX package stores linear weights ``(d_in, d_out)`` and stacks the
layers of each period slot over a leading group axis
(``params["blocks"][slot][leaf][group]``).  The port keeps PyTorch's
``(d_out, d_in)`` and one dict per layer (``params["layers"][i]``, layer
``i = group * period + slot``).  The tree comes in as nested dicts and
lists of numpy arrays (``jax.tree.map(np.asarray, params)``), so this
module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import ModelConfig, _require_dense


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _convert(tree, device):
    """Map a (sub)tree, transposing every 2-D ``w`` (a linear weight)."""
    if isinstance(tree, dict):
        return {k: (_tensor(np.swapaxes(v, -1, -2), device)
                    if k == "w" and np.ndim(v) == 2 else _convert(v, device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _tensor(tree, device)


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def from_jax_params(tree, cfg: ModelConfig, *, device=None) -> dict:
    """The port's parameters from the JAX package's tree (numpy leaves)."""
    _require_dense(cfg)
    period = cfg.period
    out = {"embed": _convert(tree["embed"], device),
           "final_norm": _convert(tree["final_norm"], device)}
    if "lm_head" in tree:
        out["lm_head"] = _convert(tree["lm_head"], device)
    layers = []
    for i in range(cfg.num_layers):
        g, slot = divmod(i, period)
        layers.append(_convert(_index(tree["blocks"][slot], g), device))
    out["layers"] = layers
    return out


def caches_to_numpy(caches):
    """The port's caches as nested dicts and lists of fp32 numpy arrays, in
    the JAX package's structure (the two already share it)."""
    if isinstance(caches, dict):
        return {k: caches_to_numpy(v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return [caches_to_numpy(v) for v in caches]
    return caches.detach().float().cpu().numpy()
