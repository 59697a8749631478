"""AdamW with a warmup + cosine schedule and global-norm clipping
(counterpart of ``src/repro/train/optimizer.py``).

The reference's math, leaf by leaf: the gradients are clipped to a global
norm, the moments are bias-corrected, and the weight decay is decoupled
and applies to matrices only (``p.ndim >= 2``); ``torch.optim.AdamW``
decays every parameter, so it is not used.  The reference is functional;
here the parameters and moments are updated in place (``torch._foreach_*``
over the leaves), which keeps a single copy of the fp32 masters and
moments.  The clipping factor stays on the device, so an update never
waits for the host.  Sharded moments (hybrid ZeRO) and int8 gradient
compression are ROADMAP queue 1, item 7.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._pytree import tree_leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params):
    """Zero moments with the params' structure; ``step`` counts updates."""
    zeros = lambda t: torch.zeros_like(t)      # noqa: E731
    return {"m": torch.utils._pytree.tree_map(zeros, params),
            "v": torch.utils._pytree.tree_map(zeros, params),
            "step": 0}


def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm over every leaf, as a device scalar."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x.float()) for x in tree_leaves(tree)]))


#: Elements per group updated together: it bounds the update's temporaries
#: (three fp32 copies of a group) to about 0.8 GB.
GROUP_NUMEL = 1 << 26


def _groups(sizes, max_numel: int, splits=None):
    """Groups of ``(leaf, start, stop)`` flat ranges of the leaves whose
    element counts are ``sizes``, each group at most ``max_numel``
    elements: consecutive leaves share a group, and a leaf larger than
    that (an embedding table) is split into ranges of its own where
    ``splits[leaf]`` allows it (default: everywhere)."""
    group, n = [], 0
    for i, size in enumerate(sizes):
        step = max_numel if splits is None or splits[i] else max(size, 1)
        for start in range(0, size, step):
            stop = min(start + step, size)
            if n and n + stop - start > max_numel:
                yield group
                group, n = [], 0
            group.append((i, start, stop))
            n += stop - start
    if group:
        yield group


def _part(x, a: int, b: int):
    """The flat range ``[a, b)`` of a leaf (a view where the leaf is
    contiguous, as every split leaf is)."""
    return x if b - a == x.numel() else x.reshape(-1)[a:b]


def adamw_update(params, grads, state, cfg: OptConfig):
    """One update of ``params`` and ``state`` in place; returns
    ``(params, state, metrics)`` with the device scalar ``grad_norm`` and
    the float ``lr``.  ``grads`` are read, never written."""
    step = state["step"] + 1
    p, g = tree_leaves(params), tree_leaves(grads)
    m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
    gnorm = global_norm(g)
    scale = (cfg.clip_norm / (gnorm + 1e-12)).clamp(max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    # Only contiguous leaves (and their moments) have flat views to split.
    splits = [x.is_contiguous() and y.is_contiguous() and z.is_contiguous()
              for x, y, z in zip(p, m, v)]
    for grp in _groups([x.numel() for x in p], GROUP_NUMEL, splits):
        pg, mg, vg = ([_part(t[i], a, b) for i, a, b in grp]
                      for t in (p, m, v))
        gg = torch._foreach_mul([_part(g[i], a, b).float()
                                 for i, a, b in grp], scale)
        torch._foreach_mul_(mg, b1)
        torch._foreach_add_(mg, gg, alpha=1 - b1)
        torch._foreach_mul_(vg, b2)
        torch._foreach_addcmul_(vg, gg, gg, value=1 - b2)
        del gg
        denom = torch._foreach_div(vg, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        step_dir = torch._foreach_div(mg, c1)
        torch._foreach_div_(step_dir, denom)
        del denom
        mats = [j for j, (i, _, _) in enumerate(grp) if p[i].ndim >= 2]
        if mats:       # decoupled weight decay on matrices only
            torch._foreach_add_([step_dir[j] for j in mats],
                                [pg[j] for j in mats],
                                alpha=cfg.weight_decay)
        torch._foreach_add_(pg, step_dir, alpha=-lr)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
