"""AdamW with a warmup + cosine schedule and global-norm clipping
(counterpart of ``src/repro/train/optimizer.py``).

The reference's math, leaf by leaf: the gradients are clipped to a global
norm, the moments are bias-corrected, and the weight decay is decoupled
and applies to the reference's leaves of two dims or more;
``torch.optim.AdamW`` decays every parameter, so it is not used.  The
reference stacks each layer's norm weights into ``(G, d)`` leaves, which
it decays, so the port's ``(d,)`` leaves take their ``decay`` mask from
the reference's tree (``convert.decay_mask``).  The reference is
functional; here the parameters and moments are updated in place
(``torch._foreach_*`` over the leaves), which keeps a single copy of the
fp32 masters and moments.  Under hybrid ZeRO the leaves are this rank's
shards and the caller passes the global grad norm
(``ZeroLayout.grad_norm``).  The clipping factor stays on the device, so
an update never waits for the host.

``quantize_int8`` / ``compressed_psum``: int8 error-feedback gradient
compression over a process group (no path of the reference calls it).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core.runtime import all_reduce_


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


def adamw_update(params, grads, state, cfg: OptConfig, *, decay=None,
                 gnorm=None):
    """One update of ``params`` and ``state`` in place; returns
    ``(params, state, metrics)`` with the device scalar ``grad_norm`` and
    the float ``lr``.  ``grads`` are read, never written.  ``decay``: per
    leaf, whether it decays (default: ``ndim >= 2``, right for a tree of
    the reference's leaves); ``gnorm``: the global grad norm, where the
    leaves are shards of it (default: the norm of ``grads``)."""
    step = state["step"] + 1
    p, g = tree_leaves(params), tree_leaves(grads)
    m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
    if decay is None:
        decay = [x.ndim >= 2 for x in p]
    if gnorm is None:
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
        mats = [j for j, (i, _, _) in enumerate(grp) if decay[i]]
        if mats:       # decoupled weight decay
            torch._foreach_add_([step_dir[j] for j in mats],
                                [pg[j] for j in mats],
                                alpha=cfg.weight_decay)
        torch._foreach_add_(pg, step_dir, alpha=-lr)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------

def quantize_int8(x, err):
    """Symmetric per-tensor int8 quantization with error feedback: returns
    ``(q, scale, new_err)``; ``dequantize_int8(q, scale)`` reconstructs and
    the residual ``new_err`` is carried into the next step."""
    xf = x.float() + err
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale, xf - q.float() * scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_psum(g, err, group, rt):
    """The sum over ``group`` of the int8-quantized ``g`` (dequantized
    before the wire), with local error feedback: returns ``(g_sum,
    new_err)``."""
    q, scale, new_err = quantize_int8(g, err)
    return all_reduce_(dequantize_int8(q, scale), rt, group), new_err
