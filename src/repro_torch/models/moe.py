"""Mixture-of-Experts FFN with expert parallelism over the sp axes
(counterpart of ``src/repro/models/moe.py``).

Expert parallelism reuses 2D-Attention's mesh: the experts are split over
``(head, outer, inner)`` (``EP_AXES``, the ``d_sp`` ranks of a data
group), and tokens travel by a hierarchical all-to-all, one exchange per
axis of size > 1 in the order ``head, outer, inner``.  Each exchange
splits the expert dim and concatenates the capacity dim, source index
major; the return path runs the inverse exchanges in reverse order.  Rank
``(h, o, i)`` owns expert block ``(h * outer + o) * inner + i``, the block
``PartitionSpec(EP_AXES)`` gives it in the reference.

Routing is capacity-based: top-k over the fp32 softmax of the router's
logits, each expert taking at most ``max(4, ceil(T * k * cf / E))``
assignments of the rank's ``T`` tokens in token-major order; an
assignment past capacity is dropped (its token keeps only the shared
experts and the residual).  A Switch-style aux loss is averaged over
every rank of the mesh.

The weights come in whole (one device, or a ZeRO gather at use); each
rank computes with its own block of experts, so the other experts get a
zero grad on that rank and the step's sum over the world completes them.

``DROPS``: set it to a list and every call appends ``(dropped, assigned)``
(a device count and an int) without a host sync.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.runtime import Runtime, all_reduce_, all_to_all
from repro_torch.core.topology import AXIS_HP, AXIS_INNER, AXIS_OUTER
from repro_torch.models.layers import _normal, glu_mlp_apply, init_glu_mlp

EP_AXES = (AXIS_HP, AXIS_OUTER, AXIS_INNER)

#: None, or a list each call appends ``(dropped, assigned)`` to
DROPS: list | None = None


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert intermediate
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    norm_topk: bool = True         # qwen3: renormalize top-k weights
    routed_scale: float = 1.0
    aux_weight: float = 1e-3


def init_moe(gen: torch.Generator, m: MoEDims, *, device=None):
    """The reference's distributions: router and ``w1`` / ``w3`` N(0,
    d_model^-0.5), ``w2`` N(0, d_ff^-0.5); ``(d, E)``, ``(E, d, f)`` and
    ``(E, f, d)`` as the reference stores them; the shared experts as a
    GLU MLP of width ``d_ff * n_shared``."""
    std = m.d_model ** -0.5
    p = {"router": _normal(gen, (m.d_model, m.n_experts), std, device),
         "w1": _normal(gen, (m.n_experts, m.d_model, m.d_ff), std, device),
         "w3": _normal(gen, (m.n_experts, m.d_model, m.d_ff), std, device),
         "w2": _normal(gen, (m.n_experts, m.d_ff, m.d_model),
                       m.d_ff ** -0.5, device)}
    if m.n_shared:
        p["shared"] = init_glu_mlp(gen, m.d_model, m.d_ff * m.n_shared,
                                   device=device)
    return p


def capacity(t: int, m: MoEDims) -> int:
    """Assignments an expert takes from ``t`` tokens: the reference's
    float arithmetic, ``max(4, ceil(t * k * cf / E))``."""
    return max(4, int(-(-t * m.top_k * m.capacity_factor // m.n_experts)))


def _ep_sizes(rt: Runtime) -> dict:
    pc = rt.pc
    return {AXIS_HP: pc.hp, AXIS_OUTER: pc.cp_outer, AXIS_INNER: pc.cp_inner}


def _expert_block(rt: Runtime) -> int:
    """This rank's block of experts: its row-major index over EP_AXES."""
    c, pc = rt.coord, rt.pc
    return (c.head * pc.cp_outer + c.outer) * pc.cp_inner + c.inner


def _dispatch(buf, group, rt: Runtime):
    """``(E, cap, D)`` -> ``(E/n, n*cap, D)``: expert block ``j`` goes to
    axis index ``j``, and the blocks that arrive are laid along capacity
    in source order."""
    n = torch.distributed.get_world_size(group)
    e, cap, d = buf.shape
    out = all_to_all(buf.reshape(n, e // n, cap, d), group, rt)
    return out.transpose(0, 1).reshape(e // n, n * cap, d)


def _combine(h, group, rt: Runtime):
    """The inverse of ``_dispatch``: ``(E/n, n*cap, D)`` -> ``(E, cap,
    D)``."""
    n = torch.distributed.get_world_size(group)
    e, nc, d = h.shape
    parts = h.reshape(e, n, nc // n, d).transpose(0, 1).contiguous()
    return all_to_all(parts, group, rt).reshape(n * e, nc // n, d)


class _Exchange(torch.autograd.Function):
    """One axis of the hierarchical all-to-all; its backward is the
    inverse exchange (the exchange is a permutation)."""

    @staticmethod
    def forward(ctx, x, group, rt, dispatch: bool):
        ctx.group, ctx.rt, ctx.dispatch = group, rt, dispatch
        return (_dispatch if dispatch else _combine)(x.contiguous(), group,
                                                     rt)

    @staticmethod
    def backward(ctx, g):
        inv = _combine if ctx.dispatch else _dispatch
        return inv(g.contiguous(), ctx.group, ctx.rt), None, None, None


class _MeanOverWorld(torch.autograd.Function):
    """Forward: the mean over every rank (the reference's ``pmean`` over
    all mesh axes).  Backward: each rank back-propagates only its own
    term, ``g / n``, so the sum over ranks of their parameter grads is the
    grad of the mean."""

    @staticmethod
    def forward(ctx, x, rt):
        ctx.n = rt.pc.num_devices
        return all_reduce_(x.clone(), rt) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_apply(p, x, rt: Runtime, m: MoEDims, seq_sharded: bool = True):
    """x ``(B, S, D)``, this rank's tokens.  Returns ``(y, aux_weight *
    aux)``, y in ``x.dtype`` and the aux an fp32 scalar.

    ``seq_sharded=False`` is the decode path: the tokens are the same on
    every sp rank of a data group, which each routes and dispatches (the
    expert compute is duplicated sp-fold, as in the reference).  Either
    way each rank routes the tokens it holds."""
    del seq_sharded          # the layout is the caller's; routing is local
    ep = rt.pc.sp
    if m.n_experts % ep:
        raise ValueError(f"{m.n_experts} experts do not split over "
                         f"{ep} ranks")
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_experts
    cap = capacity(t, m)
    xt = x.reshape(t, d)

    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    topw, topi = torch.topk(probs, k, dim=-1, sorted=True)     # (T, k)
    if m.norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    topw = topw * m.routed_scale

    # Token-major order decides who overflows: assignment a's slot is the
    # number of earlier assignments to its expert (the reference's cumsum
    # positions), its rank in a stable sort by expert.
    flat_e = topi.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(e, dtype=flat_e.dtype, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    first = counts.cumsum(0) - counts
    pos = torch.empty_like(flat_e).scatter_(
        0, order, torch.arange(t * k, device=flat_e.device)
        - first[flat_e[order]])
    keep = pos < cap
    slot = flat_e * cap + pos.clamp(max=cap - 1)
    if DROPS is not None:
        DROPS.append((t * k - keep.sum(), t * k))

    # Each kept (expert, slot) receives exactly one token; a dropped
    # assignment is written to one spare row past the buffer, which is cut
    # off (no host sync for the kept count).
    spare = torch.where(keep, slot, e * cap)
    buf = xt.new_zeros(e * cap + 1, d).index_copy(
        0, spare, xt.repeat_interleave(k, dim=0))[:e * cap]
    buf = buf.view(e, cap, d)

    sizes = _ep_sizes(rt)
    for ax in EP_AXES:
        if sizes[ax] > 1:
            buf = _Exchange.apply(buf, rt.group(ax), rt, True)
    # buf: (E/ep, cap*ep, D), this rank's experts and everyone's tokens.
    e_loc = e // ep
    lo = _expert_block(rt) * e_loc
    dt = buf.dtype
    w1, w3, w2 = (p[n][lo:lo + e_loc].to(dt) for n in ("w1", "w3", "w2"))
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    hout = torch.bmm(h, w2)
    for ax in reversed(EP_AXES):
        if sizes[ax] > 1:
            hout = _Exchange.apply(hout, rt.group(ax), rt, False)
    # hout: (E, cap, D)

    gathered = hout.reshape(e * cap, d)[slot]                  # (T*k, D)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    y = (gathered.float() * topw.reshape(-1, 1)).view(t, k, d).sum(1)
    y = y.view(b, s, d).to(x.dtype)

    # Switch-style load balance: fraction routed x mean probability.
    frac = counts.float() / t
    aux = e * (frac * probs.mean(0)).sum()
    if rt.mesh is not None:
        aux = _MeanOverWorld.apply(aux, rt)

    if m.n_shared:
        y = y + glu_mlp_apply(p["shared"], x, act="silu")
    return y, m.aux_weight * aux
