"""Mamba1 / Mamba2 blocks with the context-parallel scan (counterpart of
``src/repro/models/ssm.py``).

2D-Attention does not apply to attention-free layers, but the context
dimension does: the sequence stays sharded over every axis of
``SEQ_AXES`` (contiguous pieces, ``core/topology.py::seq_slice``) and the
recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t h_t``
crosses the shards through a small state hand-off, as in the reference:

* every rank scans its piece from ``h0 = 0``, the ranks gather each
  piece's total decay and final state (``core/runtime.py::gather_stack``,
  whose backward is a reduce-scatter), each forms its exclusive prefix,
  and the prefix enters this rank's output as the closed-form correction
  ``C_t . (exp(A cumsum(dt)_t) h0)``;
* the causal depthwise conv takes the previous rank's last ``d_conv - 1``
  inputs in front of its own (zeros on the first rank).

The scans are torch ops (the reference's are jnp ops that XLA compiles).
The sequence runs in groups of whole segments whose largest fp32 tensor
stays within ``SCAN_BYTES``; each group is a ``torch.utils.checkpoint``
whose carry is the state at its start, so the backward stores one state a
group and recomputes the group (the reference checkpoints each segment of
its ``lax.scan``).  Inside a group:

* Mamba1 (``A`` diagonal, ``(d_inner, N)``): the recurrence a position at
  a time within the segments of ``seg`` tokens, each step batched over
  the group's segments: once for each segment's state from zero, then,
  after a Hillis-Steele scan over the segments' (decay, state) pairs
  gives each segment's start, once more from those starts, contracting
  each state with C as it comes.  A segment's decay is ``exp(A sum(dt))``;
  no cumulative decay is ever divided by.
* Mamba2 (``A`` a scalar a head): the closed form within each segment of
  ``SSD_SEG`` tokens (the decay from token ``s`` to ``t`` is the ``exp`` of
  the sum of ``dt A`` over ``(s, t]``, summed from ``s + 1`` by a masked
  cumsum, never a difference of prefix sums, which would cancel), the
  segment's state from zero, and a Hillis-Steele scan over the segments'
  (decay, state) pairs.  The per-token state ``(heads, hd, N)`` is never
  formed.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.runtime import axes_groups, gather_stack
from repro_torch.core.topology import SEQ_AXES
from repro_torch.models.layers import (_normal, init_linear, init_rmsnorm,
                                       linear_apply, rmsnorm_apply)

#: fp32 bytes of one scan group's largest tensor: Mamba1's ``(B, tokens,
#: d_inner, N)`` decays and increments, Mamba2's ``(B, segments, heads,
#: hd, N)`` segment states.  Fewer, larger groups launch fewer kernels:
#: Mamba1's steps are batched over a group's segments.
SCAN_BYTES = 1 << 30
#: Mamba2's closed-form segment, at least the config's ``seg`` (16 in
#: zamba2-7b, which in the reference sets only its scan's residual
#: memory): longer segments cut the segment states, whose scan moves the
#: most bytes, for ``(seg, seg)`` decay matrices a head.
SSD_SEG = 64


# ---------------------------------------------------------------------------
# Dims and init
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mamba1Dims:
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0          # 0 => ceil(d_model / 16)
    seg: int = 64             # scan segment length

    def __post_init__(self):
        if self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", (self.d_model + 15) // 16)


@dataclasses.dataclass(frozen=True)
class Mamba2Dims:
    d_model: int
    d_inner: int
    d_state: int = 64
    d_conv: int = 4
    head_dim: int = 64
    seg: int = 32

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def init_mamba1(gen: torch.Generator, m: Mamba1Dims, *, device=None):
    """The reference's distributions: linear weights N(0, d_in^-0.5),
    ``conv_w`` N(0, 0.1), ``A_log = log(1..N)`` on every channel, ``D``
    ones, the biases zero."""
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": init_linear(gen, m.d_model, 2 * m.d_inner, device=device),
        "conv_w": _normal(gen, (m.d_conv, m.d_inner), 0.1, device),
        "conv_b": torch.zeros((m.d_inner,), device=device),
        "x_proj": init_linear(gen, m.d_inner, m.dt_rank + 2 * m.d_state,
                              device=device),
        "dt_proj": init_linear(gen, m.dt_rank, m.d_inner, bias=True,
                               device=device),
        "A_log": torch.log(a).repeat(m.d_inner, 1),
        "D": torch.ones((m.d_inner,), device=device),
        "out_proj": init_linear(gen, m.d_inner, m.d_model, device=device),
    }


def init_mamba2(gen: torch.Generator, m: Mamba2Dims, *, device=None):
    """The reference's distributions: ``A_log`` and ``dt_bias`` zero, ``D``
    ones, the gated norm's weight zero."""
    nh = m.n_heads
    return {
        "in_proj": init_linear(gen, m.d_model,
                               2 * m.d_inner + 2 * m.d_state + nh,
                               device=device),
        "conv_w": _normal(gen, (m.d_conv, m.conv_dim), 0.1, device),
        "conv_b": torch.zeros((m.conv_dim,), device=device),
        "A_log": torch.zeros((nh,), device=device),
        "D": torch.ones((nh,), device=device),
        "dt_bias": torch.zeros((nh,), device=device),
        "norm": init_rmsnorm(m.d_inner, device=device),
        "out_proj": init_linear(gen, m.d_inner, m.d_model, device=device),
    }


# ---------------------------------------------------------------------------
# Scan machinery
# ---------------------------------------------------------------------------

def _shifted(x, dim: int, k: int, fill: float):
    """``x`` moved ``k`` places up ``dim``, the first ``k`` places
    ``fill`` (a pad, whose backward is a view, not a zero-filled copy)."""
    pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [k, 0]
    return F.pad(x.narrow(dim, 0, x.shape[dim] - k), pad, value=fill)


def _affine_scan(a, u, dim: int):
    """Inclusive scan of ``h = a * h + u`` from ``h = 0`` along ``dim``
    (Hillis-Steele: log2(n) out-of-place steps).  Returns the cumulative
    decays and the states; ``a`` may broadcast against ``u`` off ``dim``."""
    n = u.shape[dim]
    k = 1
    while k < n:
        u = torch.addcmul(u, a, _shifted(u, dim, k, 0.0))
        a = a * _shifted(a, dim, k, 1.0)
        k *= 2
    return a, u


def _carry(h, a_end, u_end):
    """``(states at each segment's start, state after the last)`` from the
    segments' totals ``(B, n, ...)`` and the state ``h`` before the
    first.  The last state is a copy: a decode state that viewed the
    scan's result would keep all of it alive."""
    u_end = torch.cat([u_end[:, :1] + a_end[:, :1] * h[:, None],
                       u_end[:, 1:]], 1)
    _, h_end = _affine_scan(a_end, u_end, 1)
    return (torch.cat([h[:, None], h_end[:, :-1]], 1),
            h_end[:, -1].clone())


def _ckpt(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _seg_len(seg: int, s: int) -> int:
    """The segment length: the config's, cut to divide the local length."""
    return math.gcd(min(seg, s), s)


def _groups(fn, h, xs, s: int, seg: int, seg_bytes: int):
    """Run ``fn(h, seg, *group_xs) -> (h, y)`` over groups of whole
    segments along dim 1 of ``xs``, each a checkpoint whose largest tensor
    is about ``seg_bytes`` a segment; returns ``(y, h)`` with the groups'
    ``y`` concatenated on dim 1."""
    tokens = max(1, SCAN_BYTES // max(seg_bytes, 1)) * seg
    ys = []
    for t0 in range(0, s, tokens):
        h, y = _ckpt(fn, h, seg, *(x[:, t0:t0 + tokens] for x in xs))
        ys.append(y)
    return torch.cat(ys, 1), h


def _m1_group(h, seg: int, dt, bm, cm, x, a_diag):
    """One group: dt, x ``(B, T, di)``, bm / cm ``(B, T, N)``, h ``(B, di,
    N)`` -> (state after the group, y ``(B, T, di)``).  Two passes over
    the ``seg`` positions, each step batched over the group's segments:
    the first gives each segment's state from zero at its end, the carry
    gives each segment's start, the second steps each segment from its
    start and contracts each state with C as it comes, so the states are
    never stacked into one ``(T, di, N)`` tensor."""
    b, t, di = dt.shape
    n = bm.shape[-1]
    k = t // seg
    dts = dt.reshape(b, k, seg, di)
    # unbind, not indexing: one backward node stacks the positions' grads
    # (an index's backward writes a whole zero tensor per position)
    a = torch.exp(dts[..., None] * a_diag).unbind(2)  # seg x (B, k, di, N)
    u = ((dt * x).reshape(b, k, seg, di)[..., None]
         * bm.reshape(b, k, seg, 1, n)).unbind(2)
    v = u[0]
    for i in range(1, seg):
        v = torch.addcmul(u[i], a[i], v)
    h_start, h_out = _carry(h, torch.exp(dts.sum(2)[..., None] * a_diag), v)
    ys = []
    for a_i, u_i, c_i in zip(a, u, cm.reshape(b, k, seg, n).unbind(2)):
        h_start = torch.addcmul(u_i, a_i, h_start)
        ys.append(torch.einsum("bkdn,bkn->bkd", h_start, c_i))
    return h_out, torch.stack(ys, 2).reshape(b, t, di)


def _mamba1_scan(dt, bm, cm, x, a_diag, seg: int):
    """``y (B, S, di)`` fp32 and the state after the piece ``(B, di, N)``,
    from ``h0 = 0``."""
    b, s, di = dt.shape
    n = bm.shape[-1]
    seg = _seg_len(seg, s)
    h0 = dt.new_zeros((b, di, n))
    return _groups(lambda h, seg, *xs: _m1_group(h, seg, *xs, a_diag), h0,
                   (dt, bm, cm, x), s, seg, b * seg * di * n * 4)


def _m2_group(h, seg: int, dt, bm, cm, x, a_head):
    """One group: dt ``(B, T, nh)``, bm / cm ``(B, T, N)``, x ``(B, T, nh,
    hd)``, h ``(B, nh, hd, N)`` -> (state after the group, y ``(B, T, nh,
    hd)``)."""
    b, t, nh = dt.shape
    hd, n = x.shape[-1], bm.shape[-1]
    k = t // seg
    dt = dt.reshape(b, k, seg, nh)
    bm, cm = bm.reshape(b, k, seg, n), cm.reshape(b, k, seg, n)
    xdt = x.reshape(b, k, seg, nh, hd) * dt[..., None]
    da = (dt * a_head).transpose(2, 3)                # (B, k, nh, seg)
    cum = torch.cumsum(da, 3).transpose(2, 3)         # (B, k, seg, nh)
    # the decay from s to t: the sum of dA over (s, t], summed from s + 1
    # (a cumsum down the masked columns) rather than a difference of
    # prefix sums, which would cancel
    ones = torch.ones(seg, seg, dtype=torch.bool, device=dt.device)
    sums = torch.cumsum(da[..., :, None].expand(*da.shape, seg)
                        .masked_fill(~ones.tril(-1), 0.0), -2)
    decay = torch.exp(sums.masked_fill(~ones.tril(), float("-inf")))
    g = torch.einsum("bktn,bksn->bkts", cm, bm)
    y = torch.einsum("bkhts,bkshd->bkthd", decay * g[:, :, None], xdt)
    to_end = decay[:, :, :, -1].transpose(2, 3)       # s -> the segment end
    st = torch.einsum("bkshd,bksn->bkhdn", to_end[..., None] * xdt, bm)
    h_start, h_out = _carry(h, torch.exp(cum[:, :, -1])[..., None, None], st)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bktn,bkhdn->bkthd", cm, h_start)
    return h_out, y.reshape(b, t, nh, hd)


def _mamba2_scan(dt, bm, cm, x, a_head, seg: int):
    """``y (B, S, nh, hd)`` fp32 and the state after the piece ``(B, nh,
    hd, N)``, from ``h0 = 0``."""
    b, s, nh = dt.shape
    hd, n = x.shape[-1], bm.shape[-1]
    seg = _seg_len(seg, s)
    h0 = dt.new_zeros((b, nh, hd, n))
    return _groups(lambda h, seg, *xs: _m2_group(h, seg, *xs, a_head), h0,
                   (dt, bm, cm, x), s, seg,
                   b * nh * max(hd * n, seg * seg, seg * hd) * 4)


# ---------------------------------------------------------------------------
# Across the sequence ranks
# ---------------------------------------------------------------------------

def _seq_group(rt):
    """This rank's group over ``SEQ_AXES``, in sequence order, or None on
    one device."""
    if rt.mesh is None or rt.pc.sp == 1:
        return None
    return axes_groups(rt, [SEQ_AXES])[SEQ_AXES]


def _tied(x, *stacked):
    """``x``, with each gathered ``stacked`` joined to its graph at a
    weight of nothing (an empty slice), so every rank's backward reaches
    the gather's reduce-scatter: a rank whose result reads none of it (the
    first piece's halo and initial state) would skip it, and the ranks'
    collectives would part."""
    return x + sum(t.reshape(-1)[:0].sum() for t in stacked)


def _conv_input(x, halo: int, ag, rt):
    """``(x with the previous piece's last halo tokens in front, the last
    piece's last halo tokens)``; the first piece gets zeros (the causal
    pad).  The tail is a copy: a decode state that viewed ``x`` would keep
    the whole projection alive."""
    tail = x[:, -halo:]
    if ag is None:
        return torch.cat([torch.zeros_like(tail), x], 1), tail.clone()
    tails = gather_stack(tail, ag, rt)                # (R, B, halo, C)
    prev = tails[ag.index - 1] if ag.index > 0 else \
        _tied(torch.zeros_like(tail), tails)
    return torch.cat([prev, x], 1), tails[-1]


def _causal_conv(x, w, b, dtype):
    """Depthwise causal conv, summed in fp32 tap by tap.  x ``(B, S + K -
    1, C)`` pre-padded, w ``(K, C)``."""
    k = w.shape[0]
    s = x.shape[1] - (k - 1)
    x, w = x.float(), w.float()
    y = x[:, :s] * w[0]
    for i in range(1, k):
        y = torch.addcmul(y, x[:, i:i + s], w[i])
    return (y + b.float()).to(dtype)


def _cross_rank_state(d_tot, h_fin, ag, rt):
    """``(h0 of this piece, the state after the whole sequence)`` from every
    piece's total decay and final state (the latter the same on every
    rank)."""
    ds, hs = gather_stack(d_tot, ag, rt), gather_stack(h_fin, ag, rt)
    prefix = [_tied(torch.zeros_like(h_fin), ds, hs)]
    for r in range(ag.size):
        prefix.append(prefix[-1] * ds[r] + hs[r])
    return prefix[ag.index], prefix[-1]


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba)
# ---------------------------------------------------------------------------

def _m1_correction(cum, cm, h_init, a_diag):
    return torch.einsum("bsdn,bsn->bsd",
                        torch.exp(cum[..., None] * a_diag) * h_init[:, None],
                        cm)


def mamba1_apply(p, x, rt, m: Mamba1Dims, return_state: bool = False):
    """x ``(B, S, d_model)``, this rank's piece of the sequence -> the same
    shape, and with ``return_state`` the decode state: ``h`` after the
    whole sequence (fp32) and ``conv``, the last ``d_conv - 1`` inputs of
    the conv (the last piece's), both the same on every rank."""
    ag = _seq_group(rt)
    xz = linear_apply(p["in_proj"], x)
    x_in, z = xz.chunk(2, dim=-1)
    xp, tail = _conv_input(x_in, m.d_conv - 1, ag, rt)
    x_conv = F.silu(_causal_conv(xp, p["conv_w"], p["conv_b"], x_in.dtype))
    dbc = linear_apply(p["x_proj"], x_conv)
    dt = F.softplus(linear_apply(p["dt_proj"], dbc[..., :m.dt_rank]).float())
    bm = dbc[..., m.dt_rank:m.dt_rank + m.d_state].float()
    cm = dbc[..., m.dt_rank + m.d_state:].float()
    a_diag = -torch.exp(p["A_log"].float())
    y, h_last = _mamba1_scan(dt, bm, cm, x_conv.float(), a_diag, m.seg)
    if ag is not None:
        d_tot = torch.exp(dt.sum(1)[..., None] * a_diag)
        h_init, h_last = _cross_rank_state(d_tot, h_last, ag, rt)
        b, s, di = dt.shape
        tokens = max(1, SCAN_BYTES // (b * di * m.d_state * 4))
        cum = torch.cumsum(dt, 1)
        y = y + torch.cat([_ckpt(_m1_correction, cum[:, t0:t0 + tokens],
                                 cm[:, t0:t0 + tokens], h_init, a_diag)
                           for t0 in range(0, s, tokens)], 1)
    y = y.to(x_conv.dtype) + x_conv * p["D"].to(x_conv.dtype)
    out = linear_apply(p["out_proj"], y * F.silu(z))
    if return_state:
        return out, {"h": h_last, "conv": tail}
    return out


def mamba1_decode(p, x, state, m: Mamba1Dims):
    """One token: x ``(B, 1, d_model)``; state ``{"h": (B, di, N) fp32,
    "conv": (B, d_conv - 1, di)}`` -> ``(y (B, 1, d_model), new state)``."""
    xz = linear_apply(p["in_proj"], x)
    x_in, z = xz.chunk(2, dim=-1)
    conv_buf = torch.cat([state["conv"], x_in], 1)
    x_conv = F.silu(_causal_conv(conv_buf, p["conv_w"], p["conv_b"],
                                 x_in.dtype))
    dbc = linear_apply(p["x_proj"], x_conv)
    dt = F.softplus(linear_apply(p["dt_proj"], dbc[..., :m.dt_rank]).float())
    bm = dbc[:, 0, m.dt_rank:m.dt_rank + m.d_state].float()
    cm = dbc[:, 0, m.dt_rank + m.d_state:].float()
    a = torch.exp(dt[:, 0, :, None] * -torch.exp(p["A_log"].float()))
    u = (dt[:, 0] * x_conv[:, 0].float())[..., None] * bm[:, None, :]
    h = state["h"] * a + u
    y = torch.einsum("bdn,bn->bd", h, cm)[:, None]
    y = y.to(x.dtype) + x_conv * p["D"].to(x.dtype)
    return (linear_apply(p["out_proj"], y * F.silu(z)),
            {"h": h, "conv": conv_buf[:, 1:]})


# ---------------------------------------------------------------------------
# Mamba2 (zamba2)
# ---------------------------------------------------------------------------

def _m2_split(zxbcdt, m: Mamba2Dims):
    z = zxbcdt[..., :m.d_inner]
    xbc = zxbcdt[..., m.d_inner:m.d_inner + m.conv_dim]
    return z, xbc, zxbcdt[..., m.d_inner + m.conv_dim:]


def _m2_out(p, y, x_in, z, m: Mamba2Dims):
    """The ``D`` skip, the gated RMSNorm ``rmsnorm(y * silu(z))`` and the
    output projection."""
    y = y + x_in * p["D"].repeat_interleave(m.head_dim).to(x_in.dtype)
    return linear_apply(p["out_proj"],
                        rmsnorm_apply(p["norm"], y * F.silu(z)))


def mamba2_apply(p, x, rt, m: Mamba2Dims, return_state: bool = False):
    """x ``(B, S, d_model)``, this rank's piece -> the same shape, and with
    ``return_state`` the decode state: ``h`` ``(B, heads, hd, N)`` after the
    whole sequence and ``conv``, the last ``d_conv - 1`` pre-activation
    conv inputs (the last piece's)."""
    ag = _seq_group(rt)
    z, xbc_pre, dt_raw = _m2_split(linear_apply(p["in_proj"], x), m)
    xp, tail = _conv_input(xbc_pre, m.d_conv - 1, ag, rt)
    xbc = F.silu(_causal_conv(xp, p["conv_w"], p["conv_b"], xbc_pre.dtype))
    x_in = xbc[..., :m.d_inner]
    bm = xbc[..., m.d_inner:m.d_inner + m.d_state].float()
    cm = xbc[..., m.d_inner + m.d_state:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a_head = -torch.exp(p["A_log"].float())
    b, s, _ = x_in.shape
    x_h = x_in.reshape(b, s, m.n_heads, m.head_dim).float()
    y, h_last = _mamba2_scan(dt, bm, cm, x_h, a_head, max(m.seg, SSD_SEG))
    if ag is not None:
        d_tot = torch.exp(dt.sum(1) * a_head)[..., None, None]
        h_init, h_last = _cross_rank_state(d_tot, h_last, ag, rt)
        decay = torch.exp(torch.cumsum(dt, 1) * a_head)       # (B, S, nh)
        y = y + decay[..., None] * torch.einsum("bsn,bhdn->bshd", cm,
                                                h_init)
    out = _m2_out(p, y.reshape(b, s, m.d_inner).to(x_in.dtype), x_in, z, m)
    if return_state:
        return out, {"h": h_last, "conv": tail}
    return out


def mamba2_decode(p, x, state, m: Mamba2Dims):
    """One token: state ``{"h": (B, heads, hd, N) fp32, "conv": (B, d_conv
    - 1, conv_dim)}`` -> ``(y (B, 1, d_model), new state)``."""
    b = x.shape[0]
    z, xbc, dt_raw = _m2_split(linear_apply(p["in_proj"], x), m)
    conv_buf = torch.cat([state["conv"], xbc], 1)
    xbc = F.silu(_causal_conv(conv_buf, p["conv_w"], p["conv_b"], x.dtype))
    x_in = xbc[..., :m.d_inner]
    bm = xbc[:, 0, m.d_inner:m.d_inner + m.d_state].float()
    cm = xbc[:, 0, m.d_inner + m.d_state:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())[:, 0]  # (B, nh)
    a = torch.exp(dt * -torch.exp(p["A_log"].float()))[..., None, None]
    x_h = x_in[:, 0].reshape(b, m.n_heads, m.head_dim).float()
    u = (dt[..., None] * x_h)[..., None] * bm[:, None, None, :]
    h = state["h"] * a + u
    y = torch.einsum("bhdn,bn->bhd", h, cm).reshape(b, 1, m.d_inner)
    return (_m2_out(p, y.to(x.dtype), x_in, z, m),
            {"h": h, "conv": conv_buf[:, 1:]})
