"""2D-Attention: head-parallel x context-parallel distributed attention
(counterpart of ``src/repro/core/attention2d.py``, the resident path).

Every rank runs this per-shard program on its own process:

* **SeqAlltoAll** (Ulysses): ``all_to_all_single`` over the ``head`` group
  takes Q/K/V from ``(S/d_sp sequence, all heads)`` to ``(S/d_cp
  sequence, H/d_hp heads)`` and back.  When ``d_hp > H_kv`` the KV heads
  are repeated first; autograd sums the replicas' grads.
* **Double-Ring-Attention**: the context group is ``outer x inner``.  KV
  chunks rotate with ``batch_isend_irecv``: the inner ring every step, the
  outer ring once per outer step, issued before the inner loop so that it
  overlaps the whole inner round (the paper's prefetch).  Each shift
  returns a handle that is waited on just before its result is used.
* **Zigzag**: context rank ``i`` owns logical chunks ``(i, 2cp-1-i)`` (the
  data pipeline lays tokens out so).  Every ring step is one forward
  kernel call, or one dq + dk/dv pair, with the ``(i, j)`` rank pair as
  ``BandMask`` launch scalars: the kernels' logical-position masking and
  tile skip make the ``j < i`` / ``j == i`` / ``j > i`` cases.
* The ring is one ``torch.autograd.Function``: the forward combines the
  steps' ``(out, lse)`` with the flash rule; the backward runs the ring
  again, keeps dq local and lets dk/dv ride with their KV chunk until they
  are home.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.runtime import all_gather, all_to_all, shift
from repro_torch.core.topology import AXIS_HP, AXIS_INNER, AXIS_OUTER
from repro_torch.kernels.ops import (flash_attention, flash_bwd_chunk,
                                     flash_fwd_chunk)
from repro_torch.kernels.ref import BandMask, combine_pair


class Attn2DConfig(NamedTuple):
    """Static 2D-Attention configuration."""
    hp: int = 1
    n_out: int = 1            # outer ring size (d_cp / w)
    w: int = 1                # inner ring size (paper's w)
    causal: bool = True
    zigzag: bool = True       # False: contiguous chunks
    window: int | None = None
    softcap: float = 0.0
    scale: float | None = None
    impl: str = "auto"
    axis_hp: str = AXIS_HP
    axis_outer: str = AXIS_OUTER
    axis_inner: str = AXIS_INNER

    @property
    def cp(self) -> int:
        return self.n_out * self.w


def attn2d_config(pc, *, impl: str, causal: bool = True,
                  zigzag: bool = True, window: int | None = None,
                  softcap: float = 0.0,
                  scale: float | None = None) -> Attn2DConfig:
    """The one place a ``ParallelConfig`` becomes an ``Attn2DConfig``."""
    return Attn2DConfig(hp=pc.hp, n_out=pc.cp_outer, w=pc.cp_inner,
                        causal=causal, zigzag=zigzag, window=window,
                        softcap=softcap, scale=scale, impl=impl)


class RingConfig(NamedTuple):
    """The ring's configuration: its shape and mask, this rank's outer
    and inner process groups, and the runtime whose collectives move the
    chunks."""
    n_out: int
    w: int
    causal: bool
    zigzag: bool
    window: int | None
    softcap: float
    scale: float
    impl: str
    group_outer: object
    group_inner: object
    rt: object

    @property
    def cp(self) -> int:
        return self.n_out * self.w


#: Tags of the two pairs a ring moves: K/V, and their dK/dV.
KV_TAG, DKV_TAG = 0, 2


def _ring_indices(cfg: RingConfig):
    i_out = dist.get_rank(cfg.group_outer)
    i_in = dist.get_rank(cfg.group_inner)
    return i_out, i_in, i_out * cfg.w + i_in


def _visiting(cfg: RingConfig, i_out: int, i_in: int, o: int, t: int):
    """Global cp index of the KV chunk visiting this rank at step (o, t)."""
    j_out = (i_out - o) % cfg.n_out
    j_in = (i_in - t) % cfg.w
    return j_out * cfg.w + j_in


def _kw(cfg: RingConfig):
    return dict(softcap=cfg.softcap, scale=cfg.scale, impl=cfg.impl)


def _step_band(cfg: RingConfig, i: int, j: int, s_loc: int) -> BandMask:
    """The (i, j) ring step's mask as a ``BandMask`` over the local
    shapes: the kernels take its ints as launch scalars."""
    if cfg.zigzag:
        return BandMask.zigzag(i, j, s_loc // 2, cfg.cp)
    # Contiguous chunks: chunk r is cp rank r.  Absolute offsets on both
    # sides keep doc-start comparisons (global positions) right.
    return BandMask(i * s_loc, i * s_loc, j * s_loc, j * s_loc, 0, 0)


# ---------------------------------------------------------------------------
# Ring forward
# ---------------------------------------------------------------------------

def _step_fwd(q, kc, vc, doc, o: int, t: int, i_out, i_in, i,
              cfg: RingConfig):
    """Partial (out, lse) of local q against the visiting KV chunk.  The
    doc-start table is q-side data: it stays while KV rotates."""
    kw = _kw(cfg)
    if not cfg.causal:
        return flash_fwd_chunk(q, kc, vc, causal=False, **kw)
    j = _visiting(cfg, i_out, i_in, o, t)
    return flash_fwd_chunk(q, kc, vc, causal=True, window=cfg.window,
                           band=_step_band(cfg, i, j, q.shape[1]),
                           q_doc_start=doc, **kw)


def _ring_fwd(q, k, v, doc, cfg: RingConfig):
    i_out, i_in, i = _ring_indices(cfg)
    acc_o = acc_l = None
    k0, v0 = k, v
    for o in range(cfg.n_out):
        nxt_outer = None
        if o < cfg.n_out - 1:
            # Outer prefetch (Alg. 2 line 3): issued before the inner loop.
            nxt_outer = shift((k0, v0), cfg.group_outer, cfg.rt, KV_TAG)
        kc, vc = k0, v0
        for t in range(cfg.w):
            nxt_inner = None
            if t < cfg.w - 1:
                nxt_inner = shift((kc, vc), cfg.group_inner, cfg.rt, KV_TAG)
            po, pl = _step_fwd(q, kc, vc, doc, o, t, i_out, i_in, i, cfg)
            if acc_o is None:
                acc_o, acc_l = po.float(), pl
            else:
                acc_o, acc_l = combine_pair(acc_o, acc_l, po, pl)
            if nxt_inner is not None:
                kc, vc = nxt_inner.wait()
        if nxt_outer is not None:
            k0, v0 = nxt_outer.wait()
    return acc_o.to(q.dtype), acc_l


# ---------------------------------------------------------------------------
# Ring backward
# ---------------------------------------------------------------------------

def _step_bwd(q, kc, vc, out, lse, do, doc, o: int, t: int, i_out, i_in, i,
              cfg: RingConfig):
    """(dq, dk, dv) parts for the KV chunk visiting at (o, t).  ``out`` and
    ``lse`` are the combined (global softmax) values, so each step's
    contribution is exact and linear."""
    kw = _kw(cfg)
    if not cfg.causal:
        return flash_bwd_chunk(q, kc, vc, out, lse, do, causal=False, **kw)
    j = _visiting(cfg, i_out, i_in, o, t)
    return flash_bwd_chunk(q, kc, vc, out, lse, do, causal=True,
                           window=cfg.window,
                           band=_step_band(cfg, i, j, q.shape[1]),
                           q_doc_start=doc, **kw)


def _ring_bwd(q, k, v, out, lse, do, doc, cfg: RingConfig):
    """The reference's schedule: dk/dv ride the inner ring with their
    chunk, and the last inner shift of each outer round (and the outer
    hop) brings them on, so after the whole ring every chunk's grads are
    home.  The next chunk's K/V shift is issued before the step's kernels."""
    i_out, i_in, i = _ring_indices(cfg)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k0, v0 = k, v
    dk0 = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv0 = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for o in range(cfg.n_out):
        kc, vc, dkc, dvc = k0, v0, dk0, dv0
        for t in range(cfg.w):
            last = (t == cfg.w - 1) and (o == cfg.n_out - 1)
            nxt_kv = None if last else shift((kc, vc), cfg.group_inner,
                                             cfg.rt, KV_TAG)
            dq_p, dk_p, dv_p = _step_bwd(q, kc, vc, out, lse, do, doc, o, t,
                                         i_out, i_in, i, cfg)
            dq += dq_p.float()
            dkc = dkc + dk_p.float()
            dvc = dvc + dv_p.float()
            dkc, dvc = shift((dkc, dvc), cfg.group_inner, cfg.rt,
                             DKV_TAG).wait()
            if nxt_kv is not None:
                kc, vc = nxt_kv.wait()
        # Outer hop: the visiting set, with its grads, moves on; after
        # n_out hops every chunk's grads are back at their owner.
        nxt_kv = None
        if o < cfg.n_out - 1:
            nxt_kv = shift((kc, vc), cfg.group_outer, cfg.rt, KV_TAG)
        dk0, dv0 = shift((dkc, dvc), cfg.group_outer, cfg.rt,
                         DKV_TAG).wait()
        if nxt_kv is not None:
            k0, v0 = nxt_kv.wait()
    return dq.to(q.dtype), dk0.to(k.dtype), dv0.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, doc, cfg: RingConfig):
        out, lse = _ring_fwd(q, k, v, doc, cfg)
        ctx.save_for_backward(q, k, v, out, lse, doc)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, doc = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do.contiguous(), doc,
                               ctx.cfg)
        return dq, dk, dv, None, None


def ring_attention(q, k, v, doc, cfg: RingConfig):
    """Double-ring zigzag attention over the local (post-AlltoAll) shards.

    q ``(b, S/cp, Hq/hp, d)``; k/v ``(b, S/cp, Hkv_eff/hp, d)``; doc None
    or the local ``(b, S/cp)`` int32 doc-start table (no gradient)."""
    return _RingAttention.apply(q, k, v, doc, cfg)


# ---------------------------------------------------------------------------
# SeqAlltoAll + public API
# ---------------------------------------------------------------------------

def _heads_to_seq(x, group, rt):
    """``(b, s, H, d)`` -> ``(b, hp * s, H / hp, d)``: split heads,
    concatenate sequence in head-rank order (the reference's
    ``all_to_all(x, axis, 2, 1, tiled=True)``)."""
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    blocks = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(blocks.contiguous(), group, rt)   # (n_src, b, s, h/n, d)
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _seq_to_heads(x, group, rt):
    """The inverse: ``(b, hp * s, H / hp, d)`` -> ``(b, s, H, d)``."""
    n = dist.get_world_size(group)
    b, sn, hh, d = x.shape
    blocks = x.reshape(b, n, sn // n, hh, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(blocks.contiguous(), group, rt)   # (n_src, b, s, h/n, d)
    return got.permute(1, 2, 0, 3, 4).reshape(b, sn // n, n * hh, d)


class _SeqAlltoAll(torch.autograd.Function):
    """The head all-to-all; its backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, rt, to_seq: bool):
        ctx.group, ctx.rt, ctx.to_seq = group, rt, to_seq
        return (_heads_to_seq if to_seq else _seq_to_heads)(x, group, rt)

    @staticmethod
    def backward(ctx, g):
        inv = _seq_to_heads if ctx.to_seq else _heads_to_seq
        return inv(g.contiguous(), ctx.group, ctx.rt), None, None, None


def attention_2d_local(q, k, v, cfg: Attn2DConfig, doc_start=None, rt=None):
    """Per-rank 2D-Attention.  q ``(b, S/d_sp, Hq, d)``; k/v ``(b, S/d_sp,
    Hkv, d)``.  Returns q-shaped out.  ``rt`` (a ``Runtime`` with a mesh)
    is needed when ``hp > 1`` or ``cp > 1``.

    ``doc_start``: the local ``(b, S/d_sp)`` int32 doc-start table.  The
    all-to-all moves heads, so the table is all-gathered over head along
    the sequence, after which it covers the ``S/d_cp`` rows of the
    post-AlltoAll q."""
    hkv, dh = k.shape[2], q.shape[3]
    scale = cfg.scale if cfg.scale is not None else 1.0 / (dh ** 0.5)
    if doc_start is not None and not cfg.causal:
        raise ValueError("packed documents require causal attention")
    if (cfg.hp > 1 or cfg.cp > 1) and (rt is None or rt.mesh is None):
        raise ValueError(f"2D-Attention with hp={cfg.hp}, cp={cfg.cp} needs "
                         "a Runtime with a mesh")

    if cfg.hp > hkv:
        # Paper §4.2: replicate KV heads to d_hp before the SeqAlltoAll.
        if cfg.hp % hkv:
            raise ValueError(f"hp {cfg.hp} is not a multiple of {hkv} KV "
                             "heads")
        k = k.repeat_interleave(cfg.hp // hkv, dim=2)
        v = v.repeat_interleave(cfg.hp // hkv, dim=2)

    if cfg.hp > 1:
        if q.shape[2] % cfg.hp:
            raise ValueError(f"{q.shape[2]} heads do not split over hp "
                             f"{cfg.hp}")
        g_hp = rt.group(cfg.axis_hp)
        q, k, v = (_SeqAlltoAll.apply(x, g_hp, rt, True) for x in (q, k, v))
        if doc_start is not None:
            doc_start = all_gather(doc_start.contiguous(), g_hp, rt, dim=1)

    if cfg.cp == 1:
        out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                              softcap=cfg.softcap, scale=scale,
                              q_doc_start=doc_start, impl=cfg.impl)
    else:
        rcfg = RingConfig(n_out=cfg.n_out, w=cfg.w, causal=cfg.causal,
                          zigzag=cfg.zigzag and cfg.causal,
                          window=cfg.window, softcap=cfg.softcap,
                          scale=scale, impl=cfg.impl,
                          group_outer=rt.group(cfg.axis_outer),
                          group_inner=rt.group(cfg.axis_inner), rt=rt)
        out = ring_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             doc_start, rcfg)

    if cfg.hp > 1:
        out = _SeqAlltoAll.apply(out, g_hp, rt, False)
    return out


def attention_2d(q, k, v, *, cfg: Attn2DConfig, doc_start=None, rt=None):
    """2D-Attention of this rank's shard: q ``(B/dp, S/d_sp, Hq, d)``, k/v
    ``(B/dp, S/d_sp, Hkv, d)`` in the zigzag physical layout (the data
    pipeline's contract), ``doc_start`` an optional ``(B/dp, S/d_sp)``
    int32 table.  On one device the shard is the whole tensor."""
    return attention_2d_local(q, k, v, cfg, doc_start=doc_start, rt=rt)
