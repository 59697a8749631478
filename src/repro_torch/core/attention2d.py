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

from repro_torch.core.runtime import Arrived, all_gather, all_to_all, shift
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
    i_out = dist.get_rank(cfg.group_outer) if cfg.n_out > 1 else 0
    i_in = dist.get_rank(cfg.group_inner) if cfg.w > 1 else 0
    return i_out, i_in, i_out * cfg.w + i_in


def _shift(tensors, group, n: int, rt, tag: int) -> Arrived:
    """``shift`` over a ring of ``n``; a ring of one (no process group,
    as the chunk pipeline's on one process) hands the tensors back."""
    if n == 1:
        return Arrived([], list(tensors), None, None)
    return shift(tensors, group, rt, tag)


def _visiting(cfg: RingConfig, i_out: int, i_in: int, o: int, t: int):
    """Global cp index of the KV chunk visiting this rank at step (o, t)."""
    j_out = (i_out - o) % cfg.n_out
    j_in = (i_in - t) % cfg.w
    return j_out * cfg.w + j_in


def _kw(cfg: RingConfig):
    return dict(softcap=cfg.softcap, scale=cfg.scale, impl=cfg.impl)


def _step_band(cfg: RingConfig, i: int, j: int, s_loc: int, qb: int = 0,
               kb: int = 0) -> BandMask:
    """The (i, j) ring step's mask as a ``BandMask`` over the local
    shapes: the kernels take its ints as launch scalars.  ``qb`` / ``kb``
    are the global sequence-chunk bases of the chunk pipeline (each side's
    logical positions shift by its chunk's start); the resident path
    passes 0 / 0."""
    if cfg.zigzag:
        band = BandMask.zigzag(i, j, s_loc // 2, cfg.cp)
    else:
        # Contiguous chunks: chunk r is cp rank r.  Absolute offsets on
        # both sides keep doc-start comparisons (global positions) right.
        band = BandMask(i * s_loc, i * s_loc, j * s_loc, j * s_loc, 0, 0)
    if qb == 0 and kb == 0:
        return band
    return band._replace(q_off_lo=band.q_off_lo + qb,
                         q_off_hi=band.q_off_hi + qb,
                         k_off_lo=band.k_off_lo + kb,
                         k_off_hi=band.k_off_hi + kb)


# ---------------------------------------------------------------------------
# Ring forward
# ---------------------------------------------------------------------------

def _step_fwd(q, kc, vc, doc, o: int, t: int, i_out, i_in, i,
              cfg: RingConfig, qb: int = 0, kb: int = 0):
    """Partial (out, lse) of local q against the visiting KV chunk.  The
    doc-start table is q-side data: it stays while KV rotates."""
    kw = _kw(cfg)
    if not cfg.causal:
        return flash_fwd_chunk(q, kc, vc, causal=False, **kw)
    j = _visiting(cfg, i_out, i_in, o, t)
    return flash_fwd_chunk(q, kc, vc, causal=True, window=cfg.window,
                           band=_step_band(cfg, i, j, q.shape[1], qb, kb),
                           q_doc_start=doc, **kw)


def _ring_fwd(q, k, v, doc, cfg: RingConfig, qb: int = 0, kb: int = 0):
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
            po, pl = _step_fwd(q, kc, vc, doc, o, t, i_out, i_in, i, cfg,
                               qb, kb)
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
              cfg: RingConfig, qb: int = 0, kb: int = 0):
    """(dq, dk, dv) parts for the KV chunk visiting at (o, t).  ``out`` and
    ``lse`` are the combined (global softmax) values, so each step's
    contribution is exact and linear."""
    kw = _kw(cfg)
    if not cfg.causal:
        return flash_bwd_chunk(q, kc, vc, out, lse, do, causal=False, **kw)
    j = _visiting(cfg, i_out, i_in, o, t)
    return flash_bwd_chunk(q, kc, vc, out, lse, do, causal=True,
                           window=cfg.window,
                           band=_step_band(cfg, i, j, q.shape[1], qb, kb),
                           q_doc_start=doc, **kw)


def _ring_bwd(q, k, v, out, lse, do, doc, cfg: RingConfig, qb: int = 0,
              kb: int = 0):
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
            nxt_kv = None if last else _shift((kc, vc), cfg.group_inner,
                                              cfg.w, cfg.rt, KV_TAG)
            dq_p, dk_p, dv_p = _step_bwd(q, kc, vc, out, lse, do, doc, o, t,
                                         i_out, i_in, i, cfg, qb, kb)
            dq += dq_p.float()
            dkc = dkc + dk_p.float()
            dvc = dvc + dv_p.float()
            dkc, dvc = _shift((dkc, dvc), cfg.group_inner, cfg.w, cfg.rt,
                              DKV_TAG).wait()
            if nxt_kv is not None:
                kc, vc = nxt_kv.wait()
        # Outer hop: the visiting set, with its grads, moves on; after
        # n_out hops every chunk's grads are back at their owner.
        nxt_kv = None
        if o < cfg.n_out - 1:
            nxt_kv = _shift((kc, vc), cfg.group_outer, cfg.n_out, cfg.rt,
                            KV_TAG)
        dk0, dv0 = _shift((dkc, dvc), cfg.group_outer, cfg.n_out, cfg.rt,
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


# ---------------------------------------------------------------------------
# Sequence-chunk pipelining with host KV offload (FPDT, arxiv 2408.16978)
# ---------------------------------------------------------------------------
#
# The resident path above keeps the whole local sequence on the device.
# The chunk pipeline splits the global sequence into C chunks, keeps only
# the active (and prefetched) chunks on the device through an
# ``OffloadManager``, and runs the same Ulysses + double-ring machinery
# once per causal chunk pair (i, j <= i).  The pair kernels are the
# resident ones: each side's ``BandMask`` logical positions shift by its
# chunk base (qb = i * Sc, kb = j * Sc), so zigzag, doc starts (global
# positions, boundaries across chunk edges included), GQA folding and the
# tile skip stay as they are.  The forward combines a chunk's pair
# partials with the flash rule; the backward keeps dq on the device and
# sends dk / dv home to host fp32 accumulators a chunk at a time.  Host
# staging is outside autograd, so the driver is an explicit forward and
# a manual ``vjp``.
#
# What a rank passes in and gets back: for every chunk, this rank's piece
# of that chunk in the chunk's own zigzag layout (``seq_slice`` of the
# zigzag-laid chunk), the chunks' pieces concatenated along the sequence
# in chunk order.  ``to_chunk_layout`` / ``from_chunk_layout`` go there
# from logical order and back.

def to_chunk_layout(x, chunks: int, pc, coord=None, zigzag: bool = True):
    """This rank's input to ``ChunkedAttention`` from ``x`` ``(B, S,
    ...)`` in logical order: each of the ``chunks`` chunks laid out in
    zigzag over ``pc.cp``, then this rank's ``seq_slice`` of it."""
    from repro_torch.core.topology import MeshCoord, seq_slice
    from repro_torch.core.zigzag import to_zigzag
    coord = coord or MeshCoord()
    sc = x.shape[1] // chunks
    parts = []
    for i in range(chunks):
        c = x[:, i * sc:(i + 1) * sc]
        c = to_zigzag(c, pc.cp) if zigzag else c
        parts.append(c[:, seq_slice(pc, coord, sc)])
    return torch.cat(parts, dim=1)


def from_chunk_layout(pieces, chunks: int, pc, zigzag: bool = True):
    """The inverse over the sequence ranks: ``pieces`` is ``(coord,
    tensor)`` for each of the ``pc.sp`` ranks of one batch shard; returns
    the whole sequence in logical order."""
    from repro_torch.core.topology import seq_slice
    from repro_torch.core.zigzag import from_zigzag
    first = pieces[0][1]
    loc = first.shape[1] // chunks
    sc = loc * pc.sp
    out = []
    for i in range(chunks):
        c = first.new_empty((first.shape[0], sc) + tuple(first.shape[2:]))
        for coord, x in pieces:
            c[:, seq_slice(pc, coord, sc)] = x[:, i * loc:(i + 1) * loc]
        out.append(from_zigzag(c, pc.cp) if zigzag else c)
    return torch.cat(out, dim=1)


def _chunk_ring_cfg(cfg: Attn2DConfig, dh: int, rt) -> RingConfig:
    scale = cfg.scale if cfg.scale is not None else 1.0 / (dh ** 0.5)
    return RingConfig(
        n_out=cfg.n_out, w=cfg.w, causal=True, zigzag=cfg.zigzag,
        window=None, softcap=cfg.softcap, scale=scale, impl=cfg.impl,
        group_outer=rt.group(cfg.axis_outer) if cfg.n_out > 1 else None,
        group_inner=rt.group(cfg.axis_inner) if cfg.w > 1 else None, rt=rt)


def _lse_to_seq(lse, group, rt):
    """lse ``(b, H, s)`` -> ``(b, H / hp, hp * s)``: the head all-to-all
    of an ``(b, s, H)`` tensor."""
    x = _heads_to_seq(lse.transpose(1, 2).unsqueeze(-1).contiguous(),
                      group, rt)
    return x.squeeze(-1).transpose(1, 2).contiguous()


def _lse_to_heads(lse, group, rt):
    """The inverse of ``_lse_to_seq``."""
    x = _seq_to_heads(lse.transpose(1, 2).unsqueeze(-1).contiguous(),
                      group, rt)
    return x.squeeze(-1).transpose(1, 2).contiguous()


def _chunk_pair_fwd_local(q, k, v, doc, qb: int, kb: int,
                          cfg: Attn2DConfig, rt):
    """This rank's ``(out, lse)`` of q-chunk (base ``qb``) against
    kv-chunk (base ``kb``): one forward kernel call a ring step."""
    hkv = k.shape[2]
    rcfg = _chunk_ring_cfg(cfg, q.shape[-1], rt)
    if cfg.hp > hkv:
        k = k.repeat_interleave(cfg.hp // hkv, dim=2)
        v = v.repeat_interleave(cfg.hp // hkv, dim=2)
    if cfg.hp > 1:
        g_hp = rt.group(cfg.axis_hp)
        q, k, v = (_heads_to_seq(x.contiguous(), g_hp, rt)
                   for x in (q, k, v))
        if doc is not None:
            doc = all_gather(doc.contiguous(), g_hp, rt, dim=1)
    out, lse = _ring_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                         doc, rcfg, qb, kb)
    if cfg.hp > 1:
        out = _seq_to_heads(out.contiguous(), g_hp, rt)
        lse = _lse_to_heads(lse, g_hp, rt)
    return out, lse


def _chunk_pair_bwd_local(q, k, v, out, lse, do, doc, qb: int, kb: int,
                          cfg: Attn2DConfig, rt):
    """This rank's ``(dq, dk, dv)`` part of one chunk pair: one dq and one
    dk/dv kernel call a ring step.  ``out`` / ``lse`` are the chunk's
    final combined values, so each pair's part is exact and linear."""
    hkv = k.shape[2]
    rcfg = _chunk_ring_cfg(cfg, q.shape[-1], rt)
    rep = cfg.hp // hkv if cfg.hp > hkv else 1
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if cfg.hp > 1:
        g_hp = rt.group(cfg.axis_hp)
        q, k, v, out, do = (_heads_to_seq(x.contiguous(), g_hp, rt)
                            for x in (q, k, v, out, do))
        lse = _lse_to_seq(lse, g_hp, rt)
        if doc is not None:
            doc = all_gather(doc.contiguous(), g_hp, rt, dim=1)
    dq, dk, dv = _ring_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           out.contiguous(), lse, do.contiguous(), doc, rcfg,
                           qb, kb)
    if cfg.hp > 1:
        dq, dk, dv = (_seq_to_heads(x.contiguous(), g_hp, rt)
                      for x in (dq, dk, dv))
    if rep > 1:
        # repeat_interleave is consecutive: sum each head's replicas
        b, s, _, d = dk.shape
        dk = dk.float().reshape(b, s, hkv, rep, d).sum(3)
        dv = dv.float().reshape(b, s, hkv, rep, d).sum(3)
    return dq, dk, dv


class ChunkedAttention:
    """FPDT sequence-chunk pipelined 2D-Attention with host KV offload.

    Inputs and outputs are this rank's pieces of every chunk, in the
    chunks' own zigzag layout (``to_chunk_layout``); on one process the
    whole sequence in logical order.  Causal, without a window (a window
    already bounds the KV footprint).  ``rt`` (a ``Runtime`` with a mesh)
    is needed when ``hp > 1`` or ``cp > 1``.

    The manager's budget covers the staged chunks.  With the
    double-buffer schedule the peak is the active pair plus the
    prefetched next K/V: q + 2 (k + v) chunk pieces on the forward, and
    out, lse and dout beside them on the backward.

        ca = ChunkedAttention(cfg, chunks=8, rt=rt)
        out = ca.forward(q, k, v)
        dq, dk, dv = ca.vjp(d_out)
    """

    def __init__(self, cfg: Attn2DConfig, *, chunks: int, rt=None,
                 offload=None):
        if not cfg.causal:
            raise ValueError("chunk pipelining is causal only")
        if cfg.window is not None:
            raise ValueError("a sliding window already bounds the KV; the "
                             "chunk pipeline takes none")
        if chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        if (cfg.hp > 1 or cfg.cp > 1) and (rt is None or rt.mesh is None):
            raise ValueError(f"hp={cfg.hp}, cp={cfg.cp} needs a Runtime "
                             "with a mesh")
        if offload is None:
            from repro_torch.runtime.offload import OffloadManager
            offload = OffloadManager()
        self.cfg, self.chunks, self.rt, self.mgr = cfg, chunks, rt, offload
        self._docs = None
        self._loc = None      # this rank's rows of one chunk
        self._sc = None       # one chunk's global length
        self._dtypes = None

    def _stage(self, name: str, x):
        loc = self._loc
        for i in range(self.chunks):
            self.mgr.put((name, i), x[:, i * loc:(i + 1) * loc])

    def forward(self, q, k, v, doc_start=None):
        C, cfg = self.chunks, self.cfg
        if q.shape[1] % C:
            raise ValueError(f"{q.shape[1]} rows do not split into {C} "
                             "chunks")
        self._loc = q.shape[1] // C
        self._sc = self._loc * cfg.hp * cfg.cp
        if cfg.zigzag and cfg.cp > 1 and self._sc % (2 * cfg.cp):
            raise ValueError(f"chunk length {self._sc} does not split into "
                             f"2 * cp = {2 * cfg.cp} zigzag pieces")
        self._dtypes = (q.dtype, k.dtype, v.dtype)
        for name, x in (("q", q), ("k", k), ("v", v)):
            self._stage(name, x)
        self._docs = None
        if doc_start is not None:
            d = torch.as_tensor(doc_start, dtype=torch.int32,
                                device=q.device)
            self._docs = [d[:, i * self._loc:(i + 1) * self._loc]
                          .contiguous() for i in range(C)]
        mgr, outs = self.mgr, []
        for i in range(C):
            mgr.prefetch(("q", i))
            qi = mgr.get(("q", i))
            di = None if self._docs is None else self._docs[i]
            mgr.prefetch(("k", 0))
            mgr.prefetch(("v", 0))
            acc_o = acc_l = None
            for j in range(i + 1):
                if j < i:   # double buffer: the next fetch overlaps this pair
                    mgr.prefetch(("k", j + 1))
                    mgr.prefetch(("v", j + 1))
                kj, vj = mgr.get(("k", j)), mgr.get(("v", j))
                po, pl = _chunk_pair_fwd_local(qi, kj, vj, di, i * self._sc,
                                               j * self._sc, cfg, self.rt)
                if acc_o is None:
                    acc_o, acc_l = po.float(), pl
                else:
                    acc_o, acc_l = combine_pair(acc_o, acc_l, po, pl)
                mgr.release(("k", j))
                mgr.release(("v", j))
            out_i = acc_o.to(q.dtype)
            mgr.put(("o", i), out_i)        # the vjp's saved residuals
            mgr.put(("l", i), acc_l)
            mgr.release(("q", i))
            outs.append(out_i)
        return torch.cat(outs, dim=1)

    def vjp(self, do):
        """``(dq, dk, dv)`` in the inputs' layout, given the output's
        cotangent."""
        if self._sc is None:
            raise RuntimeError("ChunkedAttention.vjp before forward")
        C, cfg, mgr = self.chunks, self.cfg, self.mgr
        qdt, kdt, vdt = self._dtypes
        self._stage("g", do)
        for j in range(C):
            mgr.discard(("dk", j))
            mgr.discard(("dv", j))
        dqs = []
        for i in range(C):
            for key in (("q", i), ("g", i), ("o", i), ("l", i)):
                mgr.prefetch(key)
            qi, gi = mgr.get(("q", i)), mgr.get(("g", i))
            oi, li = mgr.get(("o", i)), mgr.get(("l", i))
            di = None if self._docs is None else self._docs[i]
            mgr.prefetch(("k", 0))
            mgr.prefetch(("v", 0))
            dq_i = None
            for j in range(i + 1):
                if j < i:
                    mgr.prefetch(("k", j + 1))
                    mgr.prefetch(("v", j + 1))
                kj, vj = mgr.get(("k", j)), mgr.get(("v", j))
                dq_p, dk_p, dv_p = _chunk_pair_bwd_local(
                    qi, kj, vj, oi, li, gi, di, i * self._sc, j * self._sc,
                    cfg, self.rt)
                dq_i = dq_p.float() if dq_i is None else dq_i + dq_p
                # dk / dv come home a chunk at a time: host fp32 sums
                mgr.accumulate(("dk", j), dk_p)
                mgr.accumulate(("dv", j), dv_p)
                mgr.release(("k", j))
                mgr.release(("v", j))
            dqs.append(dq_i.to(qdt))
            for key in (("q", i), ("g", i), ("o", i), ("l", i)):
                mgr.release(key)
        dev = do.device
        dk = torch.cat([mgr.host_array(("dk", j)) for j in range(C)], dim=1)
        dv = torch.cat([mgr.host_array(("dv", j)) for j in range(C)], dim=1)
        return (torch.cat(dqs, dim=1), dk.to(dev, kdt), dv.to(dev, vdt))


def chunked_attention_2d(q, k, v, *, cfg: Attn2DConfig, chunks: int,
                         doc_start=None, offload=None, rt=None):
    """The chunk pipeline's entry point: ``(out, vjp_fn)`` with
    ``vjp_fn(d_out) -> (dq, dk, dv)``, all in the inputs' layout (this
    rank's pieces of each chunk, ``to_chunk_layout``).  ``offload`` (an
    ``OffloadManager``) carries the residency budget and the telemetry; a
    fresh unbounded manager is used when omitted."""
    ca = ChunkedAttention(cfg, chunks=chunks, rt=rt, offload=offload)
    return ca.forward(q, k, v, doc_start=doc_start), ca.vjp
