"""GQA attention block (``gqa_apply``), DeepSeek-V2 MLA (``mla_apply``),
Whisper cross-attention (``cross_attn_apply``) and single-token decode
attention (counterpart of ``src/repro/models/attention_block.py``).

MLA compresses K/V into a latent: ``kv_down`` gives ``kv_lora`` latent
columns (normed by ``kv_norm``) and ``d_rope`` columns of one shared rope
key head; ``kv_up`` expands the latent into every head's ``k_nope`` and
``v``.  Q and K are ``d_qk = d_nope + d_rope`` wide and V ``d_v`` wide, so
V is zero-padded to ``d_qk`` for the kernels and their output cut back to
``d_v``; the scale is ``1/sqrt(d_qk)``.  Training and prefill run the
up-projected heads through 2D-Attention; decode runs absorbed
(``models/decode.py``).

Cross-attention reads the whole encoder output, which is far too short to
ring: on a mesh the decoder's queries take the Ulysses all-to-all over
``head``, the encoder's K/V are gathered over ``SEQ_AXES`` (each rank's
piece is a contiguous slice of the frames) and cut to this rank's heads,
one non-causal ``flash_attention`` call runs, and the inverse all-to-all
brings the output back.  The gather is ``core/runtime.py::gather_stack``,
whose backward is the reduce-scatter.

``decode_attention`` is flash-decoding on the 2D grid: each context rank
attends its shard of the cache (positions ``[r L, (r + 1) L)`` of the
global extent, ``r = outer * cp_inner + inner``) with this rank's query
heads, and one all-reduce-max of the lse and one all-reduce-sum of the
weighted outputs and weights over ``(outer, inner)`` combine the partials
(the reference's pmax and psum).  On one rank the combine is the identity,
kept as arithmetic so masked and zero rows come out exactly as there.
"""
from __future__ import annotations

import dataclasses

import torch

import torch.distributed as dist

from repro_torch.core.attention2d import (Attn2DConfig, _SeqAlltoAll,
                                          attention_2d, attn2d_config)
from repro_torch.core.runtime import all_reduce_, axes_groups, gather_stack
from repro_torch.core.topology import (AXIS_HP, AXIS_INNER, AXIS_OUTER,
                                       SEQ_AXES)
from repro_torch.kernels.ops import flash_attention, flash_fwd_chunk
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (apply_rotary, init_linear,
                                       init_rmsnorm, linear_apply,
                                       rmsnorm_apply)


@dataclasses.dataclass(frozen=True)
class AttnKind:
    """Per-layer attention behaviour."""
    causal: bool = True
    window: int | None = None     # sliding-window (local) layers
    softcap: float = 0.0
    rope: bool = True
    rope_theta: float = 10000.0


def make_2d_cfg(rt, kind: AttnKind, *, zigzag: bool,
                scale: float | None = None) -> Attn2DConfig:
    return attn2d_config(rt.pc, impl=rt.impl, causal=kind.causal,
                         zigzag=zigzag, window=kind.window,
                         softcap=kind.softcap, scale=scale)


def init_gqa(gen: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int, head_dim: int, *, qk_norm: bool = False,
             bias: bool = False, device=None):
    p = {"wq": init_linear(gen, d_model, n_heads * head_dim, bias=bias,
                           device=device),
         "wk": init_linear(gen, d_model, n_kv_heads * head_dim, bias=bias,
                           device=device),
         "wv": init_linear(gen, d_model, n_kv_heads * head_dim, bias=bias,
                           device=device),
         "wo": init_linear(gen, n_heads * head_dim, d_model, device=device)}
    if qk_norm:
        p["qn"] = init_rmsnorm(head_dim, device=device)
        p["kn"] = init_rmsnorm(head_dim, device=device)
    return p


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim, cos, sin,
                 kind: AttnKind, *, qk_norm: bool):
    b, s, _ = x.shape
    q = linear_apply(p["wq"], x).reshape(b, s, n_heads, head_dim)
    k = linear_apply(p["wk"], x).reshape(b, s, n_kv_heads, head_dim)
    v = linear_apply(p["wv"], x).reshape(b, s, n_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm_apply(p["qn"], q)
        k = rmsnorm_apply(p["kn"], k)
    if kind.rope:
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    return q, k, v


def gqa_attend(q, k, v, rt, kind: AttnKind, *, zigzag: bool = True,
               scale: float | None = None, doc_start=None):
    """2D-Attention of projected q ``(B, S, Hq, d)`` and k/v
    ``(B, S, Hkv, d)``; returns ``(B, S, Hq * d)``.  This is the tensor the
    reference names ``attn_out`` for Selective Checkpoint++."""
    b, s, h, d = q.shape
    cfg = make_2d_cfg(rt, kind, zigzag=zigzag, scale=scale)
    return attention_2d(q, k, v, cfg=cfg, doc_start=doc_start,
                        rt=rt).reshape(b, s, h * d)


def gqa_apply(p, x, cos, sin, rt, kind: AttnKind, *, n_heads: int,
              n_kv_heads: int, head_dim: int, qk_norm: bool = False,
              zigzag: bool = True, scale: float | None = None,
              doc_start=None):
    """x ``(B, S, D)`` -> ``(B, S, D)``; cos/sin ``(B, S, head_dim/2)``.
    Under Selective Checkpoint++ the block splits this call around
    ``gqa_attend`` (``models/model.py::apply_transformer_block``)."""
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, cos, sin,
                           kind, qk_norm=qk_norm)
    out = gqa_attend(q, k, v, rt, kind, zigzag=zigzag, scale=scale,
                     doc_start=doc_start)
    return linear_apply(p["wo"], out)


@dataclasses.dataclass(frozen=True)
class MLADims:
    n_heads: int = 16
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128

    @property
    def d_qk(self) -> int:
        return self.d_nope + self.d_rope


def init_mla(gen: torch.Generator, d_model: int, m: MLADims, *,
             device=None):
    """``wq``, ``kv_down``, ``kv_norm`` (zero, as every RMSNorm), ``kv_up``
    and ``wo``, unbiased, in the reference's order."""
    return {
        "wq": init_linear(gen, d_model, m.n_heads * m.d_qk, device=device),
        "kv_down": init_linear(gen, d_model, m.kv_lora + m.d_rope,
                               device=device),
        "kv_norm": init_rmsnorm(m.kv_lora, device=device),
        "kv_up": init_linear(gen, m.kv_lora, m.n_heads * (m.d_nope + m.d_v),
                             device=device),
        "wo": init_linear(gen, m.n_heads * m.d_v, d_model, device=device)}


def mla_latent(p, x, cos, sin, m: MLADims):
    """The latent ``c`` ``(B, S, kv_lora)`` (``kv_norm`` applied) and the
    roped shared key head ``k_rope`` ``(B, S, 1, d_rope)``: what the
    decode cache keeps a position."""
    ckv = linear_apply(p["kv_down"], x)
    c = rmsnorm_apply(p["kv_norm"], ckv[..., :m.kv_lora])
    return c, apply_rotary(ckv[..., None, m.kv_lora:], cos, sin)


def mla_project(p, x, cos, sin, m: MLADims):
    """q, k ``(B, S, H, d_qk)`` (rotary on the rope parts only, the shared
    rope key broadcast to every head) and v ``(B, S, H, d_qk)``, zero-padded
    from ``d_v``; and ``(c, k_rope)`` of ``mla_latent``.  cos/sin are built
    for ``d_rope``."""
    b, s, _ = x.shape
    q = linear_apply(p["wq"], x).reshape(b, s, m.n_heads, m.d_qk)
    q = torch.cat([q[..., :m.d_nope],
                   apply_rotary(q[..., m.d_nope:], cos, sin)], dim=-1)
    c, k_rope = mla_latent(p, x, cos, sin, m)
    kv = linear_apply(p["kv_up"], c).reshape(b, s, m.n_heads,
                                             m.d_nope + m.d_v)
    k = torch.cat([kv[..., :m.d_nope],
                   k_rope.expand(b, s, m.n_heads, m.d_rope)], dim=-1)
    v = torch.nn.functional.pad(kv[..., m.d_nope:], (0, m.d_qk - m.d_v))
    return q, k, v, (c, k_rope)


def mla_attend(q, k, v, rt, kind: AttnKind, m: MLADims, *,
               zigzag: bool = True, doc_start=None):
    """2D-Attention of ``mla_project``'s q, k and padded v at scale
    ``1/sqrt(d_qk)``, the output cut to ``d_v``: ``(B, S, H * d_v)``, the
    tensor the reference names ``attn_out``."""
    b, s = q.shape[:2]
    cfg = make_2d_cfg(rt, kind, zigzag=zigzag, scale=1.0 / m.d_qk ** 0.5)
    out = attention_2d(q, k, v, cfg=cfg, doc_start=doc_start, rt=rt)
    return out[..., :m.d_v].reshape(b, s, m.n_heads * m.d_v)


def mla_apply(p, x, cos, sin, rt, kind: AttnKind, m: MLADims, *,
              zigzag: bool = True, doc_start=None):
    """The training path: up-project the latent, run 2D-Attention on the
    ``d_qk``-wide heads.  x ``(B, S, D)`` -> ``(B, S, D)``.  Under Selective
    Checkpoint++ the block splits this call around ``mla_attend``."""
    q, k, v, _ = mla_project(p, x, cos, sin, m)
    out = mla_attend(q, k, v, rt, kind, m, zigzag=zigzag,
                     doc_start=doc_start)
    return linear_apply(p["wo"], out)


def init_cross_attn(gen: torch.Generator, d_model: int, n_heads: int,
                    head_dim: int, *, device=None):
    """``wq`` and ``wv`` biased, ``wk`` and ``wo`` not, as in the JAX
    package."""
    inner = n_heads * head_dim
    return {"wq": init_linear(gen, d_model, inner, bias=True, device=device),
            "wk": init_linear(gen, d_model, inner, device=device),
            "wv": init_linear(gen, d_model, inner, bias=True, device=device),
            "wo": init_linear(gen, inner, d_model, device=device)}


def project_cross(p, x, enc, *, n_heads: int, head_dim: int):
    """q ``(B, S, H, d)`` from the decoder's ``x``; k, v ``(B, S_enc, H,
    d)`` from this rank's piece of the encoder output ``enc``."""
    b, s, _ = x.shape
    se = enc.shape[1]
    q = linear_apply(p["wq"], x).reshape(b, s, n_heads, head_dim)
    k = linear_apply(p["wk"], enc).reshape(b, se, n_heads, head_dim)
    v = linear_apply(p["wv"], enc).reshape(b, se, n_heads, head_dim)
    return q, k, v


def cross_attend(q, k, v, rt):
    """Non-causal attention of this rank's queries ``(B, S, H, d)`` over
    the whole encoder sequence, of which k / v ``(B, S_enc, H, d)`` are
    this rank's piece; returns ``(B, S, H * d)``, the tensor the reference
    names ``attn_out``."""
    b, s, h, d = q.shape
    hp = rt.pc.hp
    if rt.mesh is not None:
        if hp > 1:
            g_hp = rt.group(AXIS_HP)
            q = _SeqAlltoAll.apply(q.contiguous(), g_hp, rt, True)
        ag = axes_groups(rt, [SEQ_AXES])[SEQ_AXES]
        k, v = (gather_stack(x, ag, rt).transpose(0, 1).flatten(1, 2)
                for x in (k, v))
        if hp > 1:
            h_loc = h // hp
            h0 = dist.get_rank(g_hp) * h_loc
            k, v = k[:, :, h0:h0 + h_loc], v[:, :, h0:h0 + h_loc]
    out = flash_attention(q, k.contiguous(), v.contiguous(), causal=False,
                          impl=rt.impl)
    if rt.mesh is not None and hp > 1:
        out = _SeqAlltoAll.apply(out.contiguous(), g_hp, rt, False)
    return out.reshape(b, s, h * d)


def cross_attn_apply(p, x, enc, rt, *, n_heads: int, head_dim: int):
    """x: the decoder's ``(B, S, D)``; enc: this rank's piece of the
    encoder output ``(B, S_enc, D)``.  Under Selective Checkpoint++ the
    decoder block splits this call around ``cross_attend``."""
    q, k, v = project_cross(p, x, enc, n_heads=n_heads, head_dim=head_dim)
    return linear_apply(p["wo"], cross_attend(q, k, v, rt))


#: The context axes: a decode cache's S is split over them, in this order.
CP_AXES = (AXIS_OUTER, AXIS_INNER)


def context_index(rt) -> int:
    """This rank's context index ``outer * cp_inner + inner`` (0 on one
    device): which block of a context-sharded cache it holds."""
    if rt.mesh is None:
        return 0
    return rt.coord.outer * rt.pc.cp_inner + rt.coord.inner


def context_group(rt):
    """This rank's ``AxesGroup`` over ``CP_AXES``, or None where there is
    one context rank.  Collective the first time (``axes_groups``)."""
    if rt.mesh is None or rt.pc.cp == 1:
        return None
    return axes_groups(rt, [CP_AXES])[CP_AXES]


def _replicated_heads(k_cache, v_cache, h_loc: int, rt):
    """The heads of a cache replicated over ``head`` (every rank holds all
    ``Hkv``) that this rank's ``h_loc`` query heads map to under GQA: head
    rank ``i`` holds query heads ``[i h_loc, (i + 1) h_loc)``."""
    hp = rt.pc.hp if rt.mesh is not None else 1
    if hp == 1:
        return k_cache, v_cache
    hkv = k_cache.shape[2]
    group = h_loc * hp // hkv
    q0 = rt.coord.head * h_loc
    lo, hi = q0 // group, (q0 + h_loc - 1) // group + 1
    return k_cache[:, :, lo:hi], v_cache[:, :, lo:hi]


def decode_attention(q, k_cache, v_cache, pos, rt, *, softcap: float = 0.0,
                     window: int | None = None, scale: float | None = None,
                     ring_full=None, kv_replicated: bool = False):
    """One-token attention of this rank's query heads against its shard
    of a context-sharded KV cache.

    q ``(B, 1, H / hp, d)``: this rank's heads.  k/v cache ``(B, S_max /
    cp, Hkv_loc, d)``: positions ``[r S_max / cp, (r + 1) S_max / cp)`` of
    the global cache, ``r = context_index(rt)``; its heads are this rank's
    KV heads (split over ``head``), or, with ``kv_replicated``, every head
    (the MLA latent, one logical head, is not split), of which this rank's
    query heads attend those their GQA group maps to.  ``pos``: current
    length - 1, an int or a per-request ``(B,)`` tensor (``-1`` marks an
    inactive slot, which sees no keys and emits zeros).  ``ring_full``: for
    sliding-window ring caches, the number of live slots of the global
    ring (every live slot is attendable, no causal band).  Runs on the ref
    path, as in the JAX package.  Returns ``(B, 1, H / hp, d)``."""
    if kv_replicated:
        k_cache, v_cache = _replicated_heads(k_cache, v_cache, q.shape[2],
                                             rt)
    shard_len = k_cache.shape[1]
    start = context_index(rt) * shard_len   # this rank's first position
    if ring_full is not None:
        valid = _clip(ring_full - start, 0, shard_len)
        out, lse = flash_fwd_chunk(q, k_cache, v_cache, causal=False,
                                   softcap=softcap, scale=scale,
                                   kv_valid_len=valid, impl="ref")
    else:
        out, lse = flash_fwd_chunk(q, k_cache, v_cache, causal=True,
                                   window=window, softcap=softcap,
                                   scale=scale, mask_offset=pos - start,
                                   impl="ref")
    # The lse-weighted combine over the context ranks: one max, one sum.
    grp = context_group(rt)
    m = lse
    if grp is not None:
        m = all_reduce_(lse.clone(), rt, grp.group, op=dist.ReduceOp.MAX)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    wgt = torch.exp(lse - m_safe)
    wgt = torch.where(lse <= NEG_INF / 2, 0.0, wgt)
    w_o = wgt.permute(0, 2, 1)[..., None]               # (b, 1, h, 1)
    num = out.float() * w_o
    den = wgt
    if grp is not None:
        both = all_reduce_(torch.cat([num.reshape(-1), den.reshape(-1)]),
                           rt, grp.group)
        num = both[:num.numel()].view(num.shape)
        den = both[num.numel():].view(den.shape)
    den = torch.where(den == 0.0, 1.0, den)
    return (num / den.permute(0, 2, 1)[..., None]).to(q.dtype)


def _clip(x, lo: int, hi: int):
    if isinstance(x, torch.Tensor):
        return x.clamp(lo, hi)
    return max(lo, min(int(x), hi))
