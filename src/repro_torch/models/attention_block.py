"""GQA attention block (``gqa_apply``), Whisper cross-attention
(``cross_attn_apply``) and single-token decode attention (counterpart of
``src/repro/models/attention_block.py``).

Cross-attention reads the whole encoder output, which is far too short to
ring: on a mesh the decoder's queries take the Ulysses all-to-all over
``head``, the encoder's K/V are gathered over ``SEQ_AXES`` (each rank's
piece is a contiguous slice of the frames) and cut to this rank's heads,
one non-causal ``flash_attention`` call runs, and the inverse all-to-all
brings the output back.  The gather is ``core/runtime.py::gather_stack``,
whose backward is the reduce-scatter.

``decode_attention`` runs for one context rank: the flash-decoding combine
over context ranks (a pmax and a psum in the JAX package) is then the
identity, and it is kept as arithmetic so masked and zero rows come out
exactly as there.  MLA comes with ROADMAP queue 1, item 9.
"""
from __future__ import annotations

import dataclasses

import torch

import torch.distributed as dist

from repro_torch.core.attention2d import (Attn2DConfig, _SeqAlltoAll,
                                          attention_2d, attn2d_config)
from repro_torch.core.runtime import axes_groups, gather_stack
from repro_torch.core.topology import AXIS_HP, SEQ_AXES
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


def decode_attention(q, k_cache, v_cache, pos, rt, *, softcap: float = 0.0,
                     window: int | None = None, scale: float | None = None,
                     ring_full=None):
    """One-token attention against the KV cache of one context rank.

    q ``(B, 1, H, d)``; k/v cache ``(B, S_max, Hkv, d)``.  ``pos``: current
    length - 1, an int or a per-request ``(B,)`` tensor (``-1`` marks an
    inactive slot, which sees no keys and emits zeros).  ``ring_full``: for
    sliding-window ring caches, the number of live slots (every live slot
    is attendable, no causal band).  Runs on the ref path, as in the JAX
    package."""
    start = 0                       # this rank's first cache position
    if ring_full is not None:
        valid = _clip(ring_full - start, 0, k_cache.shape[1])
        out, lse = flash_fwd_chunk(q, k_cache, v_cache, causal=False,
                                   softcap=softcap, scale=scale,
                                   kv_valid_len=valid, impl="ref")
    else:
        out, lse = flash_fwd_chunk(q, k_cache, v_cache, causal=True,
                                   window=window, softcap=softcap,
                                   scale=scale, mask_offset=pos - start,
                                   impl="ref")
    # The lse-weighted combine over the (single) context rank.
    m = lse
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    wgt = torch.exp(lse - m_safe)
    wgt = torch.where(lse <= NEG_INF / 2, 0.0, wgt)
    w_o = wgt.permute(0, 2, 1)[..., None]               # (b, 1, h, 1)
    num = out.float() * w_o
    den = torch.where(wgt == 0.0, 1.0, wgt)
    return (num / den.permute(0, 2, 1)[..., None]).to(q.dtype)


def _clip(x, lo: int, hi: int):
    if isinstance(x, torch.Tensor):
        return x.clamp(lo, hi)
    return max(lo, min(int(x), hi))
