"""GQA attention block pieces and single-token decode attention
(counterpart of ``src/repro/models/attention_block.py``).

``decode_attention`` runs for one context rank: the flash-decoding combine
over context ranks (a pmax and a psum in the JAX package) is then the
identity, and it is kept as arithmetic so masked and zero rows come out
exactly as there.  MLA and cross-attention come with ROADMAP queue 1,
item 9.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.attention2d import Attn2DConfig, attn2d_config
from repro_torch.kernels.ops import flash_fwd_chunk
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
