"""Serving for the dense GQA family: caches, prefill and single-token
decode (counterpart of ``src/repro/models/decode.py``).

* Prefill runs every layer's attention through 2D-Attention, which on one
  rank is one ``flash_attention`` call: the CUDA forward kernel on the card.
* Decode attention runs on the ref path (``decode_attention``), as the JAX
  package pins it.
* Sliding-window layers keep ring-buffer caches of size ``window``.

Caches keep the JAX package's structure, ``{"blocks": [{"k", "v"}]}`` with
one entry per period slot and a leading group axis, so the tests compare
them leaf for leaf.  ``decode_step`` writes the new token into the
pre-sized cache in place (the JAX package returns an updated copy).
Paged caches and ``prefill_chunk`` come with ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention_block import (AttnKind, _project_qkv,
                                                decode_attention,
                                                make_2d_cfg)
from repro_torch.core.attention2d import attention_2d
from repro_torch.models.layers import (apply_rotary, glu_mlp_apply,
                                       linear_apply, rmsnorm_apply)
from repro_torch.models.model import (ModelConfig, _require_dense,
                                      apply_norm, build_ropes,
                                      cast_params_once, embed_tokens,
                                      lm_head_weight)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def _kv_shape(cfg: ModelConfig, b: int, s: int, *, window: int | None):
    s_eff = min(s, window) if window is not None else s
    return (b, s_eff, cfg.n_kv_heads, cfg.hd)


def init_caches(cfg: ModelConfig, b: int, s_max: int, *, device=None):
    """Zero caches: per period slot, k/v ``(groups, B, S, Hkv, hd)``."""
    _require_dense(cfg)
    dt = cfg.compute_dtype
    groups = cfg.num_layers // cfg.period
    caches = []
    for slot in range(cfg.period):
        shp = _kv_shape(cfg, b, s_max, window=cfg.attn_kind(slot).window)
        caches.append({"k": torch.zeros((groups,) + shp, dtype=dt,
                                        device=device),
                       "v": torch.zeros((groups,) + shp, dtype=dt,
                                        device=device)})
    return {"blocks": caches}


def grow_caches(cfg: ModelConfig, caches, extra: int):
    """Pad the caches with ``extra`` free positions along S so decode can
    write past the prefill length; sliding-window buffers grow only up to
    ``window``.  Ring-slot math assumes ``window | S_prefill`` when the
    prompt exceeds the window."""
    def pad_s(x, n):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n)) if n else x

    _require_dense(cfg)
    new_slots = []
    for slot, blk in enumerate(caches["blocks"]):
        window = cfg.attn_kind(slot).window
        cur = blk["k"].shape[2]
        grow = extra if window is None else max(
            0, min(window, cur + extra) - cur)
        new_slots.append({k: pad_s(v, grow) for k, v in blk.items()})
    return {**caches, "blocks": new_slots}


# ---------------------------------------------------------------------------
# Per-layer decode helpers
# ---------------------------------------------------------------------------

def _ring_pos_write(cache, new, write):
    """cache ``(B, S, ...)``, new ``(B, 1, ...)``, write an int or ``(B,)``
    slot indices.  Writes in place and returns the cache; indices are
    clamped into range as ``lax.dynamic_update_slice`` clamps them."""
    s = cache.shape[1]
    new = new.to(cache.dtype)
    if isinstance(write, torch.Tensor) and write.ndim:
        idx = write.to(cache.device).long().clamp(0, s - 1)
        cache[torch.arange(cache.shape[0], device=cache.device), idx] = \
            new[:, 0]
    else:
        w = min(max(int(write), 0), s - 1)
        cache[:, w:w + 1] = new
    return cache


def _update_cache(cache, new, pos, *, window: int | None):
    """cache ``(B, S, H, d)`` contiguous or ``(B, W, H, d)`` ring; new
    ``(B, 1, H, d)``; pos an int or ``(B,)``.  Ring-buffered for window
    layers."""
    if window is not None:
        return _ring_pos_write(cache, new, pos % cache.shape[1])
    return _ring_pos_write(cache, new, pos)


def _minimum(x, y: int):
    return x.clamp(max=y) if isinstance(x, torch.Tensor) else min(x, y)


def _gqa_decode(p, x, cache, pos, rt, cfg: ModelConfig, kind: AttnKind,
                ropes):
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear_apply(p["wq"], x).reshape(b, 1, h, hd)
    k = linear_apply(p["wk"], x).reshape(b, 1, hkv, hd)
    v = linear_apply(p["wv"], x).reshape(b, 1, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["qn"], q)
        k = rmsnorm_apply(p["kn"], k)
    if kind.rope:
        cos, sin = ropes[kind.rope_theta]
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    k_cache = _update_cache(cache["k"], k, pos, window=kind.window)
    v_cache = _update_cache(cache["v"], v, pos, window=kind.window)
    if kind.window is not None:
        # Ring buffer: every live slot is inside the window, so plain
        # valid-length masking over min(pos + 1, W) keys.
        w = k_cache.shape[1]
        out = decode_attention(q, k_cache, v_cache, _minimum(pos, w - 1),
                               rt, softcap=kind.softcap,
                               ring_full=_minimum(pos + 1, w))
    else:
        out = decode_attention(q, k_cache, v_cache, pos, rt,
                               softcap=kind.softcap)
    y = linear_apply(p["wo"], out.reshape(b, 1, h * hd))
    return y, {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# Decode step (one new token)
# ---------------------------------------------------------------------------

def _final_logits(params, x, cfg: ModelConfig):
    """A bf16 (compute-dtype) product with the LM head, cast to fp32."""
    x = apply_norm(cfg, params["final_norm"], x)
    w = lm_head_weight(params, cfg)
    return linear_apply({"w": w}, x).float()


def _mlp_half(lp, x, cfg: ModelConfig):
    h = apply_norm(cfg, lp["ln2"], x)
    h = glu_mlp_apply(lp["mlp"], h, act=cfg.act)
    if cfg.post_norms:
        h = apply_norm(cfg, lp["pn2"], h)
    return x + h


def decode_step(params, caches, tokens, pos, rt, cfg: ModelConfig):
    """tokens ``(B, 1)``; pos an int or a per-request ``(B,)`` tensor
    (``-1`` marks an inactive slot).  Returns (logits ``(B, 1, V)`` fp32,
    caches), the caches updated in place."""
    _require_dense(cfg)
    b = tokens.shape[0]
    params = cast_params_once(params, cfg)
    x = embed_tokens(params, tokens, cfg)
    if isinstance(pos, torch.Tensor) and pos.ndim:
        positions = pos.to(x.device)[:, None]
    else:
        positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                               device=x.device)
    positions = positions.clamp(min=0)      # inactive slots: dummy rope
    ropes = build_ropes(cfg, positions) if cfg.rope else {}
    period = cfg.period
    for i, lp in enumerate(params["layers"]):
        g, slot = divmod(i, period)
        kind = cfg.attn_kind(slot)
        blk = caches["blocks"][slot]
        cache = {"k": blk["k"][g], "v": blk["v"][g]}   # views: written in place
        h = apply_norm(cfg, lp["ln1"], x)
        h, _ = _gqa_decode(lp["attn"], h, cache, pos, rt, cfg, kind, ropes)
        if cfg.post_norms:
            h = apply_norm(cfg, lp["pn1"], h)
        x = _mlp_half(lp, x + h, cfg)
    return _final_logits(params, x, cfg), caches


# ---------------------------------------------------------------------------
# Prefill: run the prompt through the trunk, collecting caches
# ---------------------------------------------------------------------------

def _gqa_prefill(p, x, ropes, rt, cfg: ModelConfig, kind: AttnKind):
    """Returns (y, (k, v)) with k/v rotary-applied, in sequence order."""
    b, s, _ = x.shape
    cos, sin = ropes.get(kind.rope_theta, (None, None))
    q, k, v = _project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cos, sin, kind, qk_norm=cfg.qk_norm)
    cfg2d = make_2d_cfg(rt, kind, zigzag=False)
    out = attention_2d(q, k, v, cfg=cfg2d)
    y = linear_apply(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.hd))
    if kind.window is not None:
        k, v = k[:, -kind.window:], v[:, -kind.window:]
    return y, (k, v)


def prefill(params, batch, rt, cfg: ModelConfig):
    """batch: ``{"tokens": (B, S)}`` in sequence order.

    Returns (last-token logits ``(B, 1, V)`` fp32, caches ready for
    ``decode_step`` at pos = S)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    params = cast_params_once(params, cfg)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = embed_tokens(params, tokens, cfg)
    ropes = build_ropes(cfg, positions) if cfg.rope else {}
    period = cfg.period
    kv = [[] for _ in range(period)]
    for i, lp in enumerate(params["layers"]):
        slot = i % period
        h = apply_norm(cfg, lp["ln1"], x)
        h, kv_i = _gqa_prefill(lp["attn"], h, ropes, rt, cfg,
                               cfg.attn_kind(slot))
        if cfg.post_norms:
            h = apply_norm(cfg, lp["pn1"], h)
        x = _mlp_half(lp, x + h, cfg)
        kv[slot].append(kv_i)
    caches = {"blocks": [
        {"k": torch.stack([k for k, _ in pairs]),
         "v": torch.stack([v for _, v in pairs])} for pairs in kv]}
    return _final_logits(params, x[:, -1:], cfg), caches
