"""Serving: caches, prefill and single-token decode for the dense, MoE,
SSM and hybrid families (counterpart of ``src/repro/models/decode.py``).

* Prefill runs every layer's attention through 2D-Attention, which on one
  rank is one ``flash_attention`` call: the CUDA forward kernel on the card.
* Decode attention runs on the ref path (``decode_attention``), as the JAX
  package pins it.
* Sliding-window layers keep ring-buffer caches of size ``window``.
* MoE layers route the prompt's tokens with the default arguments in
  prefill and with ``seq_sharded=False`` in decode, as the reference does;
  the aux loss is dropped.
* SSM layers (``models/ssm.py``) prefill with ``return_state`` (the state
  after the whole prompt and the conv's last inputs) and decode with the
  O(1) recurrence (``mamba*_decode``), replicated on every rank; their
  caches do not grow.  The hybrid family's shared block keeps one KV cache
  an application, which grows like the dense family's.
* The encoder-decoder family (whisper) runs the encoder once in prefill;
  each decoder layer's cross cache holds ``wk`` / ``wv`` of the encoder
  output (``enc_frames`` positions, fixed), while its self-attention
  cache grows.  Cross-attention decodes on the ref path, as in the
  reference.

Caches keep the JAX package's structure, so the tests compare them leaf
for leaf: ``{"blocks": [{"k", "v"}]}`` with one entry per period slot and
a leading group axis (dense, MoE); ``{"blocks": {"h", "conv"}}`` stacked
over the layers (SSM); ``{"blocks": {"h", "conv"}}`` over ``(G,
attn_every)``, ``"blocks_tail"`` and ``"shared_attn": {"k", "v"}`` over
``G`` (hybrid); ``{"dec_blocks": {"k", "v"}, "cross": {"k", "v"}}``
stacked over the decoder layers (encdec).  ``decode_step`` writes the
new token into the
pre-sized cache in place (the JAX package returns an updated copy).
Paged caches and ``prefill_chunk`` come with ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import flash_attention
from repro_torch.models.attention_block import (AttnKind, _project_qkv,
                                                cross_attend,
                                                decode_attention, gqa_attend,
                                                project_cross)
from repro_torch.models.layers import (apply_rotary, embedding_apply,
                                       gelu_mlp_apply, glu_mlp_apply,
                                       linear_apply, rmsnorm_apply)
from repro_torch.models.model import (DEC_KIND, ModelConfig, apply_norm,
                                      build_ropes, cast_params_once,
                                      embed_tokens, hybrid_groups,
                                      lm_head_weight, require_ported,
                                      whisper_encoder)
from repro_torch.models.moe import moe_apply
from repro_torch.models.ssm import (mamba1_apply, mamba1_decode,
                                    mamba2_apply, mamba2_decode)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def _kv_shape(cfg: ModelConfig, b: int, s: int, *, window: int | None):
    s_eff = min(s, window) if window is not None else s
    return (b, s_eff, cfg.n_kv_heads, cfg.hd)


def _ssm_state(cfg: ModelConfig, lead: tuple, b: int, device):
    """Zero SSM states stacked over ``lead``: ``h`` fp32, ``conv`` in the
    compute dtype."""
    if cfg.family == "ssm":
        m = cfg.ssm1
        h, conv = (b, m.d_inner, m.d_state), (b, m.d_conv - 1, m.d_inner)
    else:
        m = cfg.ssm2
        h = (b, m.n_heads, m.head_dim, m.d_state)
        conv = (b, m.d_conv - 1, m.conv_dim)
    return {"h": torch.zeros(lead + h, dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + conv, dtype=cfg.compute_dtype,
                                device=device)}


def init_caches(cfg: ModelConfig, b: int, s_max: int, *, device=None):
    """Zero caches: per period slot, k/v ``(groups, B, S, Hkv, hd)``; the
    SSM and hybrid families' as the module docstring lays them out."""
    require_ported(cfg)
    dt = cfg.compute_dtype
    if cfg.family == "encdec":
        n = cfg.num_layers
        shp = (n,) + _kv_shape(cfg, b, s_max, window=None)
        enc = (n, b, cfg.enc_frames, cfg.n_heads, cfg.hd)
        return {"dec_blocks": {k: torch.zeros(shp, dtype=dt, device=device)
                               for k in ("k", "v")},
                "cross": {k: torch.zeros(enc, dtype=dt, device=device)
                          for k in ("k", "v")}}
    if cfg.family == "ssm":
        return {"blocks": _ssm_state(cfg, (cfg.num_layers,), b, device)}
    if cfg.family == "hybrid":
        groups, rem = hybrid_groups(cfg)
        shp = (groups,) + _kv_shape(cfg, b, s_max, window=None)
        caches = {"blocks": _ssm_state(cfg, (groups, cfg.attn_every), b,
                                       device),
                  "shared_attn": {"k": torch.zeros(shp, dtype=dt,
                                                   device=device),
                                  "v": torch.zeros(shp, dtype=dt,
                                                   device=device)}}
        if rem:
            caches["blocks_tail"] = _ssm_state(cfg, (rem,), b, device)
        return caches
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
    ``window``, SSM states and whisper's cross caches not at all.  Ring-slot math assumes ``window |
    S_prefill`` when the prompt exceeds the window."""
    def pad_s(x, n):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n)) if n else x

    require_ported(cfg)
    if cfg.family == "ssm":
        return caches
    if cfg.family == "encdec":       # the cross cache is fixed
        return {**caches, "dec_blocks": {
            k: pad_s(v, extra) for k, v in caches["dec_blocks"].items()}}
    if cfg.family == "hybrid":
        return {**caches, "shared_attn": {
            k: pad_s(v, extra) for k, v in caches["shared_attn"].items()}}
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


def _mlp_half(lp, x, rt, cfg: ModelConfig, seq_sharded: bool = True):
    h = apply_norm(cfg, lp["ln2"], x)
    if cfg.family == "moe":
        h, _ = moe_apply(lp["moe"], h, rt, cfg.moe, seq_sharded=seq_sharded)
    else:
        h = glu_mlp_apply(lp["mlp"], h, act=cfg.act)
    if cfg.post_norms:
        h = apply_norm(cfg, lp["pn2"], h)
    return x + h


def decode_step(params, caches, tokens, pos, rt, cfg: ModelConfig):
    """tokens ``(B, 1)``; pos an int or a per-request ``(B,)`` tensor
    (``-1`` marks an inactive slot).  Returns (logits ``(B, 1, V)`` fp32,
    caches), the caches updated in place."""
    require_ported(cfg)
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
    if cfg.family in ("ssm", "hybrid"):
        x = _mamba_decode(params, caches, x, pos, rt, cfg, ropes)
        return _final_logits(params, x, cfg), caches
    if cfg.family == "encdec":
        x = _whisper_decode(params, caches, x, positions, pos, rt, cfg)
        return _final_logits(params, x, cfg), caches
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
        x = _mlp_half(lp, x + h, rt, cfg, seq_sharded=False)
    return _final_logits(params, x, cfg), caches


def _dec_pos(params, x, positions, cfg: ModelConfig):
    """``x`` plus whisper's learned positions, clamped to the table."""
    return x + embedding_apply(
        params["dec_pos"], positions.clamp(max=cfg.max_positions - 1),
        dtype=x.dtype)


def _cross_decode(p, x, cache, cfg: ModelConfig):
    """Cross-attention of one token against a layer's encoder cache, on
    the ref path."""
    b = x.shape[0]
    q = linear_apply(p["wq"], x).reshape(b, 1, cfg.n_heads, cfg.hd)
    out = flash_attention(q, cache["k"], cache["v"], causal=False,
                          impl="ref")
    return linear_apply(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.hd))


def _whisper_decode(params, caches, x, positions, pos, rt,
                    cfg: ModelConfig):
    """One token through the decoder; the self caches are written in
    place, the cross caches only read."""
    x = _dec_pos(params, x, positions, cfg)
    sc, xc = caches["dec_blocks"], caches["cross"]
    for i, lp in enumerate(params["dec_layers"]):
        h, _ = _gqa_decode(lp["attn"], apply_norm(cfg, lp["ln1"], x),
                           {"k": sc["k"][i], "v": sc["v"][i]}, pos, rt, cfg,
                           DEC_KIND, {})
        x = x + h
        x = x + _cross_decode(lp["cross"], apply_norm(cfg, lp["lnx"], x),
                              {"k": xc["k"][i], "v": xc["v"][i]}, cfg)
        x = x + gelu_mlp_apply(lp["mlp"], apply_norm(cfg, lp["ln2"], x))
    return x


def _write_state(cache: dict, at: tuple, new: dict):
    """Write one layer's new SSM state into the stacked cache in place."""
    for k, v in new.items():
        cache[k][at].copy_(v)


def _shared_decode(shared, x, cache, pos, rt, cfg: ModelConfig, ropes):
    """The hybrid family's shared block on one token against one
    application's KV cache (views: written in place)."""
    h = apply_norm(cfg, shared["ln1"], x)
    h, _ = _gqa_decode(shared["attn"], h, cache, pos, rt, cfg,
                       cfg.attn_kind(0), ropes)
    return _mlp_half(shared, x + h, rt, cfg)


def _mamba_decode(params, caches, x, pos, rt, cfg: ModelConfig, ropes):
    """One token through the SSM or hybrid trunk; the states and the
    shared block's KV caches are written in place."""
    step = mamba1_decode if cfg.family == "ssm" else mamba2_decode
    m = cfg.ssm1 if cfg.family == "ssm" else cfg.ssm2
    p = cfg.attn_every
    groups = hybrid_groups(cfg)[0] if cfg.family == "hybrid" else 0
    for i, lp in enumerate(params["layers"]):
        if cfg.family == "ssm":
            cache, at = caches["blocks"], (i,)
        elif i < groups * p:
            cache, at = caches["blocks"], divmod(i, p)
        else:
            cache, at = caches["blocks_tail"], (i - groups * p,)
        h, new = step(lp["mix"], apply_norm(cfg, lp["ln"], x),
                      {k: v[at] for k, v in cache.items()}, m)
        _write_state(cache, at, new)
        x = x + h
        if i < groups * p and (i + 1) % p == 0:
            kv = caches["shared_attn"]
            g = i // p
            x = _shared_decode(params["shared_attn"], x,
                               {"k": kv["k"][g], "v": kv["v"][g]}, pos, rt,
                               cfg, ropes)
    return x


# ---------------------------------------------------------------------------
# Prefill: run the prompt through the trunk, collecting caches
# ---------------------------------------------------------------------------

def _gqa_prefill(p, x, ropes, rt, cfg: ModelConfig, kind: AttnKind):
    """Returns (y, (k, v)) with k/v rotary-applied, in sequence order."""
    cos, sin = ropes.get(kind.rope_theta, (None, None))
    q, k, v = _project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cos, sin, kind, qk_norm=cfg.qk_norm)
    y = linear_apply(p["wo"], gqa_attend(q, k, v, rt, kind, zigzag=False))
    if kind.window is not None:
        k, v = k[:, -kind.window:], v[:, -kind.window:]
    return y, (k, v)


def prefill(params, batch, rt, cfg: ModelConfig):
    """batch: ``{"tokens": (B, S)}`` in sequence order, and ``frames``
    ``(B, T_enc, D)`` for the encoder-decoder family.

    Returns (last-token logits ``(B, 1, V)`` fp32, caches ready for
    ``decode_step`` at pos = S)."""
    require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    params = cast_params_once(params, cfg)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = embed_tokens(params, tokens, cfg)
    ropes = build_ropes(cfg, positions) if cfg.rope else {}
    if cfg.family in ("ssm", "hybrid"):
        x, caches = _mamba_prefill(params, x, rt, cfg, ropes)
        return _final_logits(params, x[:, -1:], cfg), caches
    if cfg.family == "encdec":
        x, caches = _whisper_prefill(params, x, batch["frames"], positions,
                                     rt, cfg)
        return _final_logits(params, x[:, -1:], cfg), caches
    period = cfg.period
    kv = [[] for _ in range(period)]
    for i, lp in enumerate(params["layers"]):
        slot = i % period
        h = apply_norm(cfg, lp["ln1"], x)
        h, kv_i = _gqa_prefill(lp["attn"], h, ropes, rt, cfg,
                               cfg.attn_kind(slot))
        if cfg.post_norms:
            h = apply_norm(cfg, lp["pn1"], h)
        x = _mlp_half(lp, x + h, rt, cfg)
        kv[slot].append(kv_i)
    caches = {"blocks": [
        {"k": torch.stack([k for k, _ in pairs]),
         "v": torch.stack([v for _, v in pairs])} for pairs in kv]}
    return _final_logits(params, x[:, -1:], cfg), caches


def _stack_states(states: list, lead: tuple) -> dict:
    """Per-layer ``{"h", "conv"}`` states stacked over ``lead``."""
    return {k: torch.stack([st[k] for st in states]).reshape(
        lead + tuple(states[0][k].shape)) for k in states[0]}


def _mamba_prefill(params, x, rt, cfg: ModelConfig, ropes):
    """The prompt through the SSM or hybrid trunk: ``(x, caches)``."""
    apply = mamba1_apply if cfg.family == "ssm" else mamba2_apply
    m = cfg.ssm1 if cfg.family == "ssm" else cfg.ssm2
    if cfg.family == "ssm":
        states = []
        for lp in params["layers"]:
            h, st = apply(lp["mix"], apply_norm(cfg, lp["ln"], x), rt, m,
                          return_state=True)
            x = x + h
            states.append(st)
        return x, {"blocks": _stack_states(states, (cfg.num_layers,))}
    p = cfg.attn_every
    groups, rem = hybrid_groups(cfg)
    shared, states, kv = params["shared_attn"], [], []
    for i, lp in enumerate(params["layers"]):
        h, st = apply(lp["mix"], apply_norm(cfg, lp["ln"], x), rt, m,
                      return_state=True)
        x = x + h
        states.append(st)
        if i < groups * p and (i + 1) % p == 0:
            h, kv_i = _gqa_prefill(shared["attn"],
                                   apply_norm(cfg, shared["ln1"], x), ropes,
                                   rt, cfg, cfg.attn_kind(0))
            x = _mlp_half(shared, x + h, rt, cfg)
            kv.append(kv_i)
    caches = {"blocks": _stack_states(states[:groups * p], (groups, p)),
              "shared_attn": {"k": torch.stack([k for k, _ in kv]),
                              "v": torch.stack([v for _, v in kv])}}
    if rem:
        caches["blocks_tail"] = _stack_states(states[groups * p:], (rem,))
    return x, caches


def _whisper_prefill(params, x, frames, positions, rt, cfg: ModelConfig):
    """The encoder over ``frames``, then the prompt through the decoder:
    ``(x, caches)``, each layer's self K/V and its cross K/V (``wk`` /
    ``wv`` of the encoder output)."""
    enc = whisper_encoder(params, frames, rt, cfg)
    x = _dec_pos(params, x, positions, cfg)
    self_kv, cross_kv = [], []
    for lp in params["dec_layers"]:
        h, kv = _gqa_prefill(lp["attn"], apply_norm(cfg, lp["ln1"], x), {},
                             rt, cfg, DEC_KIND)
        x = x + h
        self_kv.append(kv)
        q, k, v = project_cross(lp["cross"], apply_norm(cfg, lp["lnx"], x),
                                enc, n_heads=cfg.n_heads, head_dim=cfg.hd)
        cross_kv.append((k, v))
        x = x + linear_apply(lp["cross"]["wo"], cross_attend(q, k, v, rt))
        x = x + gelu_mlp_apply(lp["mlp"], apply_norm(cfg, lp["ln2"], x))

    def stack(pairs):
        return {"k": torch.stack([k for k, _ in pairs]),
                "v": torch.stack([v for _, v in pairs])}

    return x, {"dec_blocks": stack(self_kv), "cross": stack(cross_kv)}
