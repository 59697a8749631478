"""Serving: caches, prefill and single-token decode for every family, on
one rank or on the 2D-Attention mesh, with contiguous or paged caches
(counterpart of ``src/repro/models/decode.py``).

* Prefill runs every layer's attention through 2D-Attention in contiguous
  (non-zigzag) ring mode, with the sequence sharded over ``head x outer x
  inner`` as in training; on one rank that is one ``flash_attention``
  call, the CUDA forward kernel on the card.
* Decode attention is flash-decoding on the 2D grid
  (``attention_block.decode_attention``, on the ref path as the JAX
  package pins it): the KV cache is sharded over ``(outer, inner)`` on S
  and over ``head`` on the KV heads; each context rank attends its shard
  with this rank's query heads, one max and one sum combine the partials,
  and the heads are gathered over ``head`` before ``wo``.
* Sliding-window layers keep ring-buffer caches of size ``window`` (on a
  mesh the global ring, split over ``(outer, inner)``).
* MoE layers route the prompt's tokens with the default arguments in
  prefill and with ``seq_sharded=False`` in decode, as the reference does;
  the aux loss is dropped.
* MLA layers (deepseek-v2-lite) cache the normed latent ``c`` and the
  roped shared key head ``rope`` a position (576 values at full width,
  not the 6,144 of 16 up-projected K/V heads of 192), split on S only
  (every ``head`` rank holds them whole).  Prefill runs ``mla_apply``'s
  path on the contiguous layout; decode runs *absorbed*: q's nope part is
  taken into latent space through ``kv_up``'s key half, one 576-wide
  latent head is attended on the ref path at the scale ``1/sqrt(d_qk)``
  of the up-projected heads (``kv_replicated``: this rank's query heads
  against the one head), and the output comes back through ``kv_up``'s
  value half.
* SSM layers (``models/ssm.py``) prefill with ``return_state`` (the state
  after the whole prompt and the conv's last inputs, the same on every
  rank) and decode with the O(1) recurrence (``mamba*_decode``),
  replicated on every rank; their caches do not grow.  The hybrid
  family's shared block keeps one KV cache an application, which grows
  like the dense family's.
* The encoder-decoder family (whisper) runs the encoder once in prefill;
  each decoder layer's cross cache holds ``wk`` / ``wv`` of the encoder
  output (``enc_frames`` positions, fixed), while its self-attention
  cache grows.  Cross-attention decodes on the ref path, as in the
  reference.  It serves on one rank (ROADMAP queue 1, item 12).
* Paged decode (``PagedLayout``): full-attention K/V (and the MLA latent)
  live in fixed-size block pools; ``decode_step`` scatters the new token
  through per-request block tables and gathers a contiguous view for the
  combine.  ``pos`` may be a per-request ``(B,)`` vector (ragged
  continuous batching); sliding-window layers keep per-slot ring buffers.
  ``prefill_chunk`` is the serve engine's chunked-prefill step: its
  full-attention and window attention run through ``flash_fwd_chunk`` on
  ``rt.impl`` (the forward kernel on the card), the band a scalar pair.
  Paged caches serve on one rank (``paged_cache_shardings``: ROADMAP
  queue 1, item 12).

On a mesh every rank calls ``prefill`` and ``decode_step`` with the same
global tokens and positions and gets the same global logits; its caches
are its shards.  ``grow_caches`` re-splits them over the context ranks
(rank ``r`` holds positions ``[r L, (r + 1) L)`` of the grown extent ``L
cp``, as GSPMD re-splits the padded global array), which moves data
between ranks.  The data axes (``dp``) are not split in serving.

Caches keep the JAX package's structure, so the tests compare them leaf
for leaf: ``{"blocks": [{"k", "v"}]}`` with one entry per period slot and
a leading group axis (dense, MoE); ``{"blocks": [{"c", "rope"}]}`` stacked
over the layers (MLA); ``{"blocks": {"h", "conv"}}`` stacked
over the layers (SSM); ``{"blocks": {"h", "conv"}}`` over ``(G,
attn_every)``, ``"blocks_tail"`` and ``"shared_attn": {"k", "v"}`` over
``G`` (hybrid); ``{"dec_blocks": {"k", "v"}, "cross": {"k", "v"}}``
stacked over the decoder layers (encdec).  ``decode_step`` and
``prefill_chunk`` write into the pre-sized caches in place (the JAX
package returns updated copies).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.attention2d import _heads_to_seq
from repro_torch.core.runtime import (all_gather, axes_groups, broadcast_,
                                      gather_shards)
from repro_torch.core.topology import AXIS_HP, SEQ_AXES, seq_slice
from repro_torch.kernels.ops import flash_attention, flash_fwd_chunk
from repro_torch.models.attention_block import (AttnKind, _project_qkv,
                                                context_group, context_index,
                                                cross_attend,
                                                decode_attention, gqa_attend,
                                                mla_attend, mla_latent,
                                                mla_project, project_cross)
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
# On a mesh: which shard of a cache this rank holds
# ---------------------------------------------------------------------------

def _on_mesh(rt) -> bool:
    return rt.mesh is not None and rt.pc.num_devices > 1


def _check_serving_mesh(rt, cfg: ModelConfig, paged=None):
    """Raise where serving does not split: the data axes, whisper's cross
    caches, paged pools."""
    if not _on_mesh(rt):
        return
    if rt.pc.dp * rt.pc.pods > 1:
        raise NotImplementedError(
            f"serving splits no batch over data ({rt.pc} has dp * pods = "
            f"{rt.pc.dp * rt.pc.pods}): ROADMAP queue 1, item 12")
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family serves on one rank; its cross "
            "caches on a mesh are ROADMAP queue 1, item 12")
    if paged is not None:
        raise NotImplementedError(
            "paged caches serve on one rank; the paged engine on a mesh "
            "(paged_cache_shardings) is ROADMAP queue 1, item 12")


def _hp(rt) -> int:
    return rt.pc.hp if _on_mesh(rt) else 1


def _cp(rt) -> int:
    return rt.pc.cp if _on_mesh(rt) else 1


def _q_heads(rt, n_heads: int) -> slice:
    """This rank's query heads: ``[i H / hp, (i + 1) H / hp)`` on head
    rank ``i``."""
    hp = _hp(rt)
    if n_heads % hp:
        raise ValueError(f"{n_heads} heads do not split over hp {hp}")
    n = n_heads // hp
    i = rt.coord.head if hp > 1 else 0
    return slice(i * n, (i + 1) * n)


def _head_rows(p, heads: slice, width: int):
    """The rows of a linear layer ``{"w" (out, in)[, "b"]}`` that produce
    ``heads`` of ``width`` columns each."""
    rows = slice(heads.start * width, heads.stop * width)
    return {k: v[rows] for k, v in p.items()}


def _kv_heads(x, rt):
    """This rank's KV heads of ``x`` ``(..., Hkv, d)``: ``max(Hkv, hp) /
    hp`` of them, after repeating each head ``hp / Hkv`` times where ``hp >
    Hkv`` (as 2D-Attention does)."""
    hp = _hp(rt)
    if hp == 1:
        return x
    hkv = x.shape[-2]
    if hp > hkv:
        if hp % hkv:
            raise ValueError(f"hp {hp} is not a multiple of {hkv} KV heads")
        x = x.repeat_interleave(hp // hkv, dim=-2)
    n = x.shape[-2] // hp
    i = rt.coord.head
    return x[..., i * n:(i + 1) * n, :]


def _gather_heads(x, rt):
    """``(B, 1, H / hp, d)`` -> ``(B, 1, H, d)``: every head rank's heads,
    in head order."""
    if _hp(rt) == 1:
        return x
    return all_gather(x.contiguous(), rt.group(AXIS_HP), rt, dim=2)


def _extent(cache, rt) -> tuple[int, int]:
    """``(start, total)``: this rank's first position in a context-sharded
    cache ``(B, L, ...)`` and the global extent ``L cp``."""
    length = cache.shape[1]
    return context_index(rt) * length, length * _cp(rt)


def _gather_context(x, rt, dim: int = 1):
    """The global cache (S on ``dim``) from this rank's context block:
    every context rank's, in order."""
    grp = context_group(rt)
    if grp is None:
        return x
    return gather_shards(x.contiguous(), grp, rt, dim=dim)


def _context_block(x, rt, dim: int = 1):
    """This rank's block of a global cache (S on ``dim``): positions ``[r
    S / cp, (r + 1) S / cp)``."""
    cp = _cp(rt)
    if cp == 1:
        return x
    s = x.shape[dim]
    if s % cp:
        raise ValueError(f"a cache of {s} positions does not split over "
                         f"cp = {cp} context ranks")
    n = s // cp
    return x.narrow(dim, context_index(rt) * n, n).contiguous()


def _to_decode_layout(x, rt):
    """``(B, S / sp, Hkv, d)``, this rank's piece of the sequence with every
    KV head, -> ``(B, S / cp, max(Hkv, hp) / hp, d)``, its context block
    with its KV heads: the Ulysses exchange over ``head``."""
    hp = _hp(rt)
    if hp == 1:
        return x
    hkv = x.shape[2]
    if hp > hkv:
        x = x.repeat_interleave(hp // hkv, dim=2)
    return _heads_to_seq(x.contiguous(), rt.group(AXIS_HP), rt)


def _cut_window(x, window: int, rt):
    """The global last ``window`` positions of a decode-layout cache (all
    of it when the prompt is no longer), split over the context ranks."""
    total = x.shape[1] * _cp(rt)
    if total <= window:
        return x
    if _cp(rt) == 1:
        return x[:, -window:]
    return _context_block(_gather_context(x, rt)[:, -window:], rt)


def _seq_piece(rt, s: int) -> slice:
    """This rank's contiguous piece of a prompt of ``s`` tokens."""
    if not _on_mesh(rt):
        return slice(0, s)
    return seq_slice(rt.pc, rt.coord, s)


def _last_piece_logits(logits, rt):
    """The logits of the rank that holds the prompt's last piece, on every
    rank."""
    if not _on_mesh(rt) or rt.pc.sp == 1:
        return logits
    ag = axes_groups(rt, [SEQ_AXES])[SEQ_AXES]
    return broadcast_(logits.contiguous(), ag.ranks[-1], ag, rt)


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
    if cfg.mla is not None:
        lead = (cfg.num_layers, b, s_max)
        return {"blocks": [{
            "c": torch.zeros(lead + (cfg.mla.kv_lora,), dtype=dt,
                             device=device),
            "rope": torch.zeros(lead + (cfg.mla.d_rope,), dtype=dt,
                                device=device)}]}
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


def grow_caches(cfg: ModelConfig, caches, extra: int, rt=None):
    """Pad the caches with ``extra`` free positions along S so decode can
    write past the prefill length; sliding-window buffers grow only up to
    ``window``, SSM states and whisper's cross caches not at all.  Ring-slot
    math assumes ``window | S_prefill`` when the prompt exceeds the window.

    On a mesh (``rt``) the global cache grows and is split again over the
    context ranks: rank ``r`` then holds positions ``[r L, (r + 1) L)`` of
    the grown extent ``L cp``, so the positions past the old block edges
    move between ranks."""
    def pad_s(x, n):
        """Pad the global S axis (dim 2, after the layer and batch axes)
        and take this rank's block again."""
        if not n:
            return x
        pads = (0, 0) * (x.ndim - 3) + (0, n)
        if rt is None or _cp(rt) == 1:
            return torch.nn.functional.pad(x, pads)
        full = torch.nn.functional.pad(_gather_context(x, rt, dim=2), pads)
        return _context_block(full, rt, dim=2)

    require_ported(cfg)
    cp = _cp(rt) if rt is not None else 1
    if cfg.family == "ssm":
        return caches
    if cfg.family == "encdec":       # the cross cache is fixed
        return {**caches, "dec_blocks": {
            k: pad_s(v, extra) for k, v in caches["dec_blocks"].items()}}
    if cfg.family == "hybrid":
        return {**caches, "shared_attn": {
            k: pad_s(v, extra) for k, v in caches["shared_attn"].items()}}
    if cfg.mla is not None:
        return {**caches, "blocks": [{k: pad_s(v, extra) for k, v in
                                      caches["blocks"][0].items()}]}
    new_slots = []
    for slot, blk in enumerate(caches["blocks"]):
        window = cfg.attn_kind(slot).window
        cur = blk["k"].shape[2] * cp
        grow = extra if window is None else max(
            0, min(window, cur + extra) - cur)
        new_slots.append({k: pad_s(v, grow) for k, v in blk.items()})
    return {**caches, "blocks": new_slots}


# ---------------------------------------------------------------------------
# Paged-KV layout: block pools + per-request block tables
# ---------------------------------------------------------------------------

class PagedLayout(NamedTuple):
    """How a paged cache pool maps logical positions to physical blocks.

    Pools are ``(num_blocks, page_size, ...)`` a layer (stacked pools carry
    a leading layer / group dim).  ``block_tables[b, i]`` is the physical
    block holding request ``b``'s logical positions ``[i page_size, (i + 1)
    page_size)``; the tables are shared by every layer.  Writes of inactive
    slots (``pos < 0``) and of a chunk's padding rows are dropped, so a
    shared physical block is never corrupted by a retired request."""
    block_tables: torch.Tensor     # (B, max_blocks_per_seq) int
    page_size: int
    num_blocks: int                # pool extent


def _rows(x, b: int, device) -> torch.Tensor:
    """An int or a ``(B,)`` tensor as a ``(B,)`` int64 tensor."""
    return torch.as_tensor(x, device=device).long().reshape(-1).expand(b)


def _put_dropping(dest, index: tuple, vals, keep):
    """``dest[index] = vals`` on the rows where ``keep`` holds; the other
    rows change nothing (the reference's scatter with ``mode="drop"``).
    ``index``: in-range index tensors of ``keep``'s shape; ``vals``:
    ``keep.shape`` plus ``dest``'s trailing dims.  No host sync: a dropped
    row repeats the first kept row's write (its place, its value), or,
    where no row is kept, writes back what its own place holds."""
    n = keep.numel()
    keep = keep.reshape(n)
    idx = [i.reshape(n).long() for i in index]
    vals = vals.reshape((n,) + tuple(dest.shape[len(index):])).to(dest.dtype)
    first = keep.int().argmax()
    any_kept = keep.any()
    rows = torch.arange(n, device=keep.device)
    src = torch.where(keep | ~any_kept, rows, first)
    tgt = tuple(i[src] for i in idx)
    lift = (n,) + (1,) * (vals.ndim - 1)
    val = torch.where((keep | any_kept).view(lift), vals[src], dest[tgt])
    dest.index_put_(tgt, val)
    return dest


def _paged_write(pool, vals, pos, paged: PagedLayout):
    """Scatter one token a request: pool ``(NB, Pg, ...)``, vals ``(B,
    ...)``, pos an int or ``(B,)`` logical positions (``< 0``: dropped)."""
    bt = paged.block_tables
    b = bt.shape[0]
    pos = _rows(pos, b, pool.device)
    blk = (pos // paged.page_size).clamp(0, bt.shape[1] - 1)
    phys = bt.gather(1, blk[:, None])[:, 0]
    return _put_dropping(pool, (phys, pos % paged.page_size), vals,
                         pos >= 0)


def _paged_write_chunk(pool, vals, start, valid, paged: PagedLayout):
    """Scatter a prefill chunk: vals ``(B, Lc, ...)`` at positions ``start
    .. start + valid`` a request (rows ``>= valid`` dropped)."""
    b, lc = vals.shape[:2]
    bt = paged.block_tables
    t = torch.arange(lc, device=pool.device)[None]
    pos = _rows(start, b, pool.device)[:, None] + t          # (B, Lc)
    live = t < _rows(valid, b, pool.device)[:, None]
    blk = (pos // paged.page_size).clamp(0, bt.shape[1] - 1)
    phys = bt.long().gather(1, blk)
    return _put_dropping(pool, (phys, pos % paged.page_size), vals, live)


def _paged_view(pool, paged: PagedLayout):
    """``(NB, Pg, ...)`` -> ``(B, max_blocks Pg, ...)`` gathered through
    the block tables: the contiguous view the combine attends."""
    pages = pool[paged.block_tables.long()]          # (B, MAXB, Pg, ...)
    b, nb, pg = pages.shape[:3]
    return pages.reshape((b, nb * pg) + tuple(pages.shape[3:]))


# ---------------------------------------------------------------------------
# Per-layer decode helpers
# ---------------------------------------------------------------------------

def _ring_pos_write(cache, new, write, start: int = 0,
                    total: int | None = None):
    """cache ``(B, L, ...)``: positions ``[start, start + L)`` of a global
    ``(B, total, ...)`` cache (``total`` None: ``L``, one rank); new ``(B,
    1, ...)``; write an int or ``(B,)`` global indices, clamped into ``[0,
    total)`` as ``lax.dynamic_update_slice`` clamps them.  A row whose index
    lies on another rank is dropped.  Writes in place and returns the
    cache."""
    length = cache.shape[1]
    total = length if total is None else total
    new = new.to(cache.dtype)
    if isinstance(write, torch.Tensor) and write.ndim:
        at = write.to(cache.device).long().clamp(0, total - 1) - start
        rows = torch.arange(cache.shape[0], device=cache.device)
        _put_dropping(cache, (rows, at.clamp(0, length - 1)), new[:, 0],
                      (at >= 0) & (at < length))
    else:
        at = min(max(int(write), 0), total - 1) - start
        if 0 <= at < length:
            cache[:, at:at + 1] = new
    return cache


def _update_cache(cache, new, pos, *, window: int | None,
                  paged: PagedLayout | None = None, start: int = 0,
                  total: int | None = None):
    """cache ``(B, S, H, d)`` contiguous, ``(B, W, H, d)`` ring or ``(NB,
    Pg, H, d)`` paged pool (on a mesh this rank's block ``[start, start +
    S)`` of the global extent ``total``); new ``(B, 1, H, d)``; pos an int
    or ``(B,)``.  Ring-buffered for window layers, paged or not."""
    if window is not None:
        total = cache.shape[1] if total is None else total
        return _ring_pos_write(cache, new, pos % total, start, total)
    if paged is not None:
        return _paged_write(cache, new[:, 0], pos, paged)
    return _ring_pos_write(cache, new, pos, start, total)


def _minimum(x, y: int):
    return x.clamp(max=y) if isinstance(x, torch.Tensor) else min(x, y)


def _gqa_decode(p, x, cache, pos, rt, cfg: ModelConfig, kind: AttnKind,
                ropes, paged: PagedLayout | None = None):
    """One token of a GQA layer: q for this rank's heads, k / v for its KV
    heads written into its cache shard, the combine over the context
    ranks, the heads gathered before ``wo``."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    heads = _q_heads(rt, h)
    q = linear_apply(_head_rows(p["wq"], heads, hd), x).reshape(
        b, 1, heads.stop - heads.start, hd)
    k = _kv_heads(linear_apply(p["wk"], x).reshape(b, 1, hkv, hd), rt)
    v = _kv_heads(linear_apply(p["wv"], x).reshape(b, 1, hkv, hd), rt)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["qn"], q)
        k = rmsnorm_apply(p["kn"], k)
    if kind.rope:
        cos, sin = ropes[kind.rope_theta]
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    use_paged = paged if kind.window is None else None
    start, total = _extent(cache["k"], rt)
    k_cache = _update_cache(cache["k"], k, pos, window=kind.window,
                            paged=use_paged, start=start, total=total)
    v_cache = _update_cache(cache["v"], v, pos, window=kind.window,
                            paged=use_paged, start=start, total=total)
    if kind.window is not None:
        # Ring buffer: every live slot is inside the window, so plain
        # valid-length masking over min(pos + 1, W) keys.
        out = decode_attention(q, k_cache, v_cache, _minimum(pos, total - 1),
                               rt, softcap=kind.softcap,
                               ring_full=_minimum(pos + 1, total))
    else:
        k_att = _paged_view(k_cache, paged) if use_paged else k_cache
        v_att = _paged_view(v_cache, paged) if use_paged else v_cache
        out = decode_attention(q, k_att, v_att, pos, rt,
                               softcap=kind.softcap)
    y = linear_apply(p["wo"], _gather_heads(out, rt).reshape(b, 1, h * hd))
    return y, {"k": k_cache, "v": v_cache}


def _mla_decode(p, x, cache, pos, rt, cfg: ModelConfig, ropes,
                paged: PagedLayout | None = None):
    """One token of an MLA layer, absorbed: the new latent and rope key
    written into the cache views (in place; on a mesh this rank's context
    block, the same on every head rank), then one ``kv_lora + d_rope``
    wide key head ``[c, rope]`` and value head ``[c, 0]`` attended by this
    rank's ``q_eff = [q_nope W_uk, q_rope]`` at scale ``1/sqrt(d_qk)`` (not
    the latent head's width), the latent output taken through ``W_uv``,
    the heads gathered, ``wo``.  ``kv_up.w`` is ``(H (d_nope + d_v),
    kv_lora)``: head h's key rows are the first ``d_nope`` of its block,
    its value rows the rest."""
    m = cfg.mla
    b = x.shape[0]
    cos, sin = ropes[cfg.rope_theta]
    heads = _q_heads(rt, m.n_heads)
    q = linear_apply(_head_rows(p["wq"], heads, m.d_qk), x).reshape(
        b, 1, heads.stop - heads.start, m.d_qk)
    q_nope = q[..., :m.d_nope]
    q_rope = apply_rotary(q[..., m.d_nope:], cos, sin)
    c_t, kr_t = mla_latent(p, x, cos, sin, m)
    start, total = _extent(cache["c"], rt)
    c_cache = _update_cache(cache["c"], c_t, pos, window=None, paged=paged,
                            start=start, total=total)
    r_cache = _update_cache(cache["rope"], kr_t[:, :, 0], pos, window=None,
                            paged=paged, start=start, total=total)
    c_att = _paged_view(c_cache, paged) if paged is not None else c_cache
    r_att = _paged_view(r_cache, paged) if paged is not None else r_cache

    w_up = p["kv_up"]["w"].view(m.n_heads, m.d_nope + m.d_v,
                                m.kv_lora)[heads]
    w_uk = w_up[:, :m.d_nope].to(q_nope.dtype)       # (H, d_nope, lora)
    w_uv = w_up[:, m.d_nope:]                         # (H, d_v, lora)
    q_lat = torch.einsum("bthn,hnl->bthl", q_nope, w_uk)
    q_eff = torch.cat([q_lat, q_rope], dim=-1)        # (B, 1, H, lora+rope)
    k_eff = torch.cat([c_att, r_att], dim=-1)[:, :, None]
    v_eff = torch.nn.functional.pad(c_att[:, :, None], (0, m.d_rope))
    out = decode_attention(q_eff, k_eff, v_eff, pos, rt,
                           scale=1.0 / m.d_qk ** 0.5, kv_replicated=True)
    out_lat = out[..., :m.kv_lora]                    # (B, 1, H, lora)
    o = torch.einsum("bthl,hvl->bthv", out_lat, w_uv.to(out_lat.dtype))
    o = _gather_heads(o, rt)
    return linear_apply(p["wo"], o.reshape(b, 1, m.n_heads * m.d_v))


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


def decode_step(params, caches, tokens, pos, rt, cfg: ModelConfig,
                paged: PagedLayout | None = None):
    """tokens ``(B, 1)``; pos an int or a per-request ``(B,)`` tensor
    (``-1`` marks an inactive slot).  ``paged``: full-attention K/V (and the
    MLA latent) caches are block pools read through the per-request block
    tables (dense and MoE families, one rank).  On a mesh every rank passes
    the same tokens and positions and its cache shards.  Returns (logits
    ``(B, 1, V)`` fp32, caches), the caches updated in place."""
    require_ported(cfg)
    if paged is not None and cfg.family not in ("dense", "moe"):
        raise ValueError(f"paged decode serves the dense and MoE families, "
                         f"not {cfg.family}")
    _check_serving_mesh(rt, cfg, paged)
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
    if cfg.mla is not None:
        blk = caches["blocks"][0]
        for i, lp in enumerate(params["layers"]):
            h = _mla_decode(lp["attn"], apply_norm(cfg, lp["ln1"], x),
                            {k: v[i] for k, v in blk.items()}, pos, rt, cfg,
                            ropes, paged=paged)
            x = _mlp_half(lp, x + h, rt, cfg, seq_sharded=False)
        return _final_logits(params, x, cfg), caches
    period = cfg.period
    for i, lp in enumerate(params["layers"]):
        g, slot = divmod(i, period)
        kind = cfg.attn_kind(slot)
        blk = caches["blocks"][slot]
        cache = {"k": blk["k"][g], "v": blk["v"][g]}   # views: written in place
        h = apply_norm(cfg, lp["ln1"], x)
        h, _ = _gqa_decode(lp["attn"], h, cache, pos, rt, cfg, kind, ropes,
                           paged=paged)
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
    """Returns (y, (k, v)): k / v rotary-applied in sequence order, in the
    decode layout (on a mesh: this rank's context block with its KV heads;
    window layers: the global last ``window`` positions)."""
    cos, sin = ropes.get(kind.rope_theta, (None, None))
    q, k, v = _project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cos, sin, kind, qk_norm=cfg.qk_norm)
    y = linear_apply(p["wo"], gqa_attend(q, k, v, rt, kind, zigzag=False))
    k, v = _to_decode_layout(k, rt), _to_decode_layout(v, rt)
    if kind.window is not None:
        k, v = _cut_window(k, kind.window, rt), _cut_window(v, kind.window,
                                                            rt)
    return y, (k, v)


def prefill(params, batch, rt, cfg: ModelConfig):
    """batch: ``{"tokens": (B, S)}`` in sequence order, and ``frames``
    ``(B, T_enc, D)`` for the encoder-decoder family.  On a mesh every rank
    passes the whole batch; each runs the training forward on its
    contiguous piece of the sequence (``seq_slice``).

    Returns (last-token logits ``(B, 1, V)`` fp32, on every rank; caches
    ready for ``decode_step`` at pos = S, this rank's shards)."""
    require_ported(cfg)
    _check_serving_mesh(rt, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    piece = _seq_piece(rt, s)
    tokens = tokens[:, piece]
    params = cast_params_once(params, cfg)
    positions = torch.arange(piece.start, piece.stop, dtype=torch.int32,
                             device=tokens.device)[None].expand(
                                 b, piece.stop - piece.start)
    x = embed_tokens(params, tokens, cfg)
    ropes = build_ropes(cfg, positions) if cfg.rope else {}
    if cfg.family in ("ssm", "hybrid"):
        x, caches = _mamba_prefill(params, x, rt, cfg, ropes)
    elif cfg.family == "encdec":
        x, caches = _whisper_prefill(params, x, batch["frames"], positions,
                                     rt, cfg)
    elif cfg.mla is not None:
        x, caches = _mla_prefill(params, x, rt, cfg, ropes)
    else:
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
    logits = _final_logits(params, x[:, -1:], cfg)
    return _last_piece_logits(logits, rt), caches


def _mla_prefill(params, x, rt, cfg: ModelConfig, ropes):
    """The prompt through the MLA trunk, each layer's attention on the
    contiguous layout: ``(x, caches)``, the latent and the roped rope key
    of every position (on a mesh this rank's context block: the head
    ranks' pieces gathered along S)."""
    m = cfg.mla
    cos, sin = ropes[cfg.rope_theta]
    kind = AttnKind(causal=True, rope=True, rope_theta=cfg.rope_theta)
    lat, rope = [], []
    for lp in params["layers"]:
        q, k, v, (c, k_rope) = mla_project(
            lp["attn"], apply_norm(cfg, lp["ln1"], x), cos, sin, m)
        h = linear_apply(lp["attn"]["wo"], mla_attend(q, k, v, rt, kind, m,
                                                      zigzag=False))
        x = _mlp_half(lp, x + h, rt, cfg)
        if _hp(rt) > 1:
            g_hp = rt.group(AXIS_HP)
            c = all_gather(c.contiguous(), g_hp, rt, dim=1)
            k_rope = all_gather(k_rope.contiguous(), g_hp, rt, dim=1)
        lat.append(c)
        rope.append(k_rope[:, :, 0])
    return x, {"blocks": [{"c": torch.stack(lat), "rope": torch.stack(rope)}]}


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


# ---------------------------------------------------------------------------
# Chunked prefill against a paged cache (the serve engine's building block)
# ---------------------------------------------------------------------------

def _is_scalar(x) -> bool:
    return not (isinstance(x, torch.Tensor) and x.ndim)


def prefill_chunk(params, caches, tokens, start, valid, rt,
                  cfg: ModelConfig, paged: PagedLayout):
    """One prefill chunk against the paged cache (dense and MoE families,
    one rank).

    tokens ``(B, Lc)``: a bucketed chunk (rows ``>= valid`` are padding);
    start: the logical position of ``tokens[:, 0]``; valid: the real tokens
    in the chunk (``<= Lc``); each an int or a ``(B,)`` tensor.

    Full-attention layers write the chunk's K/V through the block tables,
    then attend the gathered pages with a ``start``-anchored causal band
    capped at ``start + valid`` visible keys.  Sliding-window layers need
    the whole prompt in one chunk (``start == 0``): chunk-local banded
    attention is exact there, and the ring buffer is seeded with the last
    ``min(window, valid)`` positions.  With int ``start`` / ``valid`` (the
    engine's calls) the band is a scalar pair and the attention runs on
    ``rt.impl``: the forward kernel on the card.  Per-request tensors run
    on the ref path.  MLA runs absorbed against the gathered latent pages,
    on the ref path: its one latent head is ``kv_lora + d_rope`` (576)
    wide, above the kernels' widest ``KERNEL_D`` (384), as the reference
    runs it on its ref path.

    Returns (logits of token ``valid - 1`` a request ``(B, 1, V)`` fp32,
    caches), the caches updated in place."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"prefill_chunk serves the dense and MoE families, "
                         f"not {cfg.family}")
    _check_serving_mesh(rt, cfg, paged)
    b, lc = tokens.shape
    dev = tokens.device
    params = cast_params_once(params, cfg)
    x = embed_tokens(params, tokens, cfg)
    t = torch.arange(lc, device=dev)[None]
    start_c = _rows(start, b, dev)[:, None]
    valid_c = _rows(valid, b, dev)[:, None]
    positions = (start_c + t).clamp(min=0).int()
    ropes = build_ropes(cfg, positions) if cfg.rope else {}
    scalar = _is_scalar(start) and _is_scalar(valid)
    impl = rt.impl if scalar else "ref"
    if scalar:
        start, valid = int(start), int(valid)
    kv_end = start + valid

    def gqa_chunk(p, h, cache, kind: AttnKind):
        cos, sin = ropes.get(kind.rope_theta, (None, None))
        q, k, v = _project_qkv(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                               cos, sin, kind, qk_norm=cfg.qk_norm)
        if kind.window is not None:
            w = kind.window
            out, _ = flash_fwd_chunk(q, k, v, causal=True, window=w,
                                     softcap=kind.softcap,
                                     kv_valid_len=valid, impl=impl)
            # Seed the ring buffer with the last min(w, valid) positions,
            # each in its decode slot ``pos % w``; the rest (and the
            # padding rows) are dropped.
            keep = ((t < valid_c) & (t >= valid_c - w)).expand(b, lc)
            at = (torch.arange(b, device=dev)[:, None].expand(b, lc),
                  (t % w).expand(b, lc))
            _put_dropping(cache["k"], at, k, keep)
            _put_dropping(cache["v"], at, v, keep)
        else:
            _paged_write_chunk(cache["k"], k, start, valid, paged)
            _paged_write_chunk(cache["v"], v, start, valid, paged)
            out, _ = flash_fwd_chunk(q, _paged_view(cache["k"], paged),
                                     _paged_view(cache["v"], paged),
                                     causal=True, softcap=kind.softcap,
                                     mask_offset=start, kv_valid_len=kv_end,
                                     impl=impl)
        return linear_apply(p["wo"], out.reshape(b, lc, cfg.n_heads * cfg.hd))

    def mla_chunk(p, h, cache):
        m = cfg.mla
        cos, sin = ropes[cfg.rope_theta]
        q = linear_apply(p["wq"], h).reshape(b, lc, m.n_heads, m.d_qk)
        q_nope = q[..., :m.d_nope]
        q_rope = apply_rotary(q[..., m.d_nope:], cos, sin)
        c_t, kr_t = mla_latent(p, h, cos, sin, m)
        _paged_write_chunk(cache["c"], c_t, start, valid, paged)
        _paged_write_chunk(cache["rope"], kr_t[:, :, 0], start, valid, paged)
        c_att = _paged_view(cache["c"], paged)
        r_att = _paged_view(cache["rope"], paged)
        w_up = p["kv_up"]["w"].view(m.n_heads, m.d_nope + m.d_v, m.kv_lora)
        q_lat = torch.einsum("bthn,hnl->bthl", q_nope,
                             w_up[:, :m.d_nope].to(q_nope.dtype))
        q_eff = torch.cat([q_lat, q_rope], dim=-1)
        k_eff = torch.cat([c_att, r_att], dim=-1)[:, :, None]
        v_eff = torch.nn.functional.pad(c_att[:, :, None], (0, m.d_rope))
        # One 576-wide latent head: above KERNEL_D's 384, so the ref path.
        out, _ = flash_fwd_chunk(q_eff, k_eff, v_eff, causal=True,
                                 scale=1.0 / m.d_qk ** 0.5,
                                 mask_offset=start, kv_valid_len=kv_end,
                                 impl="ref")
        o = torch.einsum("bthl,hvl->bthv", out[..., :m.kv_lora],
                         w_up[:, m.d_nope:].to(out.dtype))
        return linear_apply(p["wo"], o.reshape(b, lc, m.n_heads * m.d_v))

    period = cfg.period
    for i, lp in enumerate(params["layers"]):
        h = apply_norm(cfg, lp["ln1"], x)
        if cfg.mla is not None:
            blk = caches["blocks"][0]
            h = mla_chunk(lp["attn"], h, {k: v[i] for k, v in blk.items()})
        else:
            g, slot = divmod(i, period)
            blk = caches["blocks"][slot]
            h = gqa_chunk(lp["attn"], h, {"k": blk["k"][g],
                                          "v": blk["v"][g]},
                          cfg.attn_kind(slot))
            if cfg.post_norms:
                h = apply_norm(cfg, lp["pn1"], h)
        x = _mlp_half(lp, x + h, rt, cfg, seq_sharded=False)
    last = (valid_c[:, 0] - 1).clamp(0, lc - 1)
    x_last = x[torch.arange(b, device=dev), last][:, None]
    return _final_logits(params, x_last, cfg), caches
