"""Dense attention oracle in plain PyTorch (counterpart of
``src/repro/kernels/ref.py``).

Conventions (the same as the JAX package's):

* Layout: ``q (B, Lq, Hq, D)``, ``k/v (B, Lk, Hkv, D)``, ``Hq % Hkv == 0``.
* ``causal`` is bottom-right aligned at the full ``Lk``: row ``i`` sees
  column ``j`` iff ``j <= i + (Lk - Lq)``; ``kv_valid_len`` cuts keys and
  does not re-anchor that band.
* ``window`` additionally requires ``j >= i + (Lk - Lq) - window + 1``;
  ``softcap`` is ``cap * tanh(s / cap)``.
* Returns ``(out, lse)``; rows with no visible key give ``out = 0`` and
  ``lse = NEG_INF``.

``attention_bwd_ref`` is the dense backward given the global ``(out,
lse)``; ``combine_attention`` / ``combine_pair`` merge partial results by
their lse (the ring's update rule).  The q-chunked ``flashref`` oracles
are ROADMAP queue 1, item 6's remainder.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class BandMask(NamedTuple):
    """Piecewise-affine logical-position mask.

    Physical row ``r`` of the Q chunk has logical position ``r + q_off_lo``
    when ``r < q_seg`` else ``r + q_off_hi`` (K columns likewise with
    ``k_*``); ``seg == 0`` means unsplit.  Logical positions must be
    nondecreasing in the physical index.  Offsets are ints, or ``(B,)``
    tensors for per-request (ragged) offsets on the ref path.
    """
    q_off_lo: int | torch.Tensor
    q_off_hi: int | torch.Tensor
    k_off_lo: int | torch.Tensor
    k_off_hi: int | torch.Tensor
    q_seg: int
    k_seg: int

    @classmethod
    def uniform(cls, offset) -> "BandMask":
        """``kj <= qi + offset`` (and the window band), both sides unsplit."""
        return cls(offset, offset, 0, 0, 0, 0)

    @classmethod
    def zigzag(cls, i, j, c: int, cp: int) -> "BandMask":
        """Local q owns logical chunks ``(i, 2cp-1-i)`` of size ``c``; the
        visiting kv owns ``(j, 2cp-1-j)``."""
        return cls(i * c, (2 * cp - 2 - i) * c,
                   j * c, (2 * cp - 2 - j) * c, c, c)

    def shift_q(self, q0: int) -> "BandMask":
        """The band as seen by a q sub-chunk starting at physical ``q0``."""
        return self._replace(q_off_lo=self.q_off_lo + q0,
                             q_off_hi=self.q_off_hi + q0,
                             q_seg=max(self.q_seg - q0, 0))


def _per_batch(x):
    """Lift a per-request ``(B,)`` tensor to broadcast against ``(Lq, Lk)``
    index grids (masks become ``(B, Lq, Lk)``); scalars pass through."""
    if isinstance(x, torch.Tensor) and x.ndim >= 1:
        return x.reshape(x.shape[0], 1, 1)
    return x


def _logical_pos(idx, off_lo, off_hi, seg: int):
    def lift(x):
        x = _per_batch(x)
        return x.to(idx.device) if isinstance(x, torch.Tensor) else x

    off_lo, off_hi = lift(off_lo), lift(off_hi)
    if seg == 0:
        return idx + off_hi
    return idx + torch.where(idx < seg, off_lo, off_hi)


def _build_mask(lq: int, lk: int, *, causal: bool, window: int | None,
                kv_valid_len=None, kv_start=None, mask_offset=None,
                band: BandMask | None = None, q_doc_start=None,
                device=None) -> torch.Tensor | None:
    """Boolean ``(Lq, Lk)`` visibility mask, ``(B, Lq, Lk)`` for
    per-request offsets, or None when everything is visible.

    ``mask_offset`` overrides the bottom-right delta ``lk - lq``; ``band``
    generalises it and takes precedence.  ``kv_valid_len`` / ``kv_start``
    bound the visible physical key range ``[kv_start, kv_valid_len)``.
    ``q_doc_start`` (``(Lq,)`` or ``(B, Lq)``) masks keys below each row's
    document start (packed documents; requires ``causal``).
    """
    if band is not None and not causal and window is None:
        raise ValueError("band only shifts the causal/window band anchors; "
                         "passing one with causal=False and window=None "
                         "would be silently ignored")
    if q_doc_start is not None and not causal:
        raise ValueError("q_doc_start (packed block-causal masking) "
                         "requires causal=True")
    if not causal and window is None and kv_valid_len is None \
            and kv_start is None:
        return None
    if band is None:
        band = BandMask.uniform((lk - lq) if mask_offset is None
                                else mask_offset)
    qi = torch.arange(lq, device=device)[:, None]
    kj = torch.arange(lk, device=device)[None, :]
    q_log = _logical_pos(qi, band.q_off_lo, band.q_off_hi, band.q_seg)
    k_log = _logical_pos(kj, band.k_off_lo, band.k_off_hi, band.k_seg)
    mask = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_log <= q_log)
    if q_doc_start is not None:
        doc = torch.as_tensor(q_doc_start, dtype=torch.int32, device=device)
        mask = mask & (k_log >= doc[..., :, None])
    if window is not None:
        mask = mask & (k_log >= q_log - (window - 1))
    if kv_valid_len is not None:
        mask = mask & (kj < _per_batch(kv_valid_len))
    if kv_start is not None:
        mask = mask & (kj >= _per_batch(kv_start))
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: int | None = None,
                  softcap: float = 0.0, scale: float | None = None,
                  kv_valid_len=None, kv_start=None, mask_offset=None,
                  band: BandMask | None = None, q_doc_start=None):
    """Dense attention with fp32 reductions.  Returns ``(out, lse)``:
    out ``(B, Lq, Hq, D)`` in q's dtype, lse ``(B, Hq, Lq)`` fp32.

    As in the JAX oracle, the probabilities are rounded to the input dtype
    before the PV product (the bf16 stand-in for a kernel that keeps them
    on chip); fp32 inputs keep full fp32 math."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = hq // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    sdt = q.dtype if q.dtype != torch.float64 else torch.float32
    s = torch.einsum("bihd,bjhd->bihj", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = _build_mask(lq, lk, causal=causal, window=window,
                       kv_valid_len=kv_valid_len, kv_start=kv_start,
                       mask_offset=mask_offset, band=band,
                       q_doc_start=q_doc_start, device=q.device)
    if mask is not None:
        # s is (B, Lq, H, Lk): lift (Lq, Lk) or per-request (B, Lq, Lk).
        mask_s = mask[None, :, None] if mask.ndim == 2 else mask[:, :, None]
        s = torch.where(mask_s, s, NEG_INF)
    m = s.amax(dim=-1)                                    # (B, Lq, H)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None]).to(sdt)
    if mask is not None:
        p = torch.where(mask_s, p, 0)
    l = p.float().sum(dim=-1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bihj,bjhd->bihd", p.float(), v.float())
    out = out / l_safe[..., None]
    lse = torch.where(l == 0.0, NEG_INF, m_safe + torch.log(l_safe))
    return out.to(q.dtype), lse.permute(0, 2, 1).contiguous()


def attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = False,
                      window: int | None = None, softcap: float = 0.0,
                      scale: float | None = None, kv_valid_len=None,
                      kv_start=None, mask_offset=None,
                      band: BandMask | None = None, q_doc_start=None):
    """Chunk-level attention backward given the *global* ``(out, lse)``.

    The ring backward's building block: ``out``/``lse`` are the combined
    values over every KV chunk, ``k``/``v`` one visiting chunk; ``dk``/``dv``
    are that chunk's contributions and ``dq`` the partial dq.  Shapes:
    q/out/do ``(B, Lq, Hq, D)``, k/v ``(B, Lk, Hkv, D)``, lse
    ``(B, Hq, Lq)``.  Returns ``(dq, dk, dv)`` in the input dtypes."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    qf, dof, outf = q.float(), do.float(), out.float()
    s_raw = torch.einsum("bihd,bjhd->bhij", qf, kf) * scale
    s = softcap * torch.tanh(s_raw / softcap) if softcap else s_raw
    mask = _build_mask(lq, lk, causal=causal, window=window,
                       kv_valid_len=kv_valid_len, kv_start=kv_start,
                       mask_offset=mask_offset, band=band,
                       q_doc_start=q_doc_start, device=q.device)
    shift = torch.where(lse <= NEG_INF / 2, 0.0, lse)        # (B, H, Lq)
    p = torch.exp(s - shift[..., None])
    if mask is not None:
        # s is (B, H, Lq, Lk) here.
        mask_s = mask[None, None] if mask.ndim == 2 else mask[:, None]
        p = torch.where(mask_s, p, 0.0)
    dsum = (dof * outf).sum(dim=-1).permute(0, 2, 1)         # (B, H, Lq)
    dp = torch.einsum("bihd,bjhd->bhij", dof, vf)
    ds = p * (dp - dsum[..., None])
    if softcap:
        ds = ds * (1.0 - (s / softcap) ** 2)
    ds = ds * scale
    dq = torch.einsum("bhij,bjhd->bihd", ds, kf)
    dk = torch.einsum("bhij,bihd->bjhd", ds, qf)
    dv = torch.einsum("bhij,bihd->bjhd", p, dof)
    dk = dk.reshape(b, lk, hkv, group, d).sum(dim=3)
    dv = dv.reshape(b, lk, hkv, group, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def combine_attention(parts):
    """LSE-weighted combine of partial attention results.

    ``parts``: iterable of ``(out, lse)`` with out ``(B, L, H, D)`` and lse
    ``(B, H, L)``, each the softmax-normalised attention over a disjoint
    subset of keys with its logsumexp.  Returns the attention over the
    union, in the first part's dtype, and its lse: the update rule of ring
    attention and flash-decoding."""
    parts = list(parts)
    outs = torch.stack([p[0].float() for p in parts])          # (N,B,L,H,D)
    lses = torch.stack([p[1] for p in parts])                  # (N,B,H,L)
    m = lses.max(dim=0).values
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    w = torch.exp(lses - m_safe[None])
    w = torch.where(lses <= NEG_INF / 2, 0.0, w)
    denom = w.sum(dim=0)                                       # (B,H,L)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    w_o = w.permute(0, 1, 3, 2)[..., None]                     # (N,B,L,H,1)
    out = (outs * w_o).sum(dim=0) / denom_safe.permute(0, 2, 1)[..., None]
    lse = torch.where(denom == 0.0, NEG_INF, m_safe + torch.log(denom_safe))
    return out.to(parts[0][0].dtype), lse


def combine_pair(out_a, lse_a, out_b, lse_b):
    """Two-way combine (the in-loop ring update)."""
    return combine_attention([(out_a, lse_a), (out_b, lse_b)])
