"""Public attention ops: impl dispatch, layout and padding plumbing
(counterpart of ``src/repro/kernels/ops.py``).

Layout everywhere: ``q (B, Lq, Hq, D)``, ``k/v (B, Lk, Hkv, D)``.

================== =========================================================
``impl``           what runs
================== =========================================================
``"auto"``         ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU tensors.
``"cuda"``         the hand-written kernels on CUDA tensors (the forward
                   on ``csrc/flash_fwd_sm90.cu`` or ``csrc/flash_fwd.cu``,
                   as ``fwd_route`` picks; the backward on
                   ``csrc/flash_bwd_sm90.cu`` or ``csrc/flash_bwd.cu``, as
                   ``bwd_route`` picks); raises for tensors elsewhere.
``"plain"``        the same kernel path (fold, ``_FlashFolded``, unfold)
                   with each kernel's plain version, for CPU tensors only;
                   the counterpart of the reference's
                   ``"pallas_interpret"``.  Raises for CUDA tensors.
``"ref"``          the dense PyTorch oracle (``ref.attention_ref`` /
                   ``ref.attention_bwd_ref``).
================== =========================================================

``mask_offset`` sets the bottom-right band ``kj <= qi + mask_offset``;
``band`` (a ``ref.BandMask``) generalises it to the segmented zigzag layout.
Per-request ``(B,)`` offsets (``mask_offset`` / ``kv_valid_len`` /
``kv_start``, the ragged decode case) run on the ref path only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels.flash_attention import (KERNEL_D, FlashParams,
                                                _bwd, _fwd)
from repro_torch.kernels.ref import BandMask

NEG_INF = ref_mod.NEG_INF

IMPLS = ("auto", "cuda", "plain", "ref")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``"auto"`` -> ``"cuda"`` for CUDA tensors, ``"ref"`` otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if x.device.type == "cuda" else "ref"
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {x.device}")
    if impl == "plain" and x.device.type != "cpu":
        raise ValueError(f"impl='plain' runs on CPU tensors, got {x.device}")
    return impl


def _d_pad(d: int) -> int:
    """Zero-pad the head dim to the next size the kernel is built for."""
    for size in KERNEL_D:
        if d <= size:
            return size
    raise NotImplementedError(
        f"head_dim {d} > {KERNEL_D[-1]}: the forward kernel is built for "
        f"D <= {KERNEL_D[-1]} (ROADMAP queue 2)")


def _fold_pad(x, d_pad: int):
    """(B, L, H, D) -> contiguous (B*H, L, D_pad), D zero padded.  L stays
    as it is: the kernel masks the ragged edges of its tiles itself."""
    b, l, h, d = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b * h, l, d)
    if d_pad != d:
        x = torch.nn.functional.pad(x, (0, d_pad - d))
    return x.contiguous()


def _unfold(x, b: int, h: int, l: int, d: int):
    """(B*H, L, D_pad) -> (B, L, H, D)."""
    x = x[:, :, :d].reshape(b, h, l, d)
    return x.permute(0, 2, 1, 3)


def _make_params(q, k, *, causal, window, softcap, scale,
                 q_seg=0, k_seg=0, packed=False, doc_skip=True):
    """``kv_valid`` travels in the band ints, so ``lk_valid`` is the full
    key length."""
    _, lq, _, d = q.shape
    _, lk, _, _ = k.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    return FlashParams(causal=causal, window=window, softcap=float(softcap),
                       scale=float(scale), lk_valid=int(lk),
                       q_seg=int(q_seg), k_seg=int(k_seg),
                       delta=int(lk - lq), packed=bool(packed),
                       doc_skip=bool(doc_skip))


def _doc_table(q_doc_start, lq: int, device):
    """The contiguous (B, Lq) int32 doc-start table."""
    doc = torch.as_tensor(q_doc_start, dtype=torch.int32, device=device)
    if doc.ndim != 2 or doc.shape[1] != lq:
        raise ValueError(f"q_doc_start must be (B, {lq}), got "
                         f"{tuple(doc.shape)}")
    return doc.contiguous()


def _band_scalars(band, mask_offset, lq: int, lk: int, kv_valid_len, *,
                  causal, window):
    """((5,) band ints, q_seg, k_seg).

    Offsets are in physical row coordinates.
    """
    if band is not None and not causal and window is None:
        raise ValueError("band only shifts the causal/window band anchors; "
                         "passing one with causal=False and window=None "
                         "would be silently ignored")
    if band is None:
        off = (lk - lq) if mask_offset is None else mask_offset
        band = BandMask.uniform(off)
    kv_valid = lk if kv_valid_len is None else kv_valid_len
    scalars = tuple(int(x) for x in (band.q_off_lo, band.q_off_hi,
                                     band.k_off_lo, band.k_off_hi, kv_valid))
    return scalars, band.q_seg, band.k_seg


class _FlashFolded(torch.autograd.Function):
    """The kernels behind autograd (the reference's ``_flash_folded`` /
    ``_flash_folded_doc`` custom VJPs): the forward kernel, then the dq and
    dk/dv kernels from the saved ``q, k, v, out, lse``.  The doc table is
    integer data and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, doc, p: FlashParams, band):
        out, lse = _fwd(q, k, v, p, band=band, doc=doc)
        ctx.save_for_backward(q, k, v, out, lse, doc)
        ctx.p, ctx.band = p, band
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, doc = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, do.contiguous(), ctx.p,
                          band=ctx.band, doc=doc)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    window: int | None = None, softcap: float = 0.0,
                    scale: float | None = None,
                    kv_valid_len: int | None = None,
                    q_doc_start=None, doc_skip: bool = True,
                    impl: str = "auto"):
    """Attention, ``(B, Lq, Hq, D)`` out.  ``q_doc_start``: packed-document
    masking, a ``(B, Lq)`` int32 table of each q row's document start
    (requires ``causal``)."""
    impl = resolve_impl(impl, q)
    if q_doc_start is not None and not causal:
        raise ValueError("q_doc_start requires causal=True")
    if impl == "ref":
        out, _ = ref_mod.attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, kv_valid_len=kv_valid_len, q_doc_start=q_doc_start)
        return out
    b, lq, hq, d = q.shape
    qf, kf, vf, p, band, doc = _fold_chunk_args(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
        kv_valid_len=kv_valid_len, q_doc_start=q_doc_start,
        doc_skip=doc_skip)
    out = _FlashFolded.apply(qf, kf, vf, doc, p, band)
    return _unfold(out, b, hq, lq, d)


def _is_ragged(x) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim >= 1


def flash_fwd_chunk(q, k, v, *, causal: bool = False,
                    window: int | None = None, softcap: float = 0.0,
                    scale: float | None = None,
                    kv_valid_len=None, kv_start=None,
                    mask_offset=None, band: BandMask | None = None,
                    q_doc_start=None, doc_skip: bool = True,
                    impl: str = "auto"):
    """Non-differentiable ``(out, lse)``: the ring / decode building block.

    out ``(B, Lq, Hq, D)``; lse ``(B, Hq, Lq)`` fp32.  Per-request ``(B,)``
    offsets and ``kv_start`` run on the ref path only."""
    impl = resolve_impl(impl, q)
    if q_doc_start is not None and not causal:
        raise ValueError("q_doc_start requires causal=True")
    if (kv_start is not None or any(map(_is_ragged, (mask_offset,
                                                     kv_valid_len)))) \
            and impl != "ref":
        raise NotImplementedError(
            "per-request ragged masks (kv_start / batched offsets) run on "
            f"the ref path only, got impl={impl!r}")
    if impl == "ref":
        return ref_mod.attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, kv_valid_len=kv_valid_len, kv_start=kv_start,
            mask_offset=mask_offset, band=band, q_doc_start=q_doc_start)
    return _fwd_chunk_folded(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale,
                             kv_valid_len=kv_valid_len,
                             mask_offset=mask_offset, band=band,
                             q_doc_start=q_doc_start, doc_skip=doc_skip)


def flash_bwd_chunk(q, k, v, out, lse, do, *, causal: bool = False,
                    window: int | None = None, softcap: float = 0.0,
                    scale: float | None = None, kv_valid_len=None,
                    mask_offset=None, band: BandMask | None = None,
                    q_doc_start=None, doc_skip: bool = True,
                    impl: str = "auto"):
    """Chunk backward given the global ``(out, lse)``: the ring building
    block.  Returns ``(dq, dk, dv)``; dk/dv are summed over each KV head's
    query group inside the dk/dv kernel, with no group-expanded K/V.
    Per-request ``(B,)`` offsets run on the ref path only."""
    impl = resolve_impl(impl, q)
    if q_doc_start is not None and not causal:
        raise ValueError("q_doc_start requires causal=True")
    if any(map(_is_ragged, (mask_offset, kv_valid_len))) and impl != "ref":
        raise NotImplementedError(
            "per-request ragged masks (batched offsets) run on the ref path "
            f"only, got impl={impl!r}")
    if impl == "ref":
        return ref_mod.attention_bwd_ref(
            q, k, v, out, lse, do, causal=causal, window=window,
            softcap=softcap, scale=scale, kv_valid_len=kv_valid_len,
            mask_offset=mask_offset, band=band, q_doc_start=q_doc_start)
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    qf, kf, vf, p, scalars, doc = _fold_chunk_args(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
        kv_valid_len=kv_valid_len, mask_offset=mask_offset, band=band,
        q_doc_start=q_doc_start, doc_skip=doc_skip)
    d_pad = qf.shape[2]
    outf, dof = _fold_pad(out, d_pad), _fold_pad(do, d_pad)
    lsef = lse.reshape(b * hq, lq).float().contiguous()
    dqf, dkf, dvf = _bwd(qf, kf, vf, outf, lsef, dof, p, band=scalars,
                         doc=doc)
    return (_unfold(dqf, b, hq, lq, d), _unfold(dkf, b, hkv, lk, d),
            _unfold(dvf, b, hkv, lk, d))


def _fwd_chunk_folded(q, k, v, **kw):
    """The kernel path of ``flash_fwd_chunk``: fold, ``_fwd``, unfold.
    ``_fwd`` takes its plain version for CPU tensors, so the CPU tests run
    this plumbing too."""
    b, lq, hq, d = q.shape
    qf, kf, vf, p, scalars, doc = _fold_chunk_args(q, k, v, **kw)
    out, lse = _fwd(qf, kf, vf, p, band=scalars, doc=doc)
    out = _unfold(out, b, hq, lq, d)
    lse = lse.reshape(b, hq, lq)
    return out, lse


def _fold_chunk_args(q, k, v, *, causal=False, window=None, softcap=0.0,
                     scale=None, kv_valid_len=None, mask_offset=None,
                     band=None, q_doc_start=None, doc_skip=True):
    """The folded operands of one ``_fwd`` call: ``(qf, kf, vf, params,
    band ints, doc)``."""
    lq, d = q.shape[1], q.shape[3]
    lk = k.shape[1]
    scalars, q_seg, k_seg = _band_scalars(band, mask_offset, lq, lk,
                                          kv_valid_len, causal=causal,
                                          window=window)
    p = _make_params(q, k, causal=causal, window=window, softcap=softcap,
                     scale=scale, q_seg=q_seg, k_seg=k_seg,
                     packed=q_doc_start is not None, doc_skip=doc_skip)
    d_pad = _d_pad(d)
    doc = None if q_doc_start is None else _doc_table(q_doc_start, lq,
                                                      q.device)
    return (_fold_pad(q, d_pad), _fold_pad(k, d_pad), _fold_pad(v, d_pad),
            p, scalars, doc)
