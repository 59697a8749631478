"""Flash-attention forward in the folded layout: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``src/repro/kernels/flash_attention.py::_fwd``.  The kernel
(``csrc/flash_fwd.cu``) replaces the Pallas TPU kernel ``_fwd_kernel``; its
header says what bounds it on an H100 and what its design does about that.

``_fwd`` launches the kernel for CUDA tensors and uses ``_fwd_plain`` only
for tensors that lie on the CPU.  ``FWD_LAUNCHES`` counts kernel launches
(never plain calls), so a run can show that its main path went through the
kernel.  The backward kernels (``_dq_kernel``, ``_dkv_kernel``) belong to the
training slice.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import NEG_INF, _logical_pos

#: Kernel launches since import (or since a caller last reset it).
FWD_LAUNCHES = 0

#: Head dims the kernel is compiled for; ``ops`` zero-pads D up to one.
KERNEL_D = (16, 32, 64, 128)


class FlashParams(NamedTuple):
    """Static configuration of one forward call."""
    causal: bool
    window: int | None
    softcap: float
    scale: float
    lk_valid: int          # attendable keys (kv_valid_len cut, else Lk)
    q_seg: int = 0         # physical row where the q hi-offset segment starts
    k_seg: int = 0         # (0 => unsplit: every row uses the hi offset)
    delta: int = 0         # default causal anchor: full Lk - Lq (kv_valid
                           # only cuts keys, it does not re-anchor)
    packed: bool = False   # a per-q-row doc-start table masks keys before
                           # each row's document start
    doc_skip: bool = True  # skip K tiles entirely below the q tile's first
                           # doc start (False: mask in-tile only)


def _default_band(p: FlashParams) -> tuple[int, int, int, int, int]:
    """Band scalars for the classic bottom-right-aligned static mask."""
    return (p.delta, p.delta, 0, 0, p.lk_valid)


def _band_ints(band) -> tuple[int, int, int, int, int]:
    band = tuple(int(x) for x in band)
    if len(band) != 5:
        raise ValueError(f"band must hold 5 ints, got {band}")
    return band


def _fwd(q, k, v, p: FlashParams, band=None, doc=None):
    """q ``(B*Hq, Lq, D)``; k/v ``(B*Hkv, Lk, D)``, heads folded
    major-to-minor (GQA: kv row = q row // group).  ``band``: the five ints
    ``[q_off_lo, q_off_hi, k_off_lo, k_off_hi, kv_valid]`` (default: the
    static bottom-right band).  ``doc``: ``(B, Lq)`` int32 per-row doc-start
    table, given iff ``p.packed``.  Returns out ``(B*Hq, Lq, D)`` in q's
    dtype and lse ``(B*Hq, Lq)`` fp32.

    CUDA tensors launch the kernel; CPU tensors take ``_fwd_plain``."""
    if (doc is not None) != p.packed:
        raise ValueError("doc must be given exactly when p.packed is set")
    band = _default_band(p) if band is None else _band_ints(band)
    if q.device.type == "cuda":
        return _fwd_cuda(q, k, v, p, band, doc)
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, p, band, doc)
    raise ValueError(f"no flash forward for device {q.device}")


def _fwd_plain(q, k, v, p: FlashParams, band=None, doc=None):
    """The kernel's function in dense PyTorch, fp32 inside: the same folded
    layout, band, doc table, ``(out, lse)`` and dtypes."""
    band = _default_band(p) if band is None else _band_ints(band)
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    group = bh // bhkv
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kf) * p.scale
    if p.softcap:
        s = p.softcap * torch.tanh(s / p.softcap)
    qi = torch.arange(lq, device=q.device)[:, None]
    kj = torch.arange(lk, device=q.device)[None, :]
    mask = (kj < band[4]).expand(lq, lk)[None]                 # (1, Lq, Lk)
    if p.causal or p.window is not None:
        q_log = _logical_pos(qi, band[0], band[1], p.q_seg)
        k_log = _logical_pos(kj, band[2], band[3], p.k_seg)
        if p.causal:
            mask = mask & (k_log <= q_log)
        if p.packed:
            rows = doc.to(q.device).repeat_interleave(bh // doc.shape[0],
                                                      dim=0)
            mask = mask & (k_log[None] >= rows[:, :, None])
        if p.window is not None:
            mask = mask & (k_log >= q_log - (p.window - 1))
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    shift = torch.where(m <= NEG_INF / 2, 0.0, m)
    pmat = torch.where(mask, torch.exp(s - shift[..., None]), 0.0)
    l = pmat.sum(dim=-1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bqk,bkd->bqd", pmat, vf) / l_safe[..., None]
    lse = torch.where(l == 0.0, NEG_INF, shift + torch.log(l_safe))
    return out.to(q.dtype), lse


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The built ``flash_fwd`` library with its C signatures declared."""
    from repro_torch.kernels import build

    lib = build.load("flash_fwd")
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
                              + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                              + [ctypes.c_void_p])
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    return lib


def _fwd_cuda(q, k, v, p: FlashParams, band, doc):
    global FWD_LAUNCHES
    bh, lq, d = q.shape
    bhkv, lk, dk = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_fwd takes fp32 or bf16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} must match q's dtype and device")
    if v.shape != k.shape or dk != d:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not fit")
    if d not in KERNEL_D:
        raise ValueError(f"kernel head dim must be one of {KERNEL_D}, got {d}")
    if bh % bhkv:
        raise ValueError(f"B*Hq={bh} is not a multiple of B*Hkv={bhkv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    doc_ptr, doc_rows = None, 0
    if p.packed:
        if (doc.dtype != torch.int32 or doc.device != q.device
                or not doc.is_contiguous() or doc.shape[1] != lq
                or bh % doc.shape[0]):
            raise ValueError("doc must be a contiguous (B, Lq) int32 tensor "
                             "on q's device")
        doc_ptr, doc_rows = doc.data_ptr(), doc.shape[0]
    out = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), doc_ptr, int(q.dtype == torch.bfloat16),
             bh, bhkv, lq, lk, d, *band, p.q_seg, p.k_seg, int(p.causal),
             -1 if p.window is None else int(p.window), float(p.softcap),
             float(p.scale), int(p.packed), int(p.doc_skip), doc_rows,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} ({err})")
    FWD_LAUNCHES += 1
    return out, lse
