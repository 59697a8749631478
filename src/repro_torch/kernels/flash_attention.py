"""Flash attention in the folded layout: the CUDA kernels' wrappers and
their plain PyTorch versions.

Counterpart of ``src/repro/kernels/flash_attention.py::_fwd`` and ``_bwd``.
The kernels replace the Pallas TPU kernels, each by two routes chosen from
the dtype and head dim alone: bf16 at D 64 or 128 runs on the tensor cores
(``"sm90"``), fp32 (full fp32 math) and narrower bf16 on fp32 FMA
(``"fma"``).  The forward ``_fwd_kernel``: ``csrc/flash_fwd_sm90.cu`` or
``csrc/flash_fwd.cu`` (``fwd_route``); the backward ``_dq_kernel`` and
``_dkv_kernel``: ``csrc/flash_bwd_sm90.cu`` or ``csrc/flash_bwd.cu``
(``bwd_route``).  Each source's header says what bounds it on an H100 and
what its design does about that.

``_fwd`` and ``_bwd`` launch the kernels for CUDA tensors and use
``_fwd_plain`` / ``_bwd_plain`` only for tensors that lie on the CPU.
``FWD_LAUNCHES``, ``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` count kernel launches
(never plain calls), so a run can show that its main path went through the
kernels; ``FWD_SM90_LAUNCHES`` / ``FWD_FMA_LAUNCHES``,
``DQ_SM90_LAUNCHES`` / ``DQ_FMA_LAUNCHES`` and ``DKV_SM90_LAUNCHES`` /
``DKV_FMA_LAUNCHES`` split them by route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import NEG_INF, _logical_pos

#: Kernel launches since import (or since a caller last reset them).
FWD_LAUNCHES = 0
FWD_SM90_LAUNCHES = 0
FWD_FMA_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
DQ_SM90_LAUNCHES = 0
DKV_SM90_LAUNCHES = 0
DQ_FMA_LAUNCHES = 0
DKV_FMA_LAUNCHES = 0

#: Head dims the kernel is compiled for; ``ops`` zero-pads D up to one.
KERNEL_D = (16, 32, 64, 128)
#: Head dims the bf16 tensor-core forward and backward kernels are built for.
SM90_FWD_D = (64, 128)
SM90_BWD_D = (64, 128)


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel a CUDA call launches: ``"sm90"``
    (``csrc/flash_fwd_sm90.cu``) for bf16 at a head dim in ``SM90_FWD_D``,
    else ``"fma"`` (``csrc/flash_fwd.cu``, whose fp32 route keeps full fp32
    math)."""
    return "sm90" if dtype == torch.bfloat16 and d in SM90_FWD_D else "fma"


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernels a CUDA call launches: ``"sm90"``
    (``csrc/flash_bwd_sm90.cu``) for bf16 at a head dim in ``SM90_BWD_D``,
    else ``"fma"`` (``csrc/flash_bwd.cu``, whose fp32 route keeps full fp32
    math: the tensor cores have no full-fp32 mode)."""
    return "sm90" if dtype == torch.bfloat16 and d in SM90_BWD_D else "fma"


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


def _plain_mask(p: FlashParams, band, doc, bh: int, lq: int, lk: int,
                device):
    """The kernels' visibility mask, ``(1 or B*Hq, Lq, Lk)`` bool."""
    qi = torch.arange(lq, device=device)[:, None]
    kj = torch.arange(lk, device=device)[None, :]
    mask = (kj < band[4]).expand(lq, lk)[None]                 # (1, Lq, Lk)
    if p.causal or p.window is not None:
        q_log = _logical_pos(qi, band[0], band[1], p.q_seg)
        k_log = _logical_pos(kj, band[2], band[3], p.k_seg)
        if p.causal:
            mask = mask & (k_log <= q_log)
        if p.packed:
            rows = doc.to(device).repeat_interleave(bh // doc.shape[0],
                                                    dim=0)
            mask = mask & (k_log[None] >= rows[:, :, None])
        if p.window is not None:
            mask = mask & (k_log >= q_log - (p.window - 1))
    return mask


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
    mask = _plain_mask(p, band, doc, bh, lq, lk, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    shift = torch.where(m <= NEG_INF / 2, 0.0, m)
    pmat = torch.where(mask, torch.exp(s - shift[..., None]), 0.0)
    l = pmat.sum(dim=-1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bqk,bkd->bqd", pmat, vf) / l_safe[..., None]
    lse = torch.where(l == 0.0, NEG_INF, shift + torch.log(l_safe))
    return out.to(q.dtype), lse


def _fwd_signatures(lib: ctypes.CDLL, fn: str) -> ctypes.CDLL:
    """Declare the C signatures of a forward library's ``fn`` and
    ``fn_error_string`` (both forward sources take the same arguments)."""
    getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, fn).argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
                                 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p])
    getattr(lib, f"{fn}_error_string").restype = ctypes.c_char_p
    getattr(lib, f"{fn}_error_string").argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    """The built ``flash_fwd`` library (the FMA route)."""
    from repro_torch.kernels import build

    return _fwd_signatures(build.load("flash_fwd"), "flash_fwd")


@functools.cache
def _fwd_sm90_lib() -> ctypes.CDLL:
    """The built ``flash_fwd_sm90`` library (the tensor-core route)."""
    from repro_torch.kernels import build

    return _fwd_signatures(build.load("flash_fwd_sm90"), "flash_fwd_sm90")


def _check_operands(name, q, k, v, p: FlashParams, doc):
    """Validate the kernels' operands; returns ``(doc pointer, doc rows)``."""
    bh, lq, d = q.shape
    bhkv, lk, dk = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes fp32 or bf16, got {q.dtype}")
    for tname, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{tname} must match q's dtype and device")
    if v.shape != k.shape or dk != d:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not fit")
    if d not in KERNEL_D:
        raise ValueError(f"kernel head dim must be one of {KERNEL_D}, got {d}")
    if bh % bhkv:
        raise ValueError(f"B*Hq={bh} is not a multiple of B*Hkv={bhkv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not p.packed:
        return None, 0
    if (doc.dtype != torch.int32 or doc.device != q.device
            or not doc.is_contiguous() or doc.shape[1] != lq
            or bh % doc.shape[0]):
        raise ValueError("doc must be a contiguous (B, Lq) int32 tensor "
                         "on q's device")
    return doc.data_ptr(), doc.shape[0]


def _mask_args(p: FlashParams, band) -> tuple:
    """The mask's launch arguments, shared by every kernel: the five band
    ints, q_seg, k_seg, causal, window (-1: none), softcap, scale, packed,
    doc_skip."""
    return (*band, p.q_seg, p.k_seg, int(p.causal),
            -1 if p.window is None else int(p.window), float(p.softcap),
            float(p.scale), int(p.packed), int(p.doc_skip))


def _fwd_cuda(q, k, v, p: FlashParams, band, doc):
    """The forward kernel of ``fwd_route``'s route; raises if it does not
    launch."""
    global FWD_LAUNCHES, FWD_SM90_LAUNCHES, FWD_FMA_LAUNCHES
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    doc_ptr, doc_rows = _check_operands("flash_fwd", q, k, v, p, doc)
    route = fwd_route(q.dtype, d)
    if route == "sm90":
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the sm90 forward kernel needs 16-byte "
                             "aligned q, k and v (k and v come by TMA)")
        lib, fn = _fwd_sm90_lib(), "flash_fwd_sm90"
    else:
        lib, fn = _fwd_lib(), "flash_fwd"
    out = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), doc_ptr, int(q.dtype == torch.bfloat16), bh, bhkv,
        lq, lk, d, *_mask_args(p, band), doc_rows,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = getattr(lib, f"{fn}_error_string")(err).decode()
        raise RuntimeError(f"{fn} ({route}) launch failed: {msg} ({err})")
    FWD_LAUNCHES += 1
    if route == "sm90":
        FWD_SM90_LAUNCHES += 1
    else:
        FWD_FMA_LAUNCHES += 1
    return out, lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _bwd(q, k, v, out, lse, do, p: FlashParams, band=None, doc=None):
    """Backward in the folded layout given the global ``(out, lse)``:
    q/out/do ``(B*Hq, Lq, D)``, k/v ``(B*Hkv, Lk, D)``, lse ``(B*Hq, Lq)``
    fp32.  Returns ``(dq, dk, dv)``: dq in q's dtype, dk/dv at the KV head
    count in k's dtype, summed over each KV head's query group.

    ``dsum = rowsum(dO * O)`` is a torch op in fp32, as it is a jnp op
    outside the Pallas kernels in the reference.  CUDA tensors launch the
    dq and dk/dv kernels; CPU tensors take ``_bwd_plain``."""
    if (doc is not None) != p.packed:
        raise ValueError("doc must be given exactly when p.packed is set")
    band = _default_band(p) if band is None else _band_ints(band)
    if q.device.type == "cuda":
        dsum = (do.float() * out.float()).sum(dim=-1)
        return _bwd_cuda(q, k, v, do, lse, dsum, p, band, doc)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, out, lse, do, p, band, doc)
    raise ValueError(f"no flash backward for device {q.device}")


def _bwd_plain(q, k, v, out, lse, do, p: FlashParams, band=None, doc=None):
    """The kernels' function in dense PyTorch, fp32 inside: the same folded
    layout, band, doc table and dtypes."""
    band = _default_band(p) if band is None else _band_ints(band)
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    group = bh // bhkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    dsum = (dof * out.float()).sum(dim=-1)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * p.scale
    if p.softcap:
        s = p.softcap * torch.tanh(s / p.softcap)
    mask = _plain_mask(p, band, doc, bh, lq, lk, q.device)
    shift = torch.where(lse <= NEG_INF / 2, 0.0, lse)
    pmat = torch.where(mask, torch.exp(s - shift[..., None]), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = pmat * (dp - dsum[..., None])
    if p.softcap:
        ds = ds * (1.0 - (s / p.softcap) ** 2)
    ds = ds * p.scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    dv = torch.einsum("bqk,bqd->bkd", pmat, dof)
    dk = dk.reshape(bhkv, group, lk, d).sum(dim=1)
    dv = dv.reshape(bhkv, group, lk, d).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The built ``flash_bwd`` library with its C signatures declared."""
    from repro_torch.kernels import build

    lib = build.load("flash_bwd")
    tail = ([ctypes.c_int] * 15 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
    lib.flash_bwd_dq.restype = ctypes.c_int
    lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.flash_bwd_dkv.restype = ctypes.c_int
    lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _bwd_sm90_lib() -> ctypes.CDLL:
    """The built ``flash_bwd_sm90`` library with its C signatures declared
    (the same arguments as ``flash_bwd``'s)."""
    from repro_torch.kernels import build

    lib = build.load("flash_bwd_sm90")
    tail = ([ctypes.c_int] * 15 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
    lib.flash_bwd_dq_sm90.restype = ctypes.c_int
    lib.flash_bwd_dq_sm90.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.flash_bwd_dkv_sm90.restype = ctypes.c_int
    lib.flash_bwd_dkv_sm90.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.flash_bwd_sm90_error_string.restype = ctypes.c_char_p
    lib.flash_bwd_sm90_error_string.argtypes = [ctypes.c_int]
    return lib


def _bwd_cuda(q, k, v, do, lse, dsum, p: FlashParams, band, doc):
    """Both backward kernels: ``(dq, dk, dv)``."""
    return (_dq_cuda(q, k, v, do, lse, dsum, p, band, doc),
            *_dkv_cuda(q, k, v, do, lse, dsum, p, band, doc))


def _bwd_launch_args(q, k, v, do, lse, dsum, p: FlashParams, band, doc):
    """(leading pointers, trailing arguments) shared by the two kernels."""
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    doc_ptr, doc_rows = _check_operands("flash_bwd", q, k, v, p, doc)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("do must be contiguous with q's shape and dtype")
    for name, t in (("lse", lse), ("dsum", dsum)):
        if (t.shape != (bh, lq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (B*Hq, Lq) fp32 "
                             "tensor on q's device")
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr())
    tail = (doc_ptr, int(q.dtype == torch.bfloat16), bh, bhkv, lq, lk, d,
            *_mask_args(p, band), doc_rows,
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail


def _launch_bwd(which: str, q, head, outs, tail) -> str:
    """Launch the dq (``which="dq"``) or dk/dv (``"dkv"``) kernel of
    ``q``'s route; raises if it does not launch.  Returns the route."""
    route = bwd_route(q.dtype, q.shape[2])
    if route == "sm90":
        if any(ptr % 16 for ptr in head[:4]):
            raise ValueError("the sm90 backward kernels read q, k, v and do "
                             "by TMA, which needs 16-byte aligned pointers")
        lib = _bwd_sm90_lib()
        fn = getattr(lib, f"flash_bwd_{which}_sm90")
        error_string = lib.flash_bwd_sm90_error_string
    else:
        lib = _bwd_lib()
        fn = getattr(lib, f"flash_bwd_{which}")
        error_string = lib.flash_bwd_error_string
    err = fn(*head, *(t.data_ptr() for t in outs), *tail)
    if err != 0:
        raise RuntimeError(f"flash_bwd_{which} ({route}) launch failed: "
                           f"{error_string(err).decode()} ({err})")
    return route


def _dq_cuda(q, k, v, do, lse, dsum, p: FlashParams, band, doc):
    """The dq kernel: dq in q's dtype."""
    global DQ_LAUNCHES, DQ_SM90_LAUNCHES, DQ_FMA_LAUNCHES
    head, tail = _bwd_launch_args(q, k, v, do, lse, dsum, p, band, doc)
    dq = torch.empty_like(q)
    route = _launch_bwd("dq", q, head, (dq,), tail)
    DQ_LAUNCHES += 1
    if route == "sm90":
        DQ_SM90_LAUNCHES += 1
    else:
        DQ_FMA_LAUNCHES += 1
    return dq


def _dkv_cuda(q, k, v, do, lse, dsum, p: FlashParams, band, doc):
    """The dk/dv kernel: ``(dk, dv)`` in k's dtype, group-summed."""
    global DKV_LAUNCHES, DKV_SM90_LAUNCHES, DKV_FMA_LAUNCHES
    head, tail = _bwd_launch_args(q, k, v, do, lse, dsum, p, band, doc)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route = _launch_bwd("dkv", q, head, (dk, dv), tail)
    DKV_LAUNCHES += 1
    if route == "sm90":
        DKV_SM90_LAUNCHES += 1
    else:
        DKV_FMA_LAUNCHES += 1
    return dk, dv
