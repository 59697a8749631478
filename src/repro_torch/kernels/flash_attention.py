"""Flash attention in the folded layout: the CUDA kernels' wrappers and
their plain PyTorch versions.

Counterpart of ``src/repro/kernels/flash_attention.py::_fwd`` and ``_bwd``.
The kernels replace the Pallas TPU kernels, each by routes chosen from the
dtype and head dim alone.  The forward ``_fwd_kernel`` (``fwd_route``) runs
on the tensor cores in bf16 at every head dim: D 16 or 32 (``"sm90n"``,
``csrc/flash_fwd_sm90_narrow.cu``), D 64 or 128 (``"sm90"``,
``csrc/flash_fwd_sm90.cu``), D 192, 256 and 288 (``"sm90w"``,
``csrc/flash_fwd_sm90_wide.cu``) and D 384 (``"sm90w"``,
``csrc/flash_fwd_sm90_d384.cu``); fp32 runs on the tensor cores in three
TF32 passes, up to D 128 (``"tf32x3"``, ``csrc/flash_fwd_tf32x3.cu``: each
warp owns 16 q rows and all their O columns) and above it (``"tf32x3w"``,
``csrc/flash_fwd_tf32x3_wide.cu``: each warp owns a column slice of O).
The backward ``_dq_kernel`` and
``_dkv_kernel`` (``bwd_route``, one route for each): bf16 at D 16 or 32 on
the tensor cores (``"sm90n"``, ``csrc/flash_bwd_sm90_narrow.cu``); bf16 at
D 64 or 128 on the tensor cores (``"sm90"``, ``csrc/flash_bwd_sm90.cu``);
bf16 at D 192, 256 and 288 on the tensor cores (``"sm90w"``: dq in
``csrc/flash_dq_sm90_wide.cu``, dk/dv in ``csrc/flash_dkv_sm90_wide.cu``)
and at D 384 (``"sm90w"``, both in ``csrc/flash_bwd_sm90_d384.cu``); fp32
at D up to 128 on the tensor cores in three TF32 passes (``"tf32x3"``,
``csrc/flash_bwd_tf32x3.cu``: each operand split into a TF32 hi and lo,
each product hi.lo + lo.hi + hi.hi, about 21 of fp32's 24 mantissa bits)
and above D 128 the same way (``"tf32x3w"``,
``csrc/flash_bwd_tf32x3_wide.cu``: each warp owns a column slice of the
outputs).  So every kernel runs on the tensor cores at every head dim and
dtype, and an fp32 route name (``"tf32x3"``, ``"tf32x3w"``) means one
numerics forward and backward.  Each source's header says what bounds it
on an H100 and what its design does about that.

``_fwd`` and ``_bwd`` launch the kernels for CUDA tensors and use
``_fwd_plain`` / ``_bwd_plain`` only for tensors that lie on the CPU.
``FWD_LAUNCHES``, ``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` count kernel launches
(never plain calls), so a run can show that its main path went through the
kernels; ``FWD_<ROUTE>_LAUNCHES``, ``DQ_<ROUTE>_LAUNCHES`` and
``DKV_<ROUTE>_LAUNCHES`` split them by route.
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
FWD_SM90N_LAUNCHES = 0
FWD_TF32X3_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
DQ_SM90_LAUNCHES = 0
DKV_SM90_LAUNCHES = 0
DQ_TF32X3_LAUNCHES = 0
DKV_TF32X3_LAUNCHES = 0
DQ_SM90N_LAUNCHES = 0
DKV_SM90N_LAUNCHES = 0
FWD_TF32X3W_LAUNCHES = 0
DQ_TF32X3W_LAUNCHES = 0
DKV_TF32X3W_LAUNCHES = 0
FWD_SM90W_LAUNCHES = 0
DQ_SM90W_LAUNCHES = 0
DKV_SM90W_LAUNCHES = 0

#: Head dims above 128 the kernels are built for: fp32's ``tf32x3w`` route
#: (forward and backward) and bf16's ``sm90w``.  The
#: reference's configured widths 192 (deepseek-v2-lite MLA) and 288
#: (gemma2-2b) run unpadded, since zero columns cost a kernel their share
#: of the work; 240 (gemma3-12b) pads to 256, and 384 takes every other
#: width up to it.
WIDE_D = (192, 256, 288, 384)
#: Head dims the kernels are compiled for; ``ops`` zero-pads D up to one.
KERNEL_D = (16, 32, 64, 128) + WIDE_D
#: Head dims the bf16 tensor-core forward and backward kernels are built for.
SM90_FWD_D = (64, 128)
SM90_BWD_D = (64, 128)
#: Head dims the bf16 tensor-core kernels for narrow heads (the ``sm90n``
#: route) are built for: the forward, and dq and dk/dv.
SM90N_FWD_D = (16, 32)
SM90N_BWD_D = (16, 32)
#: Head dims above 128 at which the bf16 forward (384 in
#: ``csrc/flash_fwd_sm90_d384.cu``, the rest in
#: ``csrc/flash_fwd_sm90_wide.cu``) and the bf16 dq and dk/dv (384 in
#: ``csrc/flash_bwd_sm90_d384.cu``, the rest in ``csrc/flash_dq_sm90_wide.cu``
#: and ``csrc/flash_dkv_sm90_wide.cu``) run on the tensor cores (the
#: ``sm90w`` route); fp32 takes the ``tf32x3w`` route there.
SM90W_FWD_D = (192, 256, 288, 384)
SM90W_BWD_D = (192, 256, 288, 384)
#: Head dims the fp32 3xTF32 kernels of ``csrc/flash_fwd_tf32x3.cu`` and
#: ``csrc/flash_bwd_tf32x3.cu`` are built for (the ``tf32x3`` route): up to
#: 128 only (the dk/dv kernel uses 255 registers at D = 128).  Above it, at
#: every head dim in ``WIDE_D``, fp32 takes the ``tf32x3w`` route
#: (``csrc/flash_fwd_tf32x3_wide.cu``, ``csrc/flash_bwd_tf32x3_wide.cu``).
TF32X3_D = (16, 32, 64, 128)


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel a CUDA call launches.  bf16: ``"sm90n"``
    (``csrc/flash_fwd_sm90_narrow.cu``) at a head dim in ``SM90N_FWD_D``,
    ``"sm90"`` (``csrc/flash_fwd_sm90.cu``) in ``SM90_FWD_D`` and
    ``"sm90w"`` in ``SM90W_FWD_D`` (``csrc/flash_fwd_sm90_d384.cu`` at 384,
    ``csrc/flash_fwd_sm90_wide.cu`` below); fp32: ``"tf32x3w"``
    (``csrc/flash_fwd_tf32x3_wide.cu``) at a head dim in ``WIDE_D``, else
    ``"tf32x3"`` (``csrc/flash_fwd_tf32x3.cu``), both in three TF32 passes
    a product, like the fp32 backward of the same name."""
    if dtype == torch.bfloat16:
        for route, dims in (("sm90n", SM90N_FWD_D), ("sm90", SM90_FWD_D),
                            ("sm90w", SM90W_FWD_D)):
            if d in dims:
                return route
    return "tf32x3w" if d in WIDE_D else "tf32x3"


def bwd_route(dtype: torch.dtype, d: int, kernel: str) -> str:
    """The route of the backward ``kernel`` (``"dq"`` or ``"dkv"``) a CUDA
    call launches: bf16 at a head dim in ``SM90W_BWD_D`` takes ``"sm90w"``
    (``csrc/flash_bwd_sm90_d384.cu`` at 384, ``csrc/flash_dq_sm90_wide.cu``
    and ``csrc/flash_dkv_sm90_wide.cu`` below); otherwise ``"tf32x3w"``
    (``csrc/flash_bwd_tf32x3_wide.cu``) for fp32 at a head dim in
    ``WIDE_D``, ``"tf32x3"`` (``csrc/flash_bwd_tf32x3.cu``) for fp32
    at a head dim in ``TF32X3_D``, ``"sm90"``
    (``csrc/flash_bwd_sm90.cu``) for bf16 at a head dim in ``SM90_BWD_D``
    and ``"sm90n"`` (``csrc/flash_bwd_sm90_narrow.cu``) for bf16 at a head
    dim in ``SM90N_BWD_D``; any other head dim raises.  The tensor cores
    have no fp32 mode; the tf32x3 and tf32x3w kernels split each fp32
    operand into a TF32 hi and lo and sum three TF32 products (hi.lo +
    lo.hi + hi.hi), which keeps each product to a few times 2^-22
    relative: the accuracy class of an fp32 FMA sum in another order."""
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"kernel must be 'dq' or 'dkv', got {kernel!r}")
    if dtype == torch.bfloat16 and d in SM90W_BWD_D:
        return "sm90w"
    if dtype == torch.float32 and d in WIDE_D:
        return "tf32x3w"
    if dtype == torch.float32 and d in TF32X3_D:
        return "tf32x3"
    if dtype == torch.bfloat16 and d in SM90_BWD_D:
        return "sm90"
    if dtype == torch.bfloat16 and d in SM90N_BWD_D:
        return "sm90n"
    raise ValueError(f"no backward kernel for {dtype} at head dim {d}")


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
    ``fn_error_string`` (every forward source takes the same arguments)."""
    getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, fn).argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
                                 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p])
    getattr(lib, f"{fn}_error_string").restype = ctypes.c_char_p
    getattr(lib, f"{fn}_error_string").argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _fwd_tf32x3_lib() -> ctypes.CDLL:
    """The built ``flash_fwd_tf32x3`` library (the fp32 tensor-core route
    up to D 128)."""
    from repro_torch.kernels import build

    return _fwd_signatures(build.load("flash_fwd_tf32x3"), "flash_fwd_tf32x3")


@functools.cache
def _fwd_sm90_lib() -> ctypes.CDLL:
    """The built ``flash_fwd_sm90`` library (the tensor-core route)."""
    from repro_torch.kernels import build

    return _fwd_signatures(build.load("flash_fwd_sm90"), "flash_fwd_sm90")


@functools.cache
def _fwd_sm90n_lib() -> ctypes.CDLL:
    """The built ``flash_fwd_sm90_narrow`` library (the tensor-core route
    at D 16 and 32)."""
    from repro_torch.kernels import build

    return _fwd_signatures(build.load("flash_fwd_sm90_narrow"),
                           "flash_fwd_sm90n")


@functools.cache
def _fwd_tf32x3w_lib() -> ctypes.CDLL:
    """The built ``flash_fwd_tf32x3_wide`` library (the fp32 tensor-core
    route above D 128)."""
    from repro_torch.kernels import build

    return _fwd_signatures(build.load("flash_fwd_tf32x3_wide"),
                           "flash_fwd_tf32x3w")


@functools.cache
def _fwd_sm90w_lib() -> ctypes.CDLL:
    """The built ``flash_fwd_sm90_wide`` library (the tensor-core route
    above D 128)."""
    from repro_torch.kernels import build

    return _fwd_signatures(build.load("flash_fwd_sm90_wide"),
                           "flash_fwd_sm90w")


@functools.cache
def _fwd_sm90w384_lib() -> ctypes.CDLL:
    """The built ``flash_fwd_sm90_d384`` library (the tensor-core route at
    D 384)."""
    from repro_torch.kernels import build

    return _fwd_signatures(build.load("flash_fwd_sm90_d384"),
                           "flash_fwd_sm90w384")


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
    global FWD_LAUNCHES, FWD_SM90_LAUNCHES, FWD_TF32X3_LAUNCHES
    global FWD_TF32X3W_LAUNCHES, FWD_SM90W_LAUNCHES, FWD_SM90N_LAUNCHES
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    doc_ptr, doc_rows = _check_operands("flash_fwd", q, k, v, p, doc)
    route = fwd_route(q.dtype, d)
    if route in ("sm90", "sm90n", "sm90w") and any(t.data_ptr() % 16
                                                   for t in (q, k, v)):
        raise ValueError(f"the {route} forward kernel needs 16-byte "
                         "aligned q, k and v (they come by TMA)")
    out = torch.empty_like(q)
    if route in ("tf32x3", "tf32x3w") and any(t.data_ptr() % 16
                                              for t in (q, k, v, out)):
        raise ValueError(f"the {route} forward kernel copies q, k and v in "
                         "16-byte pieces and stores pairs, which needs "
                         "16-byte aligned q, k, v and out")
    if route == "sm90":
        lib, fn = _fwd_sm90_lib(), "flash_fwd_sm90"
    elif route == "sm90n":
        lib, fn = _fwd_sm90n_lib(), "flash_fwd_sm90n"
    elif route == "sm90w" and d == 384:
        lib, fn = _fwd_sm90w384_lib(), "flash_fwd_sm90w384"
    elif route == "sm90w":
        lib, fn = _fwd_sm90w_lib(), "flash_fwd_sm90w"
    elif route == "tf32x3w":
        lib, fn = _fwd_tf32x3w_lib(), "flash_fwd_tf32x3w"
    else:
        lib, fn = _fwd_tf32x3_lib(), "flash_fwd_tf32x3"
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
    elif route == "sm90n":
        FWD_SM90N_LAUNCHES += 1
    elif route == "sm90w":
        FWD_SM90W_LAUNCHES += 1
    elif route == "tf32x3w":
        FWD_TF32X3W_LAUNCHES += 1
    else:
        FWD_TF32X3_LAUNCHES += 1
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


def _bwd_signatures(lib: ctypes.CDLL, suffix: str,
                    kernels=("dq", "dkv")) -> ctypes.CDLL:
    """Declare the C signatures of a backward library's
    ``flash_bwd_<kernel><suffix>`` for each of ``kernels`` and
    ``flash_bwd<suffix>_error_string`` (every backward source takes the
    same arguments)."""
    tail = ([ctypes.c_int] * 15 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
    for which, n_ptrs in (("dq", 8), ("dkv", 9)):
        if which not in kernels:
            continue
        fn = getattr(lib, f"flash_bwd_{which}{suffix}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + tail
    err = getattr(lib, f"flash_bwd{suffix}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _bwd_sm90n_lib() -> ctypes.CDLL:
    """The built ``flash_bwd_sm90_narrow`` library (the bf16 tensor-core
    route at D 16 and 32)."""
    from repro_torch.kernels import build

    return _bwd_signatures(build.load("flash_bwd_sm90_narrow"), "_sm90n")


@functools.cache
def _bwd_sm90_lib() -> ctypes.CDLL:
    """The built ``flash_bwd_sm90`` library (the bf16 tensor-core route)."""
    from repro_torch.kernels import build

    return _bwd_signatures(build.load("flash_bwd_sm90"), "_sm90")


@functools.cache
def _bwd_tf32x3_lib() -> ctypes.CDLL:
    """The built ``flash_bwd_tf32x3`` library (the fp32 tensor-core
    route)."""
    from repro_torch.kernels import build

    return _bwd_signatures(build.load("flash_bwd_tf32x3"), "_tf32x3")


@functools.cache
def _bwd_tf32x3w_lib() -> ctypes.CDLL:
    """The built ``flash_bwd_tf32x3_wide`` library (the fp32 tensor-core
    route above D 128)."""
    from repro_torch.kernels import build

    return _bwd_signatures(build.load("flash_bwd_tf32x3_wide"), "_tf32x3w")


@functools.cache
def _dq_sm90w_lib() -> ctypes.CDLL:
    """The built ``flash_dq_sm90_wide`` library (the tensor-core dq above
    D 128)."""
    from repro_torch.kernels import build

    return _bwd_signatures(build.load("flash_dq_sm90_wide"), "_sm90w",
                           kernels=("dq",))


@functools.cache
def _dkv_sm90w_lib() -> ctypes.CDLL:
    """The built ``flash_dkv_sm90_wide`` library (the tensor-core dk/dv
    above D 128)."""
    from repro_torch.kernels import build

    return _bwd_signatures(build.load("flash_dkv_sm90_wide"), "_sm90w",
                           kernels=("dkv",))


@functools.cache
def _bwd_sm90w384_lib() -> ctypes.CDLL:
    """The built ``flash_bwd_sm90_d384`` library (the tensor-core dq and
    dk/dv at D 384)."""
    from repro_torch.kernels import build

    return _bwd_signatures(build.load("flash_bwd_sm90_d384"), "_sm90w384")


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
    ``bwd_route``'s route for ``q``; raises if it does not launch.  Returns
    the route."""
    route = bwd_route(q.dtype, q.shape[2], which)
    if route in ("sm90", "sm90w", "sm90n") and any(ptr % 16
                                                   for ptr in head[:4]):
        raise ValueError(f"the {route} backward kernels read q, k, v and "
                         "do by TMA, which needs 16-byte aligned pointers")
    if route == "sm90":
        lib, suffix = _bwd_sm90_lib(), "_sm90"
    elif route == "sm90n":
        lib, suffix = _bwd_sm90n_lib(), "_sm90n"
    elif route == "sm90w" and q.shape[2] == 384:
        lib, suffix = _bwd_sm90w384_lib(), "_sm90w384"
    elif route == "sm90w":
        lib = _dq_sm90w_lib() if which == "dq" else _dkv_sm90w_lib()
        suffix = "_sm90w"
    else:       # tf32x3, tf32x3w
        if any(ptr % 16 for ptr in (*head[:4], *(t.data_ptr() for t in outs))):
            raise ValueError(f"the {route} backward kernels copy q, k, v "
                             "and do in 16-byte pieces and store pairs, "
                             "which needs 16-byte aligned operands and "
                             "outputs")
        lib, suffix = ((_bwd_tf32x3_lib(), "_tf32x3") if route == "tf32x3"
                       else (_bwd_tf32x3w_lib(), "_tf32x3w"))
    fn = getattr(lib, f"flash_bwd_{which}{suffix}")
    error_string = getattr(lib, f"flash_bwd{suffix}_error_string")
    err = fn(*head, *(t.data_ptr() for t in outs), *tail)
    if err != 0:
        raise RuntimeError(f"flash_bwd_{which} ({route}) launch failed: "
                           f"{error_string(err).decode()} ({err})")
    return route


def _dq_cuda(q, k, v, do, lse, dsum, p: FlashParams, band, doc):
    """The dq kernel: dq in q's dtype."""
    global DQ_LAUNCHES, DQ_SM90_LAUNCHES, DQ_TF32X3_LAUNCHES
    global DQ_TF32X3W_LAUNCHES, DQ_SM90W_LAUNCHES, DQ_SM90N_LAUNCHES
    head, tail = _bwd_launch_args(q, k, v, do, lse, dsum, p, band, doc)
    dq = torch.empty_like(q)
    route = _launch_bwd("dq", q, head, (dq,), tail)
    DQ_LAUNCHES += 1
    if route == "sm90":
        DQ_SM90_LAUNCHES += 1
    elif route == "sm90n":
        DQ_SM90N_LAUNCHES += 1
    elif route == "sm90w":
        DQ_SM90W_LAUNCHES += 1
    elif route == "tf32x3":
        DQ_TF32X3_LAUNCHES += 1
    else:
        DQ_TF32X3W_LAUNCHES += 1
    return dq


def _dkv_cuda(q, k, v, do, lse, dsum, p: FlashParams, band, doc):
    """The dk/dv kernel: ``(dk, dv)`` in k's dtype, group-summed."""
    global DKV_LAUNCHES, DKV_SM90_LAUNCHES, DKV_TF32X3_LAUNCHES
    global DKV_SM90N_LAUNCHES, DKV_TF32X3W_LAUNCHES, DKV_SM90W_LAUNCHES
    head, tail = _bwd_launch_args(q, k, v, do, lse, dsum, p, band, doc)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route = _launch_bwd("dkv", q, head, (dk, dv), tail)
    DKV_LAUNCHES += 1
    if route == "sm90":
        DKV_SM90_LAUNCHES += 1
    elif route == "sm90n":
        DKV_SM90N_LAUNCHES += 1
    elif route == "sm90w":
        DKV_SM90W_LAUNCHES += 1
    elif route == "tf32x3":
        DKV_TF32X3_LAUNCHES += 1
    else:
        DKV_TF32X3W_LAUNCHES += 1
    return dk, dv
