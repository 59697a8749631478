"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, nvcc and triton; build the four CUDA sources from ``src/``
   in parallel and print their build times and ``ptxas`` registers and
   spills per instantiation.  TF32 is switched off for fp32 matmuls and
   cuDNN.
2. The flash forward kernels against their plain PyTorch version: the
   reference suite's sweep, zigzag bands with split q_seg / k_seg, a
   negative scale, a kv_valid cut, packed documents with the K-tile skip
   on and off, the full-width prefill shape and a ragged full-width case
   (L=4000, kv_valid, packed documents), each in fp32 and bf16.  Every case must
   hold the reference suite's elementwise tolerance (fp32 2e-5, bf16
   2e-2), a norm-relative out error (fp32 2e-5, bf16 1e-2: one bf16
   rounding step is at most 2^-7 relative) and lse within 1e-4 on the
   rows that see a key, and go through the route ``fwd_route`` picks: the
   sm90 tensor-core kernel for bf16 at D in {64, 128}, the FMA kernel for
   the rest (every fp32 case).
3. The dq and dk/dv kernels against their plain version on every case of
   the CPU parity suite (sweep and band cases), phase 2's band cases at
   D 64 / 128, the full-width training shape and a ragged full-width case
   (L=4000, kv_valid, packed documents), fp32 and bf16: max error within atol 5e-4 / rtol 1e-3 in
   fp32 (the reference suite's backward tolerance) and 2e-2 in bf16,
   norm-relative error within 2e-5 / 1e-2.  Each case must go through the
   route ``bwd_route`` picks: the sm90 tensor-core kernels for bf16 at
   D in {64, 128}, the FMA kernels for the rest (every fp32 case).
4. Serving qwen3-1.7b at full width: random bf16 weights from a seed,
   greedy ``generate`` of 32 tokens for 2 prompts of 4096 tokens.  Prefill
   must launch the sm90 forward kernel once per layer (and no FMA forward
   and no backward kernel), the tokens must lie in the vocabulary, and
   the last-token logits must match a prefill on plain attention (cosine
   >= 0.999).
5. Serving timings with CUDA events (both forward routes at the
   full-width shape, the sm90 kernel in bf16 and the FMA kernel in fp32,
   each beside its plain version, ``scaled_dot_product_attention`` in
   the same dtype and its bound; prefill, a decode step) and
   ``torch.profiler`` over one prefill and one decode step.
6. The whole model: full-width qwen3-1.7b at depth 2, ``forward_loss``
   and its backward at B=1, L=4096, on the kernels and on the dense
   oracle.  In fp32 (the FMA kernels): loss within 1e-5 relative, every
   grad leaf within 1e-4 norm-relative.  In bf16 (the sm90 kernels):
   loss within 1e-2 of the bf16 oracle; every grad leaf within 1e-2 of
   the bf16 oracle's, or, where the bf16 oracle itself lies further than
   that from the fp32 oracle, no further from it than that (all
   norm-relative to the fp32 oracle's leaf).
7. Training qwen3-1.7b at full depth through ``launch/train.py``'s
   path (``Trainer``): 3 steps of 2 microbatches of 1 x 4096 tokens;
   finite losses, step 0 within 1.5 of ln(vocab), exactly 56 forward
   (scpp), 56 dq and 56 dk/dv launches a step, all on the sm90 route and
   none on the FMA route.  Step time by CUDA events, tokens/s, MFU, peak
   memory; 5 more steps timed.
8. The backward kernels' times at the training shape (the sm90 kernels
   in bf16, the FMA kernels in fp32) beside their bounds, the plain
   version and SDPA's backward (timed alone: one forward, then the median
   of 21 ``autograd.grad`` calls with ``retain_graph``, with its spread),
   and ``torch.profiler`` over one training step.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}   # ||d|| / ||plain||
LSE_TOL = 1e-4
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
ARCH = "qwen3-1.7b"
BATCH, PROMPT, GEN = 2, 4096, 32

SWEEP = [
    # b, lq, lk, hq, hkv, d, causal, window, softcap (tests/test_kernels.py)
    (2, 64, 64, 4, 4, 32, True, None, 0.0),
    (1, 48, 80, 4, 2, 24, True, None, 0.0),
    (1, 33, 100, 6, 3, 40, True, None, 0.0),
    (2, 16, 96, 4, 4, 32, True, None, 0.0),
    (1, 32, 32, 2, 2, 16, False, None, 30.0),
    (2, 64, 64, 4, 1, 32, True, 16, 0.0),
    (1, 64, 64, 8, 2, 64, True, 8, 25.0),
    (1, 128, 128, 2, 2, 128, True, None, 0.0),
]


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(log: str):
    """(instantiation, registers, spill-store bytes) from ``ptxas -v``."""
    out, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"(flash_[a-z]+_kernel)I(\w+?)Li(\d+)ELi(\d+)E", line)
        m90 = re.search(r"(flash_[a-z]+_sm90_kernel)ILi(\d+)E", line)
        if "Compiling entry function" in line and m:
            dtype = "bf16" if "bfloat16" in m.group(2) else "fp32"
            name = (f"{m.group(1)}<{dtype}, D={m.group(3)}, "
                    f"tile={m.group(4)}>")
        elif "Compiling entry function" in line and m90:
            name = f"{m90.group(1)}<bf16, D={m90.group(2)}, tile=64>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def cuda_times(fn, reps: int = 7, warmup: int = 2) -> list:
    """Milliseconds of ``reps`` calls of ``fn()`` on the current stream,
    each between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    return statistics.median(cuda_times(fn, reps, warmup))


FLASH_NAME = re.compile(r"flash_\w+_kernel")


def profile_call(fn, top: int = 5):
    """Run ``fn`` once under ``torch.profiler``; returns (summary, result).
    The summary gives the host wall time under the profiler, the summed
    device time of the CUDA kernels (their busy share of that wall time),
    the kernels that took the most device time and every flash kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0.0:
        return (f"wall {wall_ms:.1f} ms; device time not measured (the "
                "profiler recorded no CUDA kernel)"), result
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    tops = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                     f" x{e.count}" for e in kernels[:top])
    launches = sum(e.count for e in kernels)
    flash = ", ".join(
        f"{FLASH_NAME.search(e.key).group(0)} "
        f"{e.self_device_time_total / 1e3:.2f} ms x{e.count}"
        for e in kernels if FLASH_NAME.search(e.key))
    summary = (f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
               f"({100 * busy_ms / wall_ms:.1f}%, idle "
               f"{100 - 100 * busy_ms / wall_ms:.1f}%), {launches} kernel "
               f"launches; top: {tops}; flash kernels: {flash or 'none'}")
    return summary, result


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(gen: torch.Generator):
    """(name, q, k, v, keyword arguments) on the card."""
    from repro_torch.kernels.ref import BandMask

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for i, (b, lq, lk, hq, hkv, d, causal, window, cap) in \
                enumerate(SWEEP):
            cases.append((f"sweep{i}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          dict(causal=causal, window=window, softcap=cap)))
        for i, j in ((1, 2), (2, 2), (3, 0)):
            cases.append((f"zigzag{i}{j}-{tag}", rand(1, 256, 8, 64,
                                                       dtype=dtype),
                          rand(1, 256, 4, 64, dtype=dtype),
                          rand(1, 256, 4, 64, dtype=dtype),
                          dict(causal=True,
                               band=BandMask.zigzag(i, j, 128, 4))))
        cases.append((f"neg_scale-{tag}", rand(1, 96, 4, 64, dtype=dtype),
                      rand(1, 160, 2, 64, dtype=dtype),
                      rand(1, 160, 2, 64, dtype=dtype),
                      dict(causal=True, scale=-0.2)))
        cases.append((f"kv_valid-{tag}", rand(2, 200, 8, 128, dtype=dtype),
                      rand(2, 448, 4, 128, dtype=dtype),
                      rand(2, 448, 4, 128, dtype=dtype),
                      dict(causal=True, kv_valid_len=301)))
        doc = torch.tensor(np.repeat([0, 100, 230, 400], [100, 130, 170, 112]),
                           dtype=torch.int32, device="cuda")[None].repeat(2, 1)
        for skip in (True, False):
            cases.append((f"doc_skip{int(skip)}-{tag}",
                          rand(2, 512, 8, 64, dtype=dtype),
                          rand(2, 512, 4, 64, dtype=dtype),
                          rand(2, 512, 4, 64, dtype=dtype),
                          dict(causal=True, q_doc_start=doc, doc_skip=skip)))
    b, h, hkv, d = BATCH, 16, 8, 128
    ragged_doc = torch.as_tensor(RAGGED_DOC[None], dtype=torch.int32,
                                 device="cuda")
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        cases.append((f"prefill-full-{tag}",
                      rand(b, PROMPT, h, d, dtype=dtype),
                      rand(b, PROMPT, hkv, d, dtype=dtype),
                      rand(b, PROMPT, hkv, d, dtype=dtype),
                      dict(causal=True)))
        cases.append((f"ragged-full-{tag}",
                      rand(1, RAGGED_L, h, d, dtype=dtype),
                      rand(1, RAGGED_L, hkv, d, dtype=dtype),
                      rand(1, RAGGED_L, hkv, d, dtype=dtype),
                      dict(causal=True, kv_valid_len=RAGGED_KV,
                           q_doc_start=ragged_doc)))
    return cases


def check_kernel(name, q, k, v, kw):
    """Kernel and plain version on the same folded operands, through the
    route ``fwd_route`` picks; returns the route, the max |out error|, the
    max |lse error| on visible rows and the folded call for timing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import NEG_INF, _fold_chunk_args

    d = q.shape[3]
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, **kw)
    route = fa.fwd_route(qf.dtype, qf.shape[2])
    n0 = launch_counts()
    out_k, lse_k = fa._fwd(qf, kf, vf, p, band=band, doc=doc)
    torch.cuda.synchronize()
    moved = launches_since(n0)
    check(moved == expected_launches(1, 0, route),
          f"{name} launched {moved}, expected one forward launch on the "
          f"{route} route")
    out_p, lse_p = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    ok_, op_ = out_k[..., :d].float(), out_p[..., :d].float()
    tol = TOL[q.dtype]
    err = float((ok_ - op_).abs().max())
    rel = float((ok_ - op_).norm() / op_.norm().clamp_min(1e-30))
    close = torch.allclose(ok_, op_, atol=tol, rtol=tol)
    seen = lse_p > NEG_INF / 2
    same_rows = bool(((lse_k > NEG_INF / 2) == seen).all())
    lse_err = float(torch.where(seen, lse_k - lse_p, 0.0).abs().max())
    good = (close and rel <= REL_TOL[q.dtype] and same_rows
            and lse_err <= LSE_TOL and bool(torch.isfinite(ok_).all()))
    print(f"  {name:22s} {route:4s} out max|err| {err:.3e} (tol {tol:g})  "
          f"||err||/||out|| {rel:.3e} (tol {REL_TOL[q.dtype]:g})  "
          f"lse max|err| {lse_err:.3e} (tol {LSE_TOL:g})  "
          f"{'ok' if good else 'FAIL'}")
    check(good, f"kernel disagrees with its plain version on {name}")
    del out_p, lse_p
    return route, err, lse_err, (qf, kf, vf, p, band, doc)


# ---------------------------------------------------------------------------
# Phase 3: the backward kernels against their plain version
# ---------------------------------------------------------------------------

# The band cases of tests/_torch_parity.py: name -> (b, lq, lk, hq, hkv, d,
# keyword arguments); ``band`` is (i, j, chunk, cp) of a zigzag ring step.
_DOC = np.repeat(np.array([0, 20, 52]), [20, 32, 28])[None].repeat(2, 0)
EXTRA = {
    "zigzag": (1, 16, 16, 4, 2, 16, dict(causal=True, band=(1, 2, 8, 4))),
    "zigzag_diag": (1, 16, 16, 4, 2, 16,
                    dict(causal=True, window=6, band=(2, 2, 8, 4))),
    "kv_valid": (2, 40, 64, 4, 2, 32, dict(causal=True, kv_valid_len=41)),
    "doc_skip": (2, 80, 80, 4, 2, 32,
                 dict(causal=True, q_doc_start=_DOC, doc_skip=True)),
    "doc_noskip": (2, 80, 80, 4, 2, 32,
                   dict(causal=True, q_doc_start=_DOC, doc_skip=False)),
}
# The reference suite's backward tolerance (tests/test_kernels.py:65) in
# fp32, its bf16 tolerance in bf16; and the norm-relative bound.
BWD_TOL = {torch.float32: (5e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
BWD_REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
TRAIN_HQ, TRAIN_HKV, TRAIN_D = 16, 8, 128
# Phase 2's band cases at their widths (D 64 and 128, so bf16 takes the
# sm90 route): zigzag ring steps (i, j) of cp=4 over chunks of 128, a
# kv_valid cut, packed documents with the K-tile skip on and off.
_WIDE_DOC = np.repeat([0, 100, 230, 400], [100, 130, 170, 112])[None]
WIDE = {
    **{f"zigzag{i}{j}-wide": (1, 256, 256, 8, 4, 64,
                              dict(causal=True, band=(i, j, 128, 4)))
       for i, j in ((1, 2), (2, 2), (3, 0))},
    "kv_valid-wide": (2, 200, 448, 8, 4, 128,
                      dict(causal=True, kv_valid_len=301)),
    **{f"doc_skip{int(skip)}-wide": (2, 512, 512, 8, 4, 64,
                                     dict(causal=True,
                                          q_doc_start=_WIDE_DOC.repeat(2, 0),
                                          doc_skip=skip))
       for skip in (True, False)},
}
# The ragged full-width case: L=4000 (not a multiple of any tile), keys cut
# at 3900, four packed documents.
RAGGED_L, RAGGED_KV = 4000, 3900
RAGGED_DOC = np.repeat([0, 1111, 2345, 3500], [1111, 1234, 1155, 500])


def bwd_cases(gen: torch.Generator):
    """(name, q, k, v, do, keyword arguments) on the card: the CPU parity
    suite's sweep and band cases, the band cases at phase 2's widths, then
    the full-width training shape and the ragged full-width case."""
    from repro_torch.kernels.ref import BandMask

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        shapes = [(f"sweep{i}", (b, lq, lk, hq, hkv, d),
                   dict(causal=causal, window=window, softcap=cap))
                  for i, (b, lq, lk, hq, hkv, d, causal, window, cap)
                  in enumerate(SWEEP)]
        for name, (b, lq, lk, hq, hkv, d, kw) in {**EXTRA, **WIDE}.items():
            kw = dict(kw)
            if "band" in kw:
                kw["band"] = BandMask.zigzag(*kw["band"])
            if "q_doc_start" in kw:
                kw["q_doc_start"] = torch.as_tensor(
                    kw["q_doc_start"], dtype=torch.int32, device="cuda")
            shapes.append((name, (b, lq, lk, hq, hkv, d), kw))
        shapes.append(("train-full", (BATCH, PROMPT, PROMPT, TRAIN_HQ,
                                      TRAIN_HKV, TRAIN_D), dict(causal=True)))
        shapes.append(("train-ragged", (1, RAGGED_L, RAGGED_L, TRAIN_HQ,
                                        TRAIN_HKV, TRAIN_D),
                       dict(causal=True, kv_valid_len=RAGGED_KV,
                            q_doc_start=torch.as_tensor(
                                RAGGED_DOC[None], dtype=torch.int32,
                                device="cuda"))))
        for name, (b, lq, lk, hq, hkv, d), kw in shapes:
            cases.append((f"{name}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lq, hq, d, dtype=dtype), kw))
    return cases


def check_bwd(name, q, k, v, do, kw):
    """dq and dk/dv kernels against ``_bwd_plain`` on the same folded
    operands and the same ``(out, lse)``, through the route ``bwd_route``
    picks.  Returns the route, ``{"dq": (max |err|, norm-relative err),
    "dk": ..., "dv": ...}`` and the folded call for timing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad

    d = q.shape[3]
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, **kw)
    dof = _fold_pad(do, qf.shape[2])
    out, lse = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    dsum = (dof.float() * out.float()).sum(dim=-1)
    route = fa.bwd_route(qf.dtype, qf.shape[2])
    n0 = launch_counts()
    got = fa._bwd_cuda(qf, kf, vf, dof, lse, dsum, p, band, doc)
    torch.cuda.synchronize()
    moved = launches_since(n0)
    check(moved == expected_launches(0, 1, route),
          f"{name} launched {moved}, expected one dq and one dk/dv launch "
          f"on the {route} route")
    want = fa._bwd_plain(qf, kf, vf, out, lse, dof, p, band, doc)
    atol, rtol = BWD_TOL[q.dtype]
    errs, good, parts = {}, True, []
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g[..., :d].float(), w[..., :d].float()
        err = float((g - w).abs().max())
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        ok = (torch.allclose(g, w, atol=atol, rtol=rtol)
              and rel <= BWD_REL_TOL[q.dtype]
              and bool(torch.isfinite(g).all()))
        good = good and ok
        errs[label] = (err, rel)
        parts.append(f"{label} {err:.2e}/{rel:.2e}")
    print(f"  {name:18s} {route:4s} max|err|/norm-rel: {'  '.join(parts)}  "
          f"(tol {atol:g}+{rtol:g}|x|, {BWD_REL_TOL[q.dtype]:g})  "
          f"{'ok' if good else 'FAIL'}")
    check(good, f"backward kernels disagree with their plain version on "
                f"{name}")
    del want, got
    return route, errs, (qf, kf, vf, dof, lse, dsum, p, band, doc)


def bwd_bound(q, k, n_products: int, dtype: torch.dtype):
    """(bound ms, bound_by, FLOP) of one backward kernel at a causal shape:
    ``n_products`` products of 2*D FLOPs per visible (q, k) pair against
    the peak rate of ``dtype`` (989 TFLOP/s on the bf16 tensor cores; 67
    TFLOP/s for fp32, which keeps full fp32 math off the tensor cores), or
    the bytes it must move (q, k, v, dO read; its outputs written; lse and
    dsum) against 3.35 TB/s."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    pairs = lq * (lq + 1) // 2
    flops = n_products * 2 * b * hq * d * pairs
    item = dtype.itemsize
    q_bytes, kv_bytes = b * lq * hq * d * item, b * lq * hkv * d * item
    out_bytes = q_bytes if n_products == 3 else 2 * kv_bytes
    nbytes = 2 * q_bytes + 2 * kv_bytes + out_bytes + 2 * b * hq * lq * 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def fwd_bound(q, k, dtype: torch.dtype):
    """(bound ms, bound_by, FLOP) of the forward kernel at a causal shape:
    two products of 2*D FLOPs per visible (q, k) pair against the peak
    rate of ``dtype`` (as in ``bwd_bound``), or the bytes it must move (q,
    k, v read; out and lse written) against 3.35 TB/s."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    flops = 4 * b * hq * d * (lq * (lq + 1) // 2)
    item = dtype.itemsize
    nbytes = (2 * b * lq * hq * d + 2 * b * lq * hkv * d) * item \
        + b * hq * lq * 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


# ---------------------------------------------------------------------------
# Phase 4: serving
# ---------------------------------------------------------------------------

def counted_fns(cfg, rt, record):
    """``make_generate_fns`` whose prefill records its kernel launches and
    its logits."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    pf, step, traces = serve.make_generate_fns(cfg, rt)

    def pf_counted(p, batch):
        n0 = fa.FWD_LAUNCHES
        logits, caches = pf(p, batch)
        record["prefill_launches"].append(fa.FWD_LAUNCHES - n0)
        record["logits"] = logits
        return logits, caches

    return pf_counted, step, traces


def launch_counts() -> dict:
    """Kernel launches: the forward, the backward pair, and each of them
    by route."""
    from repro_torch.kernels import flash_attention as fa
    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_dq": fa.DQ_LAUNCHES,
            "flash_bwd_dkv": fa.DKV_LAUNCHES,
            "fwd_sm90": fa.FWD_SM90_LAUNCHES, "fwd_fma": fa.FWD_FMA_LAUNCHES,
            "dq_sm90": fa.DQ_SM90_LAUNCHES, "dkv_sm90": fa.DKV_SM90_LAUNCHES,
            "dq_fma": fa.DQ_FMA_LAUNCHES, "dkv_fma": fa.DKV_FMA_LAUNCHES}


def launches_since(n0: dict) -> dict:
    return {key: n - n0[key] for key, n in launch_counts().items()}


def expected_launches(fwd: int, bwd: int, route: str) -> dict:
    """``launch_counts`` after ``fwd`` forward launches and ``bwd`` dq and
    ``bwd`` dk/dv launches, all on the route ``route``."""
    want = {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd,
            "fwd_sm90": 0, "fwd_fma": 0, "dq_sm90": 0, "dkv_sm90": 0,
            "dq_fma": 0, "dkv_fma": 0}
    want[f"fwd_{route}"] = fwd
    want[f"dq_{route}"] = want[f"dkv_{route}"] = bwd
    return want


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fa.FWD_SM90_LAUNCHES = fa.FWD_FMA_LAUNCHES = 0
    fa.DQ_SM90_LAUNCHES = fa.DKV_SM90_LAUNCHES = 0
    fa.DQ_FMA_LAUNCHES = fa.DKV_FMA_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Phase 6: the whole model, kernels against the dense oracle
# ---------------------------------------------------------------------------

# dtype -> (route of the kernels, loss tolerance (relative), grad
# tolerance (norm-relative)).  fp32 keeps full fp32 math, so its
# differences are reordered sums; bf16 takes the bf16 kernel tolerance.
MODEL_CHECKS = {"float32": ("fma", 1e-5, 1e-4),
                "bfloat16": ("sm90", 1e-2, 1e-2)}


def model_runs(dtype: str) -> dict:
    """A full-width, depth-2 qwen3-1.7b ``forward_loss`` and its backward at
    B=1, L=4096 in ``dtype`` (the same fp32 masters from seed 1), on the
    kernels and on ``impl="ref"``: ``{impl: (loss, grads, launches)}``."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import forward_loss, init_params

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2, dtype=dtype)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=PROMPT,
                                   global_batch=1, seed=1)).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    leaves, spec = tree_flatten(params)
    runs = {}
    for impl in ("cuda", "ref"):
        reset_counts()
        xs = [x.detach().requires_grad_() for x in leaves]
        loss, _ = forward_loss(tree_unflatten(xs, spec), batch,
                               Runtime(impl=impl, device="cuda"), cfg)
        grads = [g.float() for g in torch.autograd.grad(loss, xs)]
        torch.cuda.synchronize()
        runs[impl] = (loss.item(), grads, launch_counts())
        del loss, xs
    want = expected_launches(2, 2, MODEL_CHECKS[dtype][0])
    check(runs["cuda"][2] == want,
          f"the {dtype} kernel run launched {runs['cuda'][2]}, expected "
          f"{want}")
    check(not any(runs["ref"][2].values()),
          f"the {dtype} ref run launched kernels: {runs['ref'][2]}")
    check(all(bool(torch.isfinite(g).all()) for g in runs["cuda"][1]),
          f"non-finite grads on the {dtype} kernels")
    return runs


def model_check():
    """The whole model on the kernels against the dense oracle, in fp32 and
    in bf16.  Returns ``{dtype: (relative loss difference, worst
    norm-relative grad difference)}``.

    fp32: the loss within 1e-5 relative and every grad leaf within 1e-4
    norm-relative of the fp32 oracle.  bf16: the loss within 1e-2 of the
    bf16 oracle, and every grad leaf within 1e-2 (norm-relative to the
    fp32 oracle's leaf) of the bf16 oracle's, or, where the bf16 oracle
    itself lies further than that from the fp32 oracle, no further from
    the bf16 oracle than the bf16 oracle lies from the fp32 oracle: the
    bf16 oracle's own rounding sets how finely the two bf16 paths can be
    compared."""
    def rel(a, b, ref):
        return float((a - b).norm() / ref.norm().clamp_min(1e-30))

    out = {}
    r32 = model_runs("float32")
    (lk, gk, _), (lr, g32, _) = r32["cuda"], r32["ref"]
    _, loss_tol, grad_tol = MODEL_CHECKS["float32"]
    loss_rel = abs(lk - lr) / abs(lr)
    grad_rel = max(rel(a, b, b) for a, b in zip(gk, g32))
    print(f"    float32: loss kernels {lk:.6f}, ref {lr:.6f}: relative "
          f"difference {loss_rel:.3e} (tol {loss_tol:g}); worst grad leaf "
          f"norm-relative difference {grad_rel:.3e} over {len(gk)} leaves "
          f"(tol {grad_tol:g}); forward and backward route fma")
    check(loss_rel <= loss_tol and grad_rel <= grad_tol,
          "the fp32 model on the kernels disagrees with the dense oracle")
    out["float32"] = (loss_rel, grad_rel)
    del r32, gk
    torch.cuda.empty_cache()

    r16 = model_runs("bfloat16")
    (lk, gk, _), (lr, gr, _) = r16["cuda"], r16["ref"]
    _, loss_tol, grad_tol = MODEL_CHECKS["bfloat16"]
    loss_rel = abs(lk - lr) / abs(lr)
    # Per leaf: kernels vs bf16 oracle, bf16 oracle vs fp32 oracle, and
    # kernels vs fp32 oracle, each over the fp32 oracle's norm.
    leaf = [(rel(a, r, t), rel(r, t, t), rel(a, t, t))
            for a, r, t in zip(gk, gr, g32)]
    worst = max(range(len(leaf)), key=lambda i: leaf[i][0])
    ok = all(kr <= max(grad_tol, r32_) for kr, r32_, _ in leaf)
    print(f"    bfloat16: loss kernels {lk:.6f}, bf16 ref {lr:.6f}: "
          f"relative difference {loss_rel:.3e} (tol {loss_tol:g}); worst "
          f"grad leaf (#{worst} of {len(leaf)}): kernels vs bf16 ref "
          f"{leaf[worst][0]:.3e}, where the bf16 ref lies {leaf[worst][1]:.3e}"
          f" from the fp32 ref (tol max({grad_tol:g}, that)); over all "
          f"leaves: kernels vs fp32 ref at most "
          f"{max(x[2] for x in leaf):.3e}, bf16 ref vs fp32 ref at most "
          f"{max(x[1] for x in leaf):.3e}, leaves over {grad_tol:g} "
          f"against the bf16 ref {sum(x[0] > grad_tol for x in leaf)}; "
          f"forward and backward route sm90")
    check(loss_rel <= loss_tol and ok,
          "the bf16 model on the kernels disagrees with the dense oracle")
    out["bfloat16"] = (loss_rel, leaf[worst][0])
    return out


# ---------------------------------------------------------------------------
# Phase 7: training at full depth
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", ARCH, "--seq-len", str(PROMPT), "--global-batch",
              str(BATCH), "--grad-accum", "2", "--steps", "3"]


def train_flops(cfg, seq: int, tokens: int) -> float:
    """Model FLOPs of one training step (forward + backward = 3 forwards,
    no recompute): 2 per token per matmul weight, LM head included, plus
    the causal attention products (2 of 2*D per visible pair a head)."""
    per_layer = cfg.d_model * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
        * cfg.hd + 3 * cfg.d_model * cfg.d_ff
    weights = cfg.num_layers * per_layer + cfg.vocab * cfg.d_model
    pairs = seq * (seq + 1) // 2
    attn = 4 * cfg.hd * cfg.n_heads * pairs * cfg.num_layers * (tokens
                                                               // seq)
    return 3 * (2 * weights * tokens + attn)


def train_phase():
    """``launch/train.py``'s path for ``TRAIN_ARGV`` through ``Trainer``;
    returns the record of the run and the trainer."""
    from repro_torch.launch import train as launch_train

    plan, trainer = launch_train.make_trainer(
        launch_train.parse_args(TRAIN_ARGV))
    print("    " + plan.describe().replace("\n", "\n    "))
    step_fn, steps = trainer.step_fn, []

    def counted(params, opt_state, batch):
        n0 = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(params, opt_state, batch)
        end.record()
        steps.append({"events": (start, end), "metrics": out[2],
                      "launches": launches_since(n0)})
        return out

    trainer.step_fn = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = trainer.run()
    torch.cuda.synchronize()
    totals = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    trainer.step_fn = step_fn
    ms = [a.elapsed_time(b) for a, b in (s["events"] for s in steps)]
    gnorms = [float(s["metrics"]["grad_norm"]) for s in steps]
    return {"losses": losses, "gnorms": gnorms, "step_ms": ms,
            "launches": [s["launches"] for s in steps], "totals": totals,
            "peak": peak, "plan": plan}, trainer


def steady_steps(trainer, n: int) -> list:
    """``n`` more steps of ``trainer``'s step function on its next
    batches, each timed with CUDA events and no sync between steps (as in
    the trainer's loop); returns their milliseconds."""
    events = []
    for i in range(n):
        batch = trainer._to_device(trainer.data.batch(trainer.tcfg.num_steps
                                                      + i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.params, trainer.opt_state, _ = trainer.step_fn(
            trainer.params, trainer.opt_state, batch)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def smi_sample() -> str:
    """The card's SM clock, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models.decode import decode_step, grow_caches, prefill
    from repro_torch.models.model import cast_params_once, init_params

    # -- phase 1 ------------------------------------------------------------
    smi = smi_line()
    print(f"[1] card: {smi}")
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    print(f"    python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc {nvcc}  "
          f"triton {importlib.util.find_spec('triton') is not None}  "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"    allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    records = build.build_all(["flash_fwd", "flash_fwd_sm90", "flash_bwd",
                               "flash_bwd_sm90"])
    print(f"    built the four libraries in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib_name, record in records.items():
        print(f"    {record['path'].name}: nvcc {record['seconds']:.2f} s")
        for name, regs, spills in ptxas_summary(record["log"]):
            print(f"    ptxas {name}: {regs} registers, {spills} bytes "
                  "spilled")

    # -- phase 2 ------------------------------------------------------------
    print("[2] forward kernels (sm90 route for bf16 at D in "
          f"{fa.SM90_FWD_D}, FMA route otherwise) against their plain "
          "version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # route -> [max |out err|, max |lse err|, cases]
    fwd_worst = {r: [0.0, 0.0, 0] for r in ("sm90", "fma")}
    full = {}
    for name, q, k, v, kw in kernel_cases(gen):
        route, err, lse_err, folded = check_kernel(name, q, k, v, kw)
        w = fwd_worst[route]
        w[0], w[1], w[2] = max(w[0], err), max(w[1], lse_err), w[2] + 1
        if name.startswith("prefill-full-"):
            full[q.dtype] = (q, k, v, folded)
        del q, k, v, folded
    check(fwd_worst["sm90"][2] > 0 and fwd_worst["fma"][2] > 0,
          "a forward route ran no case")
    print("    " + "; ".join(
        f"{r} ({n} cases) worst out max|err| {e:.3e}, lse max|err| {le:.3e}"
        for r, (e, le, n) in fwd_worst.items()))
    torch.cuda.empty_cache()

    # -- phase 3 ------------------------------------------------------------
    print("[3] dq and dk/dv kernels (sm90 route for bf16 at D in "
          f"{fa.SM90_BWD_D}, FMA route otherwise) against their plain "
          "version")
    # (route, kernel) -> [max |err|, norm-relative err, cases]
    worst = {(r, key): [0.0, 0.0, 0] for r in ("sm90", "fma")
             for key in ("dq", "dkv")}
    bwd_passed, bwd_full = 0, None
    for name, q, k, v, do, kw in bwd_cases(gen):
        route, errs, folded = check_bwd(name, q, k, v, do, kw)
        for label, (err, rel) in errs.items():
            w = worst[route, "dq" if label == "dq" else "dkv"]
            w[0], w[1] = max(w[0], err), max(w[1], rel)
            w[2] += label != "dv"
        bwd_passed += 1
        if name == "train-full-bf16":
            bwd_full = (q, k, v, do, folded)
        del q, k, v, do, folded
        torch.cuda.empty_cache()
    check(worst["sm90", "dq"][2] > 0 and worst["fma", "dq"][2] > 0,
          "a backward route ran no case")
    print(f"    {bwd_passed} cases passed: " + "; ".join(
        f"{r} {key} ({n} cases) worst max|err| {e:.3e}, norm-rel {rel:.3e}"
        for (r, key), (e, rel, n) in worst.items()))

    # -- phase 4 ------------------------------------------------------------
    print(f"[4] serving {ARCH}: batch {BATCH} x {PROMPT} prompt tokens, "
          f"{GEN} generated")
    cfg = get_config(ARCH)
    rt = Runtime(impl="auto", device="cuda")
    params = cast_params_once(
        init_params(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                             device="cuda")
    rec = {"prefill_launches": []}
    fns = counted_fns(cfg, rt, rec)
    serve.generate(params, cfg, rt, tokens[:, :256], gen=2, fns=fns)  # warm-up
    rec["prefill_launches"].clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = serve.generate(params, cfg, rt, tokens, gen=GEN, fns=fns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = launch_counts()
    launches = serve_launches["flash_fwd"]
    peak = torch.cuda.max_memory_allocated()
    check(rec["prefill_launches"] == [cfg.num_layers],
          f"prefill launched the kernel {rec['prefill_launches']} times, "
          f"expected [{cfg.num_layers}]")
    check(launches == serve_launches["fwd_sm90"] == cfg.num_layers,
          f"generate launched the forward kernel {launches} times, "
          f"{serve_launches['fwd_sm90']} on the sm90 route; expected "
          f"{cfg.num_layers} on it")
    check(serve_launches["flash_bwd_dq"] == serve_launches["flash_bwd_dkv"]
          == 0, f"serving launched a backward kernel: {serve_launches}")
    check(tuple(out.shape) == (BATCH, GEN), f"tokens shape {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()),
          "generated tokens outside the vocabulary")
    logits_k = rec["logits"][:, -1]
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    print(f"    tokens[0, :12] = {out[0, :12].tolist()}")
    print(f"    kernel launches in generate: {serve_launches} "
          f"(prefill: {rec['prefill_launches']})")
    with torch.inference_mode():
        n0 = fa.FWD_LAUNCHES
        logits_r, _ = prefill(params, {"tokens": tokens},
                              Runtime(impl="ref", device="cuda"), cfg)
        check(fa.FWD_LAUNCHES == n0, "the ref prefill launched the kernel")
    logits_r = logits_r[:, -1]
    cos = torch.nn.functional.cosine_similarity(logits_k, logits_r, dim=-1)
    dmax = float((logits_k - logits_r).abs().max())
    print(f"    last-token logits, kernel vs plain attention: cosine "
          f"{[round(float(c), 6) for c in cos]}  max|d| {dmax:.4e}")
    check(float(cos.min()) >= 0.999, f"logit cosine {cos.tolist()} < 0.999")
    del logits_r
    torch.cuda.empty_cache()

    # -- phase 5 ------------------------------------------------------------
    print("[5] serving timings (CUDA events, 2 warm-ups, then the median of "
          "7; 5 for the plain version and prefill) and where the time goes")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_timings = {}
    # The sm90 kernel on the bf16 operands, the FMA kernel on the same
    # shape in fp32; each beside the plain version and SDPA in its dtype.
    for route, dtype in (("sm90", torch.bfloat16), ("fma", torch.float32)):
        q, k, v, (qf, kf, vf, p, band, doc) = full[dtype]
        n0 = launch_counts()
        kernel_ms = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band,
                                            doc=doc))
        moved = launches_since(n0)          # 2 warm-ups + 7 timed
        check(moved == expected_launches(9, 0, route),
              f"the {route} forward timing launched {moved}")
        plain_ms = cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p, band=band,
                                                 doc=doc), reps=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True))
        group = q.shape[2] // k.shape[2]
        kr, vr = (x.repeat_interleave(group, dim=1) for x in (kt, vt))
        library_rep_ms = cuda_ms(lambda: sdpa(qt, kr, vr, is_causal=True))
        del kr, vr, qt, kt, vt
        bound_ms, bound_by, flops = fwd_bound(q, k, dtype)
        fwd_timings[route] = dict(ms=kernel_ms, plain=plain_ms,
                                  library=library_ms, bound=bound_ms,
                                  by=bound_by)
        b, lq, hq, d = q.shape
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        rate = 989 if dtype == torch.bfloat16 else 67
        print(f"    flash_fwd {route} at B={b} L={lq} Hq={hq} "
              f"Hkv={k.shape[2]} D={d} causal {tag}: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa(enable_gqa) {library_ms:.4f} ms, "
              f"sdpa(repeated kv) {library_rep_ms:.4f} ms")
        print(f"    {route}: bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e9:.1f} GFLOP at {rate} TFLOP/s); kernel at "
              f"{flops / kernel_ms / 1e9:.1f} TFLOP/s, "
              f"{100 * bound_ms / kernel_ms:.2f}% of the bound")
    del full
    torch.cuda.empty_cache()
    with torch.inference_mode():
        def run_prefill():
            return prefill(params, {"tokens": tokens}, rt, cfg)

        prefill_ms = cuda_ms(run_prefill, reps=5)
        logits, caches = run_prefill()
        caches = grow_caches(cfg, caches, 1)
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits

        def run_step():
            # Writes the same cache slot each call (the cache is pre-sized).
            return decode_step(params, caches, tok, PROMPT, rt, cfg)

        decode_ms = cuda_ms(run_step)
    print(f"    serving: prefill {prefill_ms:.4f} ms "
          f"({BATCH * PROMPT * 1e3 / prefill_ms:.0f} prompt tok/s), "
          f"decode step at position {PROMPT} {decode_ms:.4f} ms "
          f"({BATCH * 1e3 / decode_ms:.1f} tok/s at batch {BATCH}); "
          f"one generate (host clock) {wall:.3f} s "
          f"({BATCH * GEN / wall:.1f} generated tok/s), "
          f"peak memory in generate {peak / 2**30:.2f} GiB")
    with torch.inference_mode():
        pf_prof, _ = profile_call(run_prefill)
        dec_prof, _ = profile_call(run_step)
    for label, prof in (("prefill", pf_prof), ("decode step", dec_prof)):
        print(f"    {label}: {prof}")
    del caches, params, tok
    torch.cuda.empty_cache()

    # -- phase 6 ------------------------------------------------------------
    print(f"[6] whole model: full-width {ARCH} at depth 2, fp32 and bf16, "
          f"B=1 L={PROMPT}, forward_loss + backward on the kernels and on "
          "the dense oracle")
    model_check()
    torch.cuda.empty_cache()

    # -- phase 7 ------------------------------------------------------------
    print(f"[7] training {ARCH} at full depth: python -m "
          f"repro_torch.launch.train {' '.join(TRAIN_ARGV)}")
    run, trainer = train_phase()
    tcfg = run["plan"].cfg
    n_layers, accum = tcfg.num_layers, run["plan"].grad_accum
    losses = run["losses"]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(abs(losses[0] - np.log(tcfg.vocab)) <= 1.5,
          f"step-0 loss {losses[0]} is not within 1.5 of ln(vocab) = "
          f"{np.log(tcfg.vocab):.2f}")
    fwd_per_step = {"none": 1, "scpp": 1, "full": 2}[tcfg.remat] \
        * n_layers * accum
    want = expected_launches(fwd_per_step, n_layers * accum, "sm90")
    check(all(step == want for step in run["launches"]),
          f"launches per step {run['launches']}, expected {want}")
    tokens_per_step = BATCH * PROMPT
    step_ms = statistics.median(run["step_ms"][1:])
    model_flops = train_flops(tcfg, PROMPT, tokens_per_step)
    print(f"    model FLOPs per step {model_flops / 1e12:.2f} TFLOP "
          f"(matmul weights and causal attention, forward + backward, no "
          f"recompute)")
    print(f"    losses {[round(x, 6) for x in losses]} (ln vocab "
          f"{np.log(tcfg.vocab):.4f}); grad norms "
          f"{[round(x, 6) for x in run['gnorms']]}")
    print(f"    kernel launches per step {run['launches'][0]} (remat "
          f"{tcfg.remat}); step times {[round(x, 2) for x in run['step_ms']]}"
          f" ms; median after 1 warm-up {step_ms:.2f} ms = "
          f"{tokens_per_step * 1e3 / step_ms:.0f} tokens/s, "
          f"{100 * model_flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.2f}% of "
          f"989 TFLOP/s; peak memory {run['peak'] / 2**30:.2f} GiB")

    extra_ms = steady_steps(trainer, 5)
    print(f"    5 more steps of the same trainer: "
          f"{[round(x, 2) for x in extra_ms]} ms, median "
          f"{statistics.median(extra_ms):.2f} ms; card right after: "
          f"{smi_sample()}")

    # -- phase 8 ------------------------------------------------------------
    print("[8] backward timings at the training shape and where the time "
          "goes in a training step")
    q, k, v, do, (qf, kf, vf, dof, lse, dsum, p, band, doc) = bwd_full
    out_f, _ = fa._fwd(qf, kf, vf, p, band=band, doc=doc)
    b, lq, hq, d = q.shape
    timings = {}
    # The sm90 kernels on the bf16 operands, the FMA kernels on the same
    # operands in fp32; each beside the plain version and SDPA's backward
    # on the same inputs.
    for route, dtype in (("sm90", torch.bfloat16), ("fma", torch.float32)):
        x = [t.to(dtype) for t in (qf, kf, vf, dof, out_f)]
        n0 = launch_counts()
        dq_ms = cuda_ms(lambda: fa._dq_cuda(x[0], x[1], x[2], x[3], lse,
                                            dsum, p, band, doc))
        dkv_ms = cuda_ms(lambda: fa._dkv_cuda(x[0], x[1], x[2], x[3], lse,
                                              dsum, p, band, doc))
        moved = launches_since(n0)          # 2 warm-ups + 7 timed, each
        check(moved == expected_launches(0, 9, route),
              f"the {route} timing launched {moved}")
        bwd_plain_ms = cuda_ms(lambda: fa._bwd_plain(
            x[0], x[1], x[2], x[4], lse, x[3], p, band, doc), reps=5)
        qt, kt, vt = (t.to(dtype).transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        dot = do.to(dtype).transpose(1, 2).contiguous()
        sdpa_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_times = cuda_times(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True), reps=21, warmup=3)
        del sdpa_out, qt, kt, vt, dot, x
        torch.cuda.empty_cache()
        dq_bound, dq_by, dq_flops = bwd_bound(q, k, 3, dtype)
        dkv_bound, dkv_by, dkv_flops = bwd_bound(q, k, 4, dtype)
        timings[route] = dict(
            dq=(dq_ms, dq_bound, dq_by), dkv=(dkv_ms, dkv_bound, dkv_by),
            plain=bwd_plain_ms, library=statistics.median(lib_times))
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"    {route} at B={b} L={lq} Hq={hq} Hkv={k.shape[2]} D={d} "
              f"causal {tag}: dq kernel {dq_ms:.4f} ms (bound "
              f"{dq_bound:.4f} ms, {dq_by}: {dq_flops / 1e9:.1f} GFLOP; "
              f"{dq_flops / dq_ms / 1e9:.1f} TFLOP/s); dk/dv kernel "
              f"{dkv_ms:.4f} ms (bound {dkv_bound:.4f} ms, {dkv_by}: "
              f"{dkv_flops / 1e9:.1f} GFLOP; "
              f"{dkv_flops / dkv_ms / 1e9:.1f} TFLOP/s)")
        print(f"    {route}: plain backward (dq, dk, dv in one call) "
              f"{bwd_plain_ms:.4f} ms; sdpa(enable_gqa) backward alone (one "
              f"forward, then autograd.grad with retain_graph) median "
              f"{statistics.median(lib_times):.4f} ms over 21, min "
              f"{min(lib_times):.4f}, max {max(lib_times):.4f}")
    del out_f
    torch.cuda.empty_cache()
    batch = trainer._to_device(trainer.data.batch(3))
    train_prof, _ = profile_call(
        lambda: trainer.step_fn(trainer.params, trainer.opt_state, batch),
        top=12)
    print(f"    training step: {train_prof}")

    def bwd_record(route, key, tpu_line, tpu_kernel, source):
        ms, bound, by = timings[route][key]
        label = f"{key}_{route}"
        return {"name": f"flash_bwd_{key}_{route}", "route": "cuda",
                "kernel_route": route, "source": source,
                "replaces": f"src/repro/kernels/flash_attention.py:{tpu_line}",
                "tpu_kernel": tpu_kernel, "launches": run["totals"][label],
                "cases": worst[route, key][2],
                "max_abs_err": worst[route, key][0],
                "max_norm_rel_err": worst[route, key][1], "ms": ms,
                "plain_ms": timings[route]["plain"], "bound_ms": bound,
                "bound_by": by, "library_ms": timings[route]["library"],
                "dtype": "bf16" if route == "sm90" else "fp32"}

    sm90_src = "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu"
    fma_src = "src/repro_torch/kernels/csrc/flash_bwd.cu"
    def fwd_record(route, source):
        t = fwd_timings[route]
        return {"name": f"flash_fwd_{route}", "route": "cuda",
                "kernel_route": route, "source": source,
                "replaces": "src/repro/kernels/flash_attention.py:145",
                "tpu_kernel": "_fwd_kernel",
                "launches": run["totals"][f"fwd_{route}"],
                "serve_launches": serve_launches[f"fwd_{route}"],
                "cases": fwd_worst[route][2],
                "max_abs_err": fwd_worst[route][0],
                "max_lse_err": fwd_worst[route][1], "ms": t["ms"],
                "plain_ms": t["plain"], "bound_ms": t["bound"],
                "bound_by": t["by"], "library_ms": t["library"],
                "dtype": "bf16" if route == "sm90" else "fp32"}

    kernels = [
        fwd_record("sm90", "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu"),
        fwd_record("fma", "src/repro_torch/kernels/csrc/flash_fwd.cu"),
        bwd_record("sm90", "dq", 289, "_dq_kernel", sm90_src),
        bwd_record("sm90", "dkv", 331, "_dkv_kernel", sm90_src),
        bwd_record("fma", "dq", 289, "_dq_kernel", fma_src),
        bwd_record("fma", "dkv", 331, "_dkv_kernel", fma_src)]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
