"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, nvcc and triton; build the thirteen CUDA sources from ``src/``
   and the ``mma.sync`` TF32 probe (``scripts/mma_tf32_probe.cu``) in
   parallel and print their build times and ``ptxas`` registers and
   spills per instantiation.  TF32 is switched off for fp32 matmuls and
   cuDNN.
2. The flash forward kernels against their plain PyTorch version: the
   reference suite's sweep, zigzag bands with split q_seg / k_seg, a
   negative scale, a kv_valid cut, packed documents with the K-tile skip
   on and off (at D 64 / 128, and as phase 3's band cases at D 16 / 32),
   the full-width prefill shape and a ragged full-width case (L=4000,
   kv_valid, packed documents); and at the head dims above 128 that the
   reference's configs use (192, 240, 288) and at head dim 320 (padded to
   384): causal with GQA group 2 on a ragged length, softcap 50, a window
   shorter than L, a zigzag band, a kv_valid cut, packed documents with
   the skip on and off, gemma2-2b's full training shape (B=2, L=4096, 8 /
   4 heads, D=288, causal, softcap 50) and the ragged case at its width
   (L=4000, kv_valid, packed documents); and the shapes the paths give
   the kernels at D 16 / 32 and 384 (phase 6's reduced qwen3-1.7b, B=1,
   L=1024, 4 / 2 heads, D 16; phase 8's timing shape, B=2, L=4096, 16 / 8
   heads, D 32; gemma2-2b's training shape at head dim 320 with softcap 50
   and without); each in fp32 and bf16.  Every case must hold the
   reference suite's elementwise tolerance (fp32 2e-5, bf16 2e-2), a
   norm-relative out error (fp32 2e-5, bf16 1e-2: one bf16 rounding step
   is at most 2^-7 relative) and lse within 1e-4 on the rows that see a
   key, and go through the route ``fwd_route`` picks: in bf16 the
   tensor-core kernels at every width (sm90n at D 16 / 32, sm90 at 64 /
   128, sm90w above), in fp32 the 3xTF32 tensor-core kernels, tf32x3 up
   to D 128 and tf32x3w above.
3. The dq and dk/dv kernels against their plain version on every case of
   the CPU parity suite (sweep and band cases), phase 2's band cases at
   D 64 / 128, phase 2's cases above D 128, the full-width training shapes
   of qwen3-1.7b and gemma2-2b and a ragged full-width case (L=4000,
   kv_valid, packed documents), fp32 and bf16: max error within atol 5e-4
   / rtol 1e-3 in fp32 (the reference suite's backward tolerance) and
   2e-2 in bf16, norm-relative error within 2e-5 / 1e-2.  Each kernel must
   go through the route ``bwd_route`` picks for it: above D 128 the sm90w
   tensor-core dq and dk/dv in bf16 (at D 384 their own source) and the
   3xTF32 tensor-core kernels of the tf32x3w route in fp32 (at every width
   above 128), at D 384 on every phase-2 case at head dim 320 and, in both
   dtypes, gemma2-2b's full training shape at head dim 320 with softcap 50
   and the ragged case at that width; the sm90 tensor-core kernels
   for bf16 at D in {64, 128}, the sm90n tensor-core kernels for bf16 at
   D in {16, 32}
   (every bf16 case of the sweep at D 16, 24, 32 and of the band cases,
   kv_valid and packed documents with the skip on and off, and, in bf16
   only, the shapes the paths give them: phase 6's reduced qwen3-1.7b,
   B=1, L=1024, 4 / 2 heads, D 16, causal, and phase 8's timing shape,
   B=2, L=4096, 16 / 8 heads, D 32, causal), the 3xTF32
   tensor-core kernels for fp32 up to D 128 (each fp32 operand split into
   a TF32 hi and lo, three TF32 products a product: about 21 of fp32's 24
   mantissa bits, so the fp32 tolerances stand).
4. Serving qwen3-1.7b at full width: random bf16 weights from a seed,
   greedy ``generate`` of 32 tokens for 2 prompts of 4096 tokens.  Prefill
   must launch the sm90 forward kernel once per layer (and no other
   forward and no backward kernel), the tokens must lie in the vocabulary, and
   the last-token logits must match a prefill on plain attention (cosine
   >= 0.999).
5. Serving timings with CUDA events (both forward routes at the
   full-width shape, the sm90 kernel in bf16 and the tf32x3 kernel in
   fp32, one call at a time and back to back, each beside its plain
   version, ``scaled_dot_product_attention`` in the same dtype (in fp32
   with ``enable_gqa`` and on repeated K/V) and its bound: 989 TFLOP/s in
   bf16, three TF32 passes at 495 in fp32, beside the ceiling the
   ``mma.sync`` TF32 probe reaches, measured here; prefill, a decode step)
   and ``torch.profiler`` over one prefill and one decode step.
6. The whole model at full width and depth 2, ``forward_loss`` and its
   backward on the kernels and on the dense oracle: qwen3-1.7b at B=1,
   L=4096, gemma2-2b (one local layer with its 4096 window, one global)
   at B=1, L=8192, so the window cuts, gemma2-2b at head dim 320 (padded
   to 384) at B=1, L=4096, and qwen3-1.7b's reduced config (head dim 16)
   at B=1, L=1024.  In fp32 (qwen3 and reduced: the tf32x3 forward, dq
   and dk/dv; gemma2 at both head dims: the tf32x3w forward, dq and dk/dv;
   2 launches each): loss within 1e-5 relative,
   every grad leaf within 1e-4
   norm-relative.  In bf16 (qwen3: the sm90 kernels; gemma2 at both head
   dims: the sm90w kernels; reduced: the sm90n kernels): loss within 1e-2
   of the bf16 oracle;
   every grad leaf within
   1e-2 of the bf16 oracle's, or, where the bf16 oracle itself lies
   further than that from the fp32 oracle, no further from it than that
   (all norm-relative to the fp32 oracle's leaf).
7. Training at full depth through ``launch/train.py``'s path
   (``Trainer``), 3 steps of 2 microbatches of 1 x 4096 tokens each:
   qwen3-1.7b, exactly 56 forward (scpp), 56 dq and 56 dk/dv launches a
   step, all on the sm90 route; then gemma2-2b, exactly 52 of each, all
   on the sm90w route.  Finite
   losses, step 0 within 1.5 of ln(vocab).
   Step time by CUDA events, tokens/s, MFU, peak memory; more steps timed,
   and ``torch.profiler`` over one step of each.
8. The backward kernels' times at qwen3-1.7b's training shape (the sm90
   kernels in bf16, the 3xTF32 kernels in fp32; the sm90n kernels, which
   serve bf16 at D 16 / 32, in bf16 at D=32 on phase 3's case of that
   shape) beside their bounds, the
   plain version and SDPA's backward in the same dtype (timed alone: one
   forward, then the median of 21 ``autograd.grad`` calls with
   ``retain_graph``, with its spread; in fp32 both with ``enable_gqa``
   and on repeated K/V), each kernel and SDPA also back to back (20 calls
   between two events, median of 5), which leaves out the host's time to
   launch a call.  The 3xTF32 rows carry two bounds (three TF32
   passes a product at 495 TFLOP/s, and 67 TFLOP/s of fp32 off the tensor
   cores) and the ceiling ``mma.sync`` TF32 reached in the probe.  Then
   the forward, dq and dk/dv at gemma2-2b's training shape on the routes
   they take there (bf16: sm90w; fp32: tf32x3w), beside their bounds (the
   dtype's rate: 989 TFLOP/s in bf16, three TF32 passes at 495 TFLOP/s in
   fp32; and 67 TFLOP/s of fp32 off the tensor cores),
   the plain version and SDPA in the same dtype on repeated K/V with the
   backend that ran named (SDPA has no softcap, so it computes the causal
   shape without one; the kernels are timed without the softcap too, the
   same function as SDPA's; every kernel and SDPA also back to back).
   Then the rows no training step runs: the bf16 forward at D 32 (the
   sm90n route) at qwen3-1.7b's shape, one call at a time and back to
   back, beside its tensor bound and the special-function unit's floor
   (one exp2 a score, 16 a clock an SM at the card's maximum SM clock);
   and at head dim 320 (padded 384) at gemma2-2b's shape the forward, dq
   and dk/dv, in bf16 (all sm90w) and in fp32 (all tf32x3w), with softcap
   50 and without, one call at a time
   and back to back, each beside its bounds, the plain version and SDPA
   (forward, and backward alone), also both ways.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}   # ||d|| / ||plain||
LSE_TOL = 1e-4
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 495e12        # H100 SXM dense TF32 tensor-core rate
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
ARCH = "qwen3-1.7b"
# The CUDA sources phase 1 builds, one nvcc each, in parallel.
SOURCES = ["flash_fwd_tf32x3", "flash_fwd_sm90", "flash_fwd_sm90_narrow",
           "flash_fwd_sm90_wide", "flash_fwd_sm90_d384",
           "flash_fwd_tf32x3_wide", "flash_bwd_sm90", "flash_bwd_sm90_narrow",
           "flash_dq_sm90_wide", "flash_dkv_sm90_wide", "flash_bwd_sm90_d384",
           "flash_bwd_tf32x3", "flash_bwd_tf32x3_wide"]
GEMMA = "gemma2-2b"
# gemma2-2b at head dim 320 (padded to 384), the one path of phase 6 that
# runs the bf16 kernels at D 384 (sm90w, the forward's and the backward's
# own sources).
GEMMA320 = "gemma2-2b-hd320"
# qwen3-1.7b's reduced config (2 layers, 4 / 2 heads of head dim 16), the
# one path of phase 6 that runs the narrow kernels (sm90n) in bf16.
REDUCED, REDUCED_L = "qwen3-1.7b-smoke", 1024
REDUCED_HQ, REDUCED_HKV, REDUCED_D = 4, 2, 16
BATCH, PROMPT, GEN = 2, 4096, 32
GEMMA_L = 8192                  # phase 6: twice gemma2-2b's 4096 window

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
        m90 = re.search(r"(flash_[a-z]+_(sm90[wn]?|tf32x3w?)_kernel)ILi(\d+)E",
                        line)
        if "Compiling entry function" in line and m:
            dtype = "bf16" if "bfloat16" in m.group(2) else "fp32"
            name = (f"{m.group(1)}<{dtype}, D={m.group(3)}, "
                    f"tile={m.group(4)}>")
        elif "Compiling entry function" in line and m90:
            dtype = "fp32" if m90.group(2).startswith("tf32x3") else "bf16"
            tile = 32 if m90.group(2) == "tf32x3w" else 64
            name = f"{m90.group(1)}<{dtype}, D={m90.group(3)}, tile={tile}>"
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


def cuda_loop_times(fn, calls: int = 20, reps: int = 5,
                    warmup: int = 3) -> list:
    """Milliseconds a call of ``fn()``: ``reps`` timings of ``calls`` calls
    back to back between two CUDA events, each divided by ``calls``.  The
    host stays ahead of the card, so its time to launch a call, which
    ``cuda_times`` counts, is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


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
        for name, (b, lq, lk, hq, hkv, d), kw in [
                *((name, shape[:6], on_card(shape[6]))
                  for name, shape in EXTRA.items()),
                *above_128_shapes()]:
            cases.append((f"{name}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype), kw))
    # The shapes the paths give the forward at D 16 / 32 (phase 6's reduced
    # qwen3-1.7b, phase 8's timing shape at D 32: bf16's sm90n, fp32's
    # tf32x3) and at D 384 (gemma2-2b's training shape at head dim 320, with
    # its softcap and without: bf16's sm90w, fp32's tf32x3w), in both dtypes.
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for name, (b, lq, lk, hq, hkv, d), kw in (
                *narrow_full_shapes(),
                ("gemma2-d320-full", (BATCH, PROMPT, PROMPT, GEMMA_HQ,
                                      GEMMA_HKV, 320),
                 dict(causal=True, softcap=GEMMA_CAP)),
                ("gemma2-d320-nocap-full", (BATCH, PROMPT, PROMPT, GEMMA_HQ,
                                            GEMMA_HKV, 320),
                 dict(causal=True))):
            cases.append((f"{name}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype), kw))
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
    check(moved == expected_launches(1, 0, {"fwd": route}),
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
# (route, kernel) of every backward kernel phase 3 must run.
# The sm90w pair at D 384 (its own source) apart as "sm90w384".
BWD_KERNELS = (("sm90", "dq"), ("sm90", "dkv"), ("tf32x3", "dq"),
               ("tf32x3", "dkv"), ("sm90n", "dq"), ("sm90n", "dkv"),
               ("sm90w", "dq"), ("sm90w", "dkv"), ("sm90w384", "dq"),
               ("sm90w384", "dkv"), ("tf32x3w", "dq"), ("tf32x3w", "dkv"))
# Phase 2's band cases at their widths (D 64 and 128, so bf16 takes the
# sm90 route): zigzag ring steps (i, j) of cp=4 over chunks of 128, a
# kv_valid cut, packed documents with the K-tile skip on and off.
_BAND_DOC = np.repeat([0, 100, 230, 400], [100, 130, 170, 112])[None]
BANDS = {
    **{f"zigzag{i}{j}-band": (1, 256, 256, 8, 4, 64,
                              dict(causal=True, band=(i, j, 128, 4)))
       for i, j in ((1, 2), (2, 2), (3, 0))},
    "kv_valid-band": (2, 200, 448, 8, 4, 128,
                      dict(causal=True, kv_valid_len=301)),
    **{f"doc_skip{int(skip)}-band": (2, 512, 512, 8, 4, 64,
                                     dict(causal=True,
                                          q_doc_start=_BAND_DOC.repeat(2, 0),
                                          doc_skip=skip))
       for skip in (True, False)},
}
# The cases above D 128 (phases 2 and 3), at each width the
# reference's configs use (deepseek-v2-lite MLA's 192, gemma3-12b's 240,
# gemma2-2b's 288): name -> (b, lq, lk, hq, hkv, keyword arguments), GQA
# group 2 throughout, ragged lengths; ``band`` as in ``BANDS``.
ABOVE_128_D = (192, 240, 288)
ABOVE_128 = {
    "causal": (2, 200, 200, 8, 4, dict(causal=True)),
    "softcap": (1, 256, 256, 8, 4, dict(causal=True, softcap=50.0)),
    "window": (1, 320, 320, 4, 2, dict(causal=True, window=100,
                                       softcap=50.0)),
    "zigzag": (1, 256, 256, 8, 4, dict(causal=True, band=(1, 2, 128, 4))),
    "kv_valid": (2, 200, 448, 8, 4, dict(causal=True, kv_valid_len=301)),
    **{f"doc_skip{int(skip)}": (2, 512, 512, 4, 2,
                                dict(causal=True,
                                     q_doc_start=_BAND_DOC.repeat(2, 0),
                                     doc_skip=skip))
       for skip in (True, False)},
}
# The cases of ``ABOVE_128`` that also run at head dim 320, which pads to
# 384: all of them.  There bf16's three kernels take the sm90w route, and
# fp32's forward the wide one and its dq and dk/dv the tf32x3w one.
AT_384 = tuple(ABOVE_128)
# gemma2-2b's training shape (B, L, Hq, Hkv, D; causal, softcap 50).
GEMMA_HQ, GEMMA_HKV, GEMMA_D, GEMMA_CAP = 8, 4, 288, 50.0


def on_card(kw: dict) -> dict:
    """A case's keyword arguments with its band as a ``BandMask`` and its
    doc table on the card."""
    from repro_torch.kernels.ref import BandMask

    kw = dict(kw)
    if "band" in kw:
        kw["band"] = BandMask.zigzag(*kw["band"])
    if "q_doc_start" in kw:
        kw["q_doc_start"] = torch.as_tensor(kw["q_doc_start"],
                                            dtype=torch.int32, device="cuda")
    return kw


def above_128_shapes():
    """(name, (b, lq, lk, hq, hkv, d), keyword arguments) of the cases
    above D 128 and at head dim 320, then gemma2-2b's full training shape
    (``gemma2-full``) and the ragged full-width case at its width
    (``gemma2-ragged``)."""
    out = [(f"{name}-d{d}", (b, lq, lk, hq, hkv, d), on_card(kw))
           for d in ABOVE_128_D
           for name, (b, lq, lk, hq, hkv, kw) in ABOVE_128.items()]
    out += [(f"{name}-d320", (*ABOVE_128[name][:5], 320),
             on_card(ABOVE_128[name][5])) for name in AT_384]
    out.append(("gemma2-full", (BATCH, PROMPT, PROMPT, GEMMA_HQ, GEMMA_HKV,
                                GEMMA_D),
                dict(causal=True, softcap=GEMMA_CAP)))
    out.append(("gemma2-ragged", (1, RAGGED_L, RAGGED_L, GEMMA_HQ, GEMMA_HKV,
                                  GEMMA_D),
                on_card(dict(causal=True, softcap=GEMMA_CAP,
                             kv_valid_len=RAGGED_KV,
                             q_doc_start=RAGGED_DOC[None]))))
    return out
# The ragged full-width case: L=4000 (not a multiple of any tile), keys cut
# at 3900, four packed documents.
RAGGED_L, RAGGED_KV = 4000, 3900
RAGGED_DOC = np.repeat([0, 1111, 2345, 3500], [1111, 1234, 1155, 500])


def narrow_full_shapes():
    """(name, (b, lq, lk, hq, hkv, d), keyword arguments) of the sm90n
    kernels' shapes on the paths: phase 6's reduced qwen3-1.7b
    (``reduced-full``) and phase 8's timing shape at D 32
    (``train-d32-full``), both causal."""
    return [("reduced-full", (1, REDUCED_L, REDUCED_L, REDUCED_HQ,
                              REDUCED_HKV, REDUCED_D), dict(causal=True)),
            ("train-d32-full", (BATCH, PROMPT, PROMPT, TRAIN_HQ, TRAIN_HKV,
                                32), dict(causal=True))]


def d384_full_shapes():
    """(name, (b, lq, lk, hq, hkv, d), keyword arguments) of the
    backward's shapes at head dim 320 (padded to 384: in bf16 the sm90w
    pair's own source, in fp32 the tf32x3w pair's D 384 instantiation, as
    phase 6's fp32 run at that width drives it): gemma2-2b's training shape
    with its softcap
    (``gemma2-d320-full``) and the ragged case at that width
    (``gemma2-d320-ragged``: L=4000, kv_valid, packed documents)."""
    return [("gemma2-d320-full", (BATCH, PROMPT, PROMPT, GEMMA_HQ, GEMMA_HKV,
                                  320), dict(causal=True, softcap=GEMMA_CAP)),
            ("gemma2-d320-ragged", (1, RAGGED_L, RAGGED_L, GEMMA_HQ,
                                    GEMMA_HKV, 320),
             on_card(dict(causal=True, softcap=GEMMA_CAP,
                          kv_valid_len=RAGGED_KV,
                          q_doc_start=RAGGED_DOC[None])))]


def bwd_cases(gen: torch.Generator):
    """(name, q, k, v, do, keyword arguments) on the card: the CPU parity
    suite's sweep and band cases, the band cases at phase 2's widths, the
    cases above D 128 and gemma2-2b's training shape, then qwen3-1.7b's
    full-width training shape and the ragged full-width case, the D 384
    pair's shapes at head dim 320 (``d384_full_shapes``); in bf16 last the
    sm90n kernels' shapes on the paths (``reduced-full``,
    ``train-d32-full``)."""
    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        shapes = [(f"sweep{i}", (b, lq, lk, hq, hkv, d),
                   dict(causal=causal, window=window, softcap=cap))
                  for i, (b, lq, lk, hq, hkv, d, causal, window, cap)
                  in enumerate(SWEEP)]
        for name, (b, lq, lk, hq, hkv, d, kw) in {**EXTRA, **BANDS}.items():
            shapes.append((name, (b, lq, lk, hq, hkv, d), on_card(kw)))
        shapes.extend(above_128_shapes())
        shapes.append(("train-full", (BATCH, PROMPT, PROMPT, TRAIN_HQ,
                                      TRAIN_HKV, TRAIN_D), dict(causal=True)))
        shapes.append(("train-ragged", (1, RAGGED_L, RAGGED_L, TRAIN_HQ,
                                        TRAIN_HKV, TRAIN_D),
                       dict(causal=True, kv_valid_len=RAGGED_KV,
                            q_doc_start=torch.as_tensor(
                                RAGGED_DOC[None], dtype=torch.int32,
                                device="cuda"))))
        # The pair at D 384 (bf16: sm90w; fp32: tf32x3w) at gemma2-2b's
        # training shape and a ragged one at head dim 320.
        shapes.extend(d384_full_shapes())
        if dtype == torch.bfloat16:
            # The sm90n kernels at the shapes the paths give them: phase
            # 6's reduced qwen3-1.7b and phase 8's timing shape at D 32.
            shapes.extend(narrow_full_shapes())
        for name, (b, lq, lk, hq, hkv, d), kw in shapes:
            cases.append((f"{name}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lq, hq, d, dtype=dtype), kw))
    return cases


def check_bwd(name, q, k, v, do, kw):
    """dq and dk/dv kernels against ``_bwd_plain`` on the same folded
    operands and the same ``(out, lse)``, each through the route
    ``bwd_route`` picks for it.  Returns ``{"dq": route, "dkv": route}``,
    ``{"dq": (max |err|, norm-relative err), "dk": ..., "dv": ...}`` and
    the folded call for timing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad

    d = q.shape[3]
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, **kw)
    dof = _fold_pad(do, qf.shape[2])
    out, lse = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    dsum = (dof.float() * out.float()).sum(dim=-1)
    routes = {key: fa.bwd_route(qf.dtype, qf.shape[2], key)
              for key in ("dq", "dkv")}
    n0 = launch_counts()
    got = fa._bwd_cuda(qf, kf, vf, dof, lse, dsum, p, band, doc)
    torch.cuda.synchronize()
    moved = launches_since(n0)
    check(moved == expected_launches(0, 1, routes),
          f"{name} launched {moved}, expected one dq and one dk/dv launch "
          f"on the routes {routes}")
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
    route = "/".join(dict.fromkeys(routes.values()))
    print(f"  {name:18s} {route:4s} max|err|/norm-rel: {'  '.join(parts)}  "
          f"(tol {atol:g}+{rtol:g}|x|, {BWD_REL_TOL[q.dtype]:g})  "
          f"{'ok' if good else 'FAIL'}")
    check(good, f"backward kernels disagree with their plain version on "
                f"{name}")
    del want, got
    return routes, errs, (qf, kf, vf, dof, lse, dsum, p, band, doc)


def bwd_bound(q, k, n_products: int, dtype: torch.dtype,
              peak: float | None = None, passes: int = 1):
    """(bound ms, bound_by, FLOP) of one backward kernel at a causal shape:
    ``n_products`` products of 2*D FLOPs per visible (q, k) pair, each
    issued ``passes`` times, against ``peak`` FLOP/s (by default the rate
    of ``dtype``: 989 TFLOP/s on the bf16 tensor cores, 67 TFLOP/s of fp32
    off them; the 3xTF32 kernels take passes=3 at 495 TFLOP/s of TF32), or
    the bytes it must move (q, k, v, dO read; its outputs written; lse and
    dsum) against 3.35 TB/s.  The FLOP returned counts one pass."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    pairs = lq * (lq + 1) // 2
    flops = n_products * 2 * b * hq * d * pairs
    item = dtype.itemsize
    q_bytes, kv_bytes = b * lq * hq * d * item, b * lq * hkv * d * item
    out_bytes = q_bytes if n_products == 3 else 2 * kv_bytes
    nbytes = 2 * q_bytes + 2 * kv_bytes + out_bytes + 2 * b * hq * lq * 4
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = passes * flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def fwd_bound(q, k, dtype: torch.dtype, peak: float | None = None,
              passes: int = 1):
    """(bound ms, bound_by, FLOP) of the forward kernel at a causal shape:
    two products of 2*D FLOPs per visible (q, k) pair, each issued
    ``passes`` times, against ``peak`` FLOP/s (by default the rate of
    ``dtype``, as in ``bwd_bound``; the 3xTF32 kernels take passes=3 at 495
    TFLOP/s of TF32), or the bytes it must move (q, k, v read; out and lse
    written) against 3.35 TB/s.  The FLOP returned counts one pass."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    flops = 4 * b * hq * d * (lq * (lq + 1) // 2)
    item = dtype.itemsize
    nbytes = (2 * b * lq * hq * d + 2 * b * lq * hkv * d) * item \
        + b * hq * lq * 4
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = passes * flops / peak, nbytes / PEAK_BYTES
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
            "fwd_sm90": fa.FWD_SM90_LAUNCHES,
            "fwd_sm90n": fa.FWD_SM90N_LAUNCHES,
            "fwd_tf32x3": fa.FWD_TF32X3_LAUNCHES,
            "dq_sm90": fa.DQ_SM90_LAUNCHES, "dkv_sm90": fa.DKV_SM90_LAUNCHES,
            "dq_tf32x3": fa.DQ_TF32X3_LAUNCHES,
            "dkv_tf32x3": fa.DKV_TF32X3_LAUNCHES,
            "dq_sm90n": fa.DQ_SM90N_LAUNCHES,
            "dkv_sm90n": fa.DKV_SM90N_LAUNCHES,
            "fwd_tf32x3w": fa.FWD_TF32X3W_LAUNCHES,
            "dq_tf32x3w": fa.DQ_TF32X3W_LAUNCHES,
            "dkv_tf32x3w": fa.DKV_TF32X3W_LAUNCHES,
            "fwd_sm90w": fa.FWD_SM90W_LAUNCHES,
            "dq_sm90w": fa.DQ_SM90W_LAUNCHES,
            "dkv_sm90w": fa.DKV_SM90W_LAUNCHES}


def launches_since(n0: dict) -> dict:
    return {key: n - n0[key] for key, n in launch_counts().items()}


def expected_launches(fwd: int, bwd: int, routes: dict) -> dict:
    """``launch_counts`` after ``fwd`` forward launches on
    ``routes["fwd"]``, ``bwd`` dq launches on ``routes["dq"]`` and ``bwd``
    dk/dv launches on ``routes["dkv"]``."""
    want = {key: 0 for key in launch_counts()}
    want.update(flash_fwd=fwd, flash_bwd_dq=bwd, flash_bwd_dkv=bwd)
    if fwd:
        want[f"fwd_{routes['fwd']}"] = fwd
    if bwd:
        want[f"dq_{routes['dq']}"] = want[f"dkv_{routes['dkv']}"] = bwd
    return want


def routes_of(dtype: torch.dtype, d: int) -> dict:
    """The route of each kernel at a dtype and padded head dim."""
    from repro_torch.kernels import flash_attention as fa
    return {"fwd": fa.fwd_route(dtype, d), "dq": fa.bwd_route(dtype, d, "dq"),
            "dkv": fa.bwd_route(dtype, d, "dkv")}


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fa.FWD_SM90_LAUNCHES = fa.FWD_SM90N_LAUNCHES = 0
    fa.FWD_TF32X3_LAUNCHES = fa.FWD_TF32X3W_LAUNCHES = 0
    fa.DQ_SM90_LAUNCHES = fa.DKV_SM90_LAUNCHES = 0
    fa.DQ_TF32X3_LAUNCHES = fa.DKV_TF32X3_LAUNCHES = 0
    fa.DQ_SM90N_LAUNCHES = fa.DKV_SM90N_LAUNCHES = 0
    fa.DQ_TF32X3W_LAUNCHES = fa.DKV_TF32X3W_LAUNCHES = 0
    fa.FWD_SM90W_LAUNCHES = fa.DQ_SM90W_LAUNCHES = fa.DKV_SM90W_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Phase 6: the whole model, kernels against the dense oracle
# ---------------------------------------------------------------------------

# (arch, dtype) -> the route of each kernel; dtype -> (loss tolerance
# (relative), grad tolerance (norm-relative)).  fp32 keeps fp32 accuracy
# (3xTF32 products of about 21 mantissa bits in every fp32 kernel), so its
# differences are those of reordered sums; bf16 takes the bf16 kernel
# tolerance.
MODEL_ROUTES = {
    (ARCH, "float32"): {"fwd": "tf32x3", "dq": "tf32x3", "dkv": "tf32x3"},
    (ARCH, "bfloat16"): {"fwd": "sm90", "dq": "sm90", "dkv": "sm90"},
    (GEMMA, "float32"): {"fwd": "tf32x3w", "dq": "tf32x3w",
                         "dkv": "tf32x3w"},
    (GEMMA, "bfloat16"): {"fwd": "sm90w", "dq": "sm90w", "dkv": "sm90w"},
    (GEMMA320, "float32"): {"fwd": "tf32x3w", "dq": "tf32x3w",
                            "dkv": "tf32x3w"},
    (GEMMA320, "bfloat16"): {"fwd": "sm90w", "dq": "sm90w", "dkv": "sm90w"},
    (REDUCED, "float32"): {"fwd": "tf32x3", "dq": "tf32x3",
                           "dkv": "tf32x3"},
    (REDUCED, "bfloat16"): {"fwd": "sm90n", "dq": "sm90n", "dkv": "sm90n"}}
MODEL_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
#: arch -> sequence length of its whole-model check (B=1).
MODEL_L = {ARCH: PROMPT, GEMMA: GEMMA_L, GEMMA320: PROMPT,
           REDUCED: REDUCED_L}


def model_config(arch: str):
    """The full-width config of a phase 6 ``arch`` (gemma2-2b at head dim
    320 for ``GEMMA320``; qwen3-1.7b's reduced config for ``REDUCED``)."""
    from repro_torch.configs import get_config, get_reduced

    if arch == REDUCED:
        return get_reduced(ARCH)
    if arch == GEMMA320:
        return dataclasses.replace(get_config(GEMMA), head_dim=320)
    return get_config(arch)


def model_runs(arch: str, dtype: str) -> dict:
    """A full-width, depth-2 ``forward_loss`` of ``arch`` and its backward
    at B=1, L=``MODEL_L[arch]`` in ``dtype`` (the same fp32 masters from
    seed 1), on the kernels and on ``impl="ref"``: ``{impl: (loss, grads,
    launches)}``."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import forward_loss, init_params

    cfg = dataclasses.replace(model_config(arch), num_layers=2, dtype=dtype)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MODEL_L[arch],
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
        torch.cuda.empty_cache()
    want = expected_launches(2, 2, MODEL_ROUTES[arch, dtype])
    check(runs["cuda"][2] == want,
          f"the {arch} {dtype} kernel run launched {runs['cuda'][2]}, "
          f"expected {want}")
    check(not any(runs["ref"][2].values()),
          f"the {arch} {dtype} ref run launched kernels: {runs['ref'][2]}")
    check(all(bool(torch.isfinite(g).all()) for g in runs["cuda"][1]),
          f"non-finite grads on the {arch} {dtype} kernels")
    return runs


def model_check(arch: str):
    """``arch``'s model on the kernels against the dense oracle, in fp32
    and in bf16.  Returns ``{dtype: (relative loss difference, worst
    norm-relative grad difference, the kernel run's launch counts)}``.

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
    r32 = model_runs(arch, "float32")
    (lk, gk, _), (lr, g32, _) = r32["cuda"], r32["ref"]
    loss_tol, grad_tol = MODEL_TOL["float32"]
    loss_rel = abs(lk - lr) / abs(lr)
    grad_rel = max(rel(a, b, b) for a, b in zip(gk, g32))
    print(f"    float32: loss kernels {lk:.6f}, ref {lr:.6f}: relative "
          f"difference {loss_rel:.3e} (tol {loss_tol:g}); worst grad leaf "
          f"norm-relative difference {grad_rel:.3e} over {len(gk)} leaves "
          f"(tol {grad_tol:g}); routes {MODEL_ROUTES[arch, 'float32']}")
    check(loss_rel <= loss_tol and grad_rel <= grad_tol,
          f"the fp32 {arch} on the kernels disagrees with the dense oracle")
    out["float32"] = (loss_rel, grad_rel, r32["cuda"][2])
    del r32, gk
    torch.cuda.empty_cache()

    r16 = model_runs(arch, "bfloat16")
    (lk, gk, _), (lr, gr, _) = r16["cuda"], r16["ref"]
    loss_tol, grad_tol = MODEL_TOL["bfloat16"]
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
          f"routes {MODEL_ROUTES[arch, 'bfloat16']}")
    check(loss_rel <= loss_tol and ok,
          f"the bf16 {arch} on the kernels disagrees with the dense oracle")
    out["bfloat16"] = (loss_rel, leaf[worst][0], r16["cuda"][2])
    return out


# ---------------------------------------------------------------------------
# Phase 7: training at full depth
# ---------------------------------------------------------------------------

def train_argv(arch: str) -> list:
    """``launch/train.py``'s arguments for phase 7: 3 steps of 2
    microbatches of 1 x 4096 tokens."""
    return ["--arch", arch, "--seq-len", str(PROMPT), "--global-batch",
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


def train_phase(argv: list):
    """``launch/train.py``'s path for ``argv`` through ``Trainer``;
    returns the record of the run and the trainer."""
    from repro_torch.launch import train as launch_train

    plan, trainer = launch_train.make_trainer(launch_train.parse_args(argv))
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


def training_run(arch: str, routes: dict, n_steady: int) -> dict:
    """Phase 7 for one architecture: the 3 counted steps (finite losses,
    step 0 within 1.5 of ln(vocab), every launch of every step on its
    kernel's route in ``routes``), ``n_steady`` more timed steps and one
    profiled step.  Returns the run's record; the trainer is freed."""
    argv = train_argv(arch)
    print(f"    {arch}: python -m repro_torch.launch.train {' '.join(argv)}")
    run, trainer = train_phase(argv)
    tcfg = run["plan"].cfg
    n_layers, accum = tcfg.num_layers, run["plan"].grad_accum
    losses = run["losses"]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"{arch} training losses {losses}")
    check(abs(losses[0] - np.log(tcfg.vocab)) <= 1.5,
          f"{arch} step-0 loss {losses[0]} is not within 1.5 of ln(vocab) "
          f"= {np.log(tcfg.vocab):.2f}")
    fwd_per_step = {"none": 1, "scpp": 1, "full": 2}[tcfg.remat] \
        * n_layers * accum
    want = expected_launches(fwd_per_step, n_layers * accum, routes)
    check(all(step == want for step in run["launches"]),
          f"{arch} launches per step {run['launches']}, expected {want}")
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
    extra_ms = steady_steps(trainer, n_steady)
    steady = statistics.median(extra_ms)
    print(f"    {n_steady} more steps of the same trainer: "
          f"{[round(x, 2) for x in extra_ms]} ms, median {steady:.2f} ms = "
          f"{tokens_per_step * 1e3 / steady:.0f} tokens/s, "
          f"{100 * model_flops / (steady * 1e-3) / PEAK_BF16_FLOPS:.2f}% of "
          f"989 TFLOP/s; card right after: {smi_sample()}")
    batch = trainer._to_device(trainer.data.batch(3))
    prof, _ = profile_call(
        lambda: trainer.step_fn(trainer.params, trainer.opt_state, batch),
        top=12)
    print(f"    training step: {prof}")
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return run


def smi_sample() -> str:
    """The card's SM clock, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def load_probe():
    """``scripts/mma_tf32_probe.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "mma_tf32_probe", ROOT / "scripts" / "mma_tf32_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sdpa_backend(q, k, v):
    """The first SDPA backend (flash, cuDNN, memory-efficient, math) that
    runs causal attention forward and backward on these ``(B, H, L, D)``
    operands; flash attention stops at D 256."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")     # why a backend declined
                out = sdpa(q, k, v, is_causal=True)
                torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("chip_smoke: no SDPA backend ran")


def gemma_timings(gemma_full: dict) -> dict:
    """The kernels at gemma2-2b's training shape (phase 3's
    ``gemma2-full`` operands, causal, softcap 50) on the routes each dtype
    takes there (bf16: the three sm90w kernels; fp32: the three tf32x3w
    kernels): CUDA events around each kernel, the plain version, SDPA on
    repeated K/V in the same dtype (causal without a softcap: SDPA has
    none; the forward, and the backward alone as in the other rows) with
    its backend, and the bounds at the dtype's rate (fp32: three TF32
    passes at 495 TFLOP/s) and at the 67 TFLOP/s of fp32 off the tensor
    cores.  The three kernels are also timed without the softcap
    (``"nocap"``), the function SDPA computes, and every kernel and SDPA
    back to back (``"loop"``), the kernels with the softcap and without.
    Returns ``{dtype: {...}}``."""
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, (qf, kf, vf, dof, lse, dsum, p, band, doc) = \
            gemma_full[dtype]
        routes = routes_of(dtype, qf.shape[2])
        n0 = launch_counts()
        fwd_ms = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc))
        check(launches_since(n0) == expected_launches(9, 0, routes),
              f"the gemma2 forward timing left the {routes['fwd']} route")
        n0 = launch_counts()
        dq_ms = cuda_ms(lambda: fa._dq_cuda(qf, kf, vf, dof, lse, dsum, p,
                                            band, doc))
        dkv_ms = cuda_ms(lambda: fa._dkv_cuda(qf, kf, vf, dof, lse, dsum, p,
                                              band, doc))
        check(launches_since(n0) == expected_launches(0, 9, routes),
              f"the gemma2 backward timing left the routes {routes}")
        p0 = p._replace(softcap=0.0)
        out0, lse0 = fa._fwd_plain(qf, kf, vf, p0, band=band, doc=doc)
        dsum0 = (dof.float() * out0.float()).sum(dim=-1)
        del out0
        n0 = launch_counts()
        nocap = {
            "fwd": cuda_ms(lambda: fa._fwd(qf, kf, vf, p0, band=band,
                                           doc=doc)),
            "dq": cuda_ms(lambda: fa._dq_cuda(qf, kf, vf, dof, lse0, dsum0,
                                              p0, band, doc)),
            "dkv": cuda_ms(lambda: fa._dkv_cuda(qf, kf, vf, dof, lse0,
                                                dsum0, p0, band, doc))}
        check(launches_since(n0) == expected_launches(9, 9, routes),
              f"the gemma2 timing without softcap left the routes {routes}")
        n0 = launch_counts()
        loop = {}
        for cap_tag, pc, lse_c, dsum_c in (("", p, lse, dsum),
                                           ("_nocap", p0, lse0, dsum0)):
            loop["fwd" + cap_tag] = statistics.median(cuda_loop_times(
                lambda: fa._fwd(qf, kf, vf, pc, band=band, doc=doc)))
            for key, fn in (("dq", fa._dq_cuda), ("dkv", fa._dkv_cuda)):
                loop[key + cap_tag] = statistics.median(cuda_loop_times(
                    lambda: fn(qf, kf, vf, dof, lse_c, dsum_c, pc, band,
                               doc)))
        check(launches_since(n0) == expected_launches(206, 206, routes),
              f"the gemma2 back-to-back timing left the routes {routes}")
        del lse0, dsum0
        fwd_plain_ms = cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p,
                                                     band=band, doc=doc),
                               reps=5)
        out_p, _ = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
        bwd_plain_ms = cuda_ms(lambda: fa._bwd_plain(
            qf, kf, vf, out_p, lse, dof, p, band, doc), reps=5)
        del out_p
        group = q.shape[2] // k.shape[2]
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        kr, vr = (t.detach().repeat_interleave(group, dim=1).requires_grad_()
                  for t in (kt, vt))
        backend = sdpa_backend(qt, kr, vr)
        with sdpa_kernel([backend]):
            def lib_fwd():
                return sdpa(qt.detach(), kr.detach(), vr.detach(),
                            is_causal=True)

            lib_fwd_ms = cuda_ms(lib_fwd)
            lib_fwd_loop = statistics.median(cuda_loop_times(lib_fwd))
            del kr, vr, lib_fwd
            sdpa_out = sdpa(qt, kt.repeat_interleave(group, dim=1),
                            vt.repeat_interleave(group, dim=1),
                            is_causal=True)

            def lib_grad():
                return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                           retain_graph=True)

            lib_bwd = cuda_times(lib_grad, reps=21, warmup=3)
            lib_bwd_loop = statistics.median(cuda_loop_times(lib_grad))
        del sdpa_out, qt, kt, vt, dot, lib_grad
        torch.cuda.empty_cache()
        # fp32's rate: three TF32 passes at 495 TFLOP/s.
        tf32 = ((PEAK_TF32_FLOPS, 3) if dtype == torch.float32
                else (None, 1))
        tm = out[dtype] = {
            "fwd": (fwd_ms, *fwd_bound(q, k, dtype, *tf32)[:2],
                    fwd_bound(q, k, dtype, PEAK_FP32_FLOPS)[0]),
            "dq": (dq_ms, *bwd_bound(q, k, 3, dtype, *tf32)[:2],
                   bwd_bound(q, k, 3, dtype, PEAK_FP32_FLOPS)[0]),
            "dkv": (dkv_ms, *bwd_bound(q, k, 4, dtype, *tf32)[:2],
                    bwd_bound(q, k, 4, dtype, PEAK_FP32_FLOPS)[0]),
            "fwd_plain": fwd_plain_ms, "bwd_plain": bwd_plain_ms,
            "fwd_library": lib_fwd_ms, "fwd_library_loop": lib_fwd_loop,
            "bwd_library": statistics.median(lib_bwd),
            "bwd_library_loop": lib_bwd_loop,
            "backend": backend.name, "routes": routes, "nocap": nocap,
            "loop": loop}
        b, lq, hq, d = q.shape
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"    gemma2-2b kernels at B={b} L={lq} Hq={hq} "
              f"Hkv={k.shape[2]} D={d} causal softcap {GEMMA_CAP:g} {tag}:")
        for key, label, flops in (
                ("fwd", "forward", fwd_bound(q, k, dtype)[2]),
                ("dq", "dq", bwd_bound(q, k, 3, dtype)[2]),
                ("dkv", "dk/dv", bwd_bound(q, k, 4, dtype)[2])):
            ms, bound, by, bound_fma = tm[key]
            rate = ("3 TF32 passes at 495 TFLOP/s" if tf32[1] == 3
                    else f"the {tag} rate")
            print(f"      {label} ({routes[key]}) kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s); bound {bound:.4f} ms "
                  f"({by}: {flops / 1e9:.1f} GFLOP at {rate}; "
                  f"{100 * bound / ms:.2f}% of it); at 67 TFLOP/s of fp32 "
                  f"FMA {bound_fma:.4f} ms ({100 * bound_fma / ms:.1f}%); "
                  f"without the softcap {nocap[key]:.4f} ms "
                  f"({100 * bound / nocap[key]:.2f}% of the bound); back "
                  f"to back {loop[key]:.4f} ms, without the softcap "
                  f"{loop[key + '_nocap']:.4f}")
        print(f"      pair (dq + dk/dv) softcap {GEMMA_CAP:g}: "
              f"{dq_ms + dkv_ms:.4f} ms one call at a time, "
              f"{loop['dq'] + loop['dkv']:.4f} back to back; without it "
              f"{nocap['dq'] + nocap['dkv']:.4f} / "
              f"{loop['dq_nocap'] + loop['dkv_nocap']:.4f}")
        print(f"      plain forward {fwd_plain_ms:.4f} ms, plain backward "
              f"(dq, dk, dv in one call) {bwd_plain_ms:.4f} ms; sdpa "
              f"({backend.name}, repeated kv, no softcap) forward "
              f"{lib_fwd_ms:.4f} ms (back to back {lib_fwd_loop:.4f}), "
              f"backward alone median "
              f"{statistics.median(lib_bwd):.4f} ms over 21, min "
              f"{min(lib_bwd):.4f}, max {max(lib_bwd):.4f}; back to back "
              f"{lib_bwd_loop:.4f}")
    return out


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi ``clocks.max.sm``), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()
    return float(out[0]) * 1e6


def exp2_floor_ms(q) -> float:
    """The special-function unit's floor of a causal forward: one exp2 a
    visible score, 16 a clock an SM at the card's maximum SM clock."""
    b, lq, hq, _ = q.shape
    scores = b * hq * (lq * (lq + 1) // 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return scores / (16 * sms * max_sm_clock_hz()) * 1e3


def fwd_d32_timings(case) -> dict:
    """The forward at qwen3-1.7b's training shape at D 32 in bf16 (phase
    3's train-d32-full case), the sm90n route's width: the kernel (one call
    a timing, and back to back), its bounds (989 TFLOP/s, and 67 of the FMA
    cores) and the special-function unit's exp2 floor, the plain version
    and SDPA's forward (``enable_gqa``) on the same inputs."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _, (qf, kf, vf, _, _, _, p, band, doc) = case
    x = [qf, kf, vf]
    n0 = launch_counts()
    ms = cuda_ms(lambda: fa._fwd(*x, p, band=band, doc=doc))
    loop = statistics.median(cuda_loop_times(
        lambda: fa._fwd(*x, p, band=band, doc=doc)))
    check(launches_since(n0) == expected_launches(112, 0, {"fwd": "sm90n"}),
          "the bf16 D 32 forward timing left the sm90n route")
    plain = cuda_ms(lambda: fa._fwd_plain(*x, p, band=band, doc=doc),
                    reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    lib_loop = statistics.median(cuda_loop_times(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))
    bound, by, flops = fwd_bound(q, k, torch.bfloat16)
    out = dict(ms=ms, loop=loop, bound=bound, by=by, flops=flops,
               bound_fma=fwd_bound(q, k, torch.bfloat16,
                                   PEAK_FP32_FLOPS)[0],
               exp2_floor=exp2_floor_ms(q), plain=plain, library=lib,
               library_loop=lib_loop)
    b_, lq, hq, _ = q.shape
    print(f"    forward (sm90n) at B={b_} L={lq} Hq={hq} Hkv={k.shape[2]} "
          f"D=32 causal bf16: kernel {ms:.4f} ms (back to back {loop:.4f}); "
          f"bound {bound:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP at 989 "
          f"TFLOP/s; {100 * bound / ms:.2f}% of it, back to back "
          f"{100 * bound / loop:.2f}%); exp2 floor {out['exp2_floor']:.4f} "
          f"ms (one exp2 a score, 16 a clock an SM at the maximum SM clock; "
          f"{100 * out['exp2_floor'] / ms:.2f}% of it, back to back "
          f"{100 * out['exp2_floor'] / loop:.2f}%); at 67 TFLOP/s of fp32 "
          f"FMA {out['bound_fma']:.4f} ms; plain {plain:.4f} ms; "
          f"sdpa(enable_gqa) forward {lib:.4f} ms (back to back "
          f"{lib_loop:.4f})")
    return out


def d384_timings(gen: torch.Generator, dtype: torch.dtype) -> dict:
    """The three kernels at head dim 320 (padded to 384; bf16: the sm90w
    forward, dq and dk/dv; fp32: the tf32x3w forward, dq and dk/dv) at
    gemma2-2b's training shape (causal), each with softcap 50 and without
    (the function SDPA computes), one call a timing and back to back;
    their bounds (the function's FLOPs at D 320 at the dtype's rate: 989
    TFLOP/s in bf16, three TF32 passes at 495 in fp32; and at 67 of fp32
    off the tensor cores; the kernels' padded work is 384 / 320 of it),
    the plain version and SDPA
    on repeated K/V with the backend that runs at D 320 (no softcap),
    forward and backward alone, also both ways.  Returns ``{key: ...}``."""
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad

    b, l, hq, hkv, d = BATCH, PROMPT, GEMMA_HQ, GEMMA_HKV, 320
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype)
                   for shape in ((b, l, hq, d), (b, l, hkv, d),
                                 (b, l, hkv, d), (b, l, hq, d)))
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, causal=True,
                                                softcap=GEMMA_CAP)
    p0 = p._replace(softcap=0.0)
    dof = _fold_pad(do, qf.shape[2])
    stats = {}     # softcap -> the plain forward's (out, lse) and dsum
    for pc in (p, p0):
        out_c, lse_c = fa._fwd_plain(qf, kf, vf, pc, band=band, doc=doc)
        stats[pc.softcap] = (out_c, lse_c,
                             (dof.float() * out_c.float()).sum(dim=-1))
    routes = routes_of(dtype, qf.shape[2])
    check(routes == ({"fwd": "sm90w", "dq": "sm90w", "dkv": "sm90w"}
                     if dtype == torch.bfloat16 else
                     {"fwd": "tf32x3w", "dq": "tf32x3w",
                      "dkv": "tf32x3w"}),
          f"D 384 took the routes {routes}")

    def call(key, pc):
        _, lse_c, dsum_c = stats[pc.softcap]
        if key == "fwd":
            return lambda: fa._fwd(qf, kf, vf, pc, band=band, doc=doc)
        fn = fa._dq_cuda if key == "dq" else fa._dkv_cuda
        return lambda: fn(qf, kf, vf, dof, lse_c, dsum_c, pc, band, doc)

    # (key, "" or "_nocap") -> one call a timing, back to back
    ms, loop = {}, {}
    n0 = launch_counts()
    for key in ("fwd", "dq", "dkv"):
        for tag, pc in (("", p), ("_nocap", p0)):
            ms[key + tag] = cuda_ms(call(key, pc))
            loop[key + tag] = statistics.median(cuda_loop_times(call(key,
                                                                     pc)))
    check(launches_since(n0) == expected_launches(224, 224, routes),
          f"the D 384 timing left the routes {routes}")
    out, lse, _ = stats[p.softcap]
    plain = {"fwd": cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p, band=band,
                                                  doc=doc), reps=5),
             "bwd": cuda_ms(lambda: fa._bwd_plain(qf, kf, vf, out, lse, dof,
                                                  p, band, doc), reps=5)}
    del out, lse, stats
    group = hq // hkv
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    kr, vr = (t.detach().repeat_interleave(group, dim=1).requires_grad_()
              for t in (kt, vt))
    backend = sdpa_backend(qt, kr, vr)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel([backend]):
        def lib_fwd_call():
            return sdpa(qt.detach(), kr.detach(), vr.detach(),
                        is_causal=True)

        sdpa_out = sdpa(qt, kt.repeat_interleave(group, dim=1),
                        vt.repeat_interleave(group, dim=1), is_causal=True)

        def lib_bwd_call():
            return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib = {"fwd": cuda_ms(lib_fwd_call),
               "bwd": cuda_ms(lib_bwd_call, reps=21, warmup=3)}
        lib_loop = {"fwd": statistics.median(cuda_loop_times(lib_fwd_call)),
                    "bwd": statistics.median(cuda_loop_times(lib_bwd_call))}
    del sdpa_out, qt, kt, vt, kr, vr, dot
    torch.cuda.empty_cache()
    res = {"backend": backend.name}
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    # fp32's rate: three TF32 passes at 495 TFLOP/s.
    tf32 = (None, 1) if dtype == torch.bfloat16 else (PEAK_TF32_FLOPS, 3)
    rate = ("989 TFLOP/s" if tf32[1] == 1
            else "3 TF32 passes at 495 TFLOP/s")
    for key, n, label in (("fwd", None, "forward"), ("dq", 3, "dq"),
                          ("dkv", 4, "dk/dv")):
        if n is None:
            bound, by, flops = fwd_bound(q, k, dtype, *tf32)
            bound_fma = fwd_bound(q, k, dtype, PEAK_FP32_FLOPS)[0]
        else:
            bound, by, flops = bwd_bound(q, k, n, dtype, *tf32)
            bound_fma = bwd_bound(q, k, n, dtype, PEAK_FP32_FLOPS)[0]
        which = "fwd" if key == "fwd" else "bwd"
        res[key] = dict(ms=ms[key], loop=loop[key], nocap=ms[key + "_nocap"],
                        nocap_loop=loop[key + "_nocap"], bound=bound, by=by,
                        bound_fma=bound_fma, plain=plain[which],
                        library=lib[which], library_loop=lib_loop[which])
        print(f"    {label} ({routes[key]}) at B={b} L={l} Hq={hq} Hkv={hkv} "
              f"head dim 320 (padded 384) causal {tag}: softcap "
              f"{GEMMA_CAP:g} {ms[key]:.4f} ms (back to back "
              f"{loop[key]:.4f}), without the softcap "
              f"{ms[key + '_nocap']:.4f} ms (back to back "
              f"{loop[key + '_nocap']:.4f}; "
              f"{100 * bound / loop[key + '_nocap']:.2f}% of the bound, "
              f"which the padding to 384 raises 1.2x); bound {bound:.4f} ms "
              f"({by}: {flops / 1e9:.1f} GFLOP at D 320 at {rate}), at "
              f"67 TFLOP/s {bound_fma:.4f} ms")
    print(f"    pair (dq + dk/dv) {tag}: softcap {GEMMA_CAP:g} "
          f"{ms['dq'] + ms['dkv']:.4f} ms one call at a time, "
          f"{loop['dq'] + loop['dkv']:.4f} back to back; without it "
          f"{ms['dq_nocap'] + ms['dkv_nocap']:.4f} / "
          f"{loop['dq_nocap'] + loop['dkv_nocap']:.4f}")
    print(f"    plain forward {plain['fwd']:.4f} ms, plain backward (dq, dk, "
          f"dv) {plain['bwd']:.4f} ms; sdpa ({backend.name}, repeated kv, no "
          f"softcap) forward {lib['fwd']:.4f} ms (back to back "
          f"{lib_loop['fwd']:.4f}), backward alone {lib['bwd']:.4f} ms (back "
          f"to back {lib_loop['bwd']:.4f})")
    return res


def gemma_record(key, dtype, tpu_line, tpu_kernel, source, gemma, launches,
                 launches_in, errs) -> dict:
    """The kernels line's record of the ``key`` kernel (``fwd``, ``dq`` or
    ``dkv``) on the route ``dtype`` takes at gemma2-2b's width, with its
    times in ``dtype`` and, where the other dtype takes the same route,
    those too.  ``errs`` is (max |err|, lse or norm-relative err, cases)
    over every case of that route."""
    tm = gemma[dtype]
    route = tm["routes"][key]
    which = "fwd" if key == "fwd" else "bwd"
    ms, bound, by, bound_fma = tm[key]
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    rec = {"name": f"flash_fwd_{route}" if key == "fwd"
           else f"flash_bwd_{key}_{route}",
           "route": "cuda", "kernel_route": route, "source": source,
           "replaces": f"src/repro/kernels/flash_attention.py:{tpu_line}",
           "tpu_kernel": tpu_kernel, "launches": launches,
           "launches_in": launches_in, "cases": errs[2],
           "max_abs_err": errs[0], "ms": ms,
           "plain_ms": tm[f"{which}_plain"], "bound_ms": bound,
           "bound_by": by, "bound_fma_ms": bound_fma,
           "library_ms": tm[f"{which}_library"],
           "library": f"sdpa {tm['backend']}, repeated kv, no softcap",
           "dtype": tag, "head_dim": GEMMA_D}
    rec["max_lse_err" if key == "fwd" else "max_norm_rel_err"] = errs[1]
    rec["softcap0_ms"] = tm["nocap"][key]
    rec.update(ms_back_to_back=tm["loop"][key],
               softcap0_ms_back_to_back=tm["loop"][key + "_nocap"],
               library_ms_back_to_back=tm[f"{which}_library_loop"])
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    to = gemma[other]
    if to["routes"][key] == route:
        otag = "fp32" if other == torch.float32 else "bf16"
        rec.update({f"{otag}_ms": to[key][0],
                    f"{otag}_plain_ms": to[f"{which}_plain"],
                    f"{otag}_bound_ms": to[key][1],
                    f"{otag}_library_ms": to[f"{which}_library"]})
    return rec


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
    probe = load_probe()
    with ThreadPoolExecutor(1) as pool:
        probe_lib = pool.submit(probe.build)
        records = build.build_all(SOURCES)
        probe_lib = probe_lib.result()
    print(f"    built the {len(SOURCES)} libraries and the mma.sync TF32 "
          f"probe in parallel in {time.perf_counter() - t0:.2f} s")
    for lib_name, record in records.items():
        print(f"    {record['path'].name}: nvcc {record['seconds']:.2f} s")
        for name, regs, spills in ptxas_summary(record["log"]):
            print(f"    ptxas {name}: {regs} registers, {spills} bytes "
                  "spilled")

    # -- phase 2 ------------------------------------------------------------
    print("[2] forward kernels (bf16: sm90n route at D in "
          f"{fa.SM90N_FWD_D}, sm90 at D in {fa.SM90_FWD_D}, sm90w at D in "
          f"{fa.SM90W_FWD_D}; fp32: tf32x3 route at D in {fa.TF32X3_D}, "
          f"tf32x3w route at D in {fa.WIDE_D}) against their plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # route -> [max |out err|, max |lse err|, cases]; the sm90w forward at
    # D 384 (its own source) apart as "sm90w384".
    fwd_worst = {r: [0.0, 0.0, 0] for r in ("sm90n", "sm90", "sm90w",
                                             "sm90w384", "tf32x3",
                                             "tf32x3w")}
    full = {}
    for name, q, k, v, kw in kernel_cases(gen):
        route, err, lse_err, folded = check_kernel(name, q, k, v, kw)
        d_pad = folded[0].shape[2]
        if q.dtype == torch.bfloat16:
            want = ("sm90n" if d_pad <= 32 else "sm90" if d_pad <= 128
                    else "sm90w")
        else:
            want = "tf32x3" if d_pad <= 128 else "tf32x3w"
        check(route == want,
              f"{name}: padded D {d_pad} took the {route} route")
        w = fwd_worst["sm90w384" if route == "sm90w" and d_pad == 384
                      else route]
        w[0], w[1], w[2] = max(w[0], err), max(w[1], lse_err), w[2] + 1
        if name.startswith("prefill-full-"):
            full[q.dtype] = (q, k, v, folded)
        del q, k, v, folded
    check(all(w[2] > 0 for w in fwd_worst.values()),
          "a forward route ran no case")
    print("    " + "; ".join(
        f"{r} ({n} cases) worst out max|err| {e:.3e}, lse max|err| {le:.3e}"
        for r, (e, le, n) in fwd_worst.items()))
    torch.cuda.empty_cache()

    # -- phase 3 ------------------------------------------------------------
    print("[3] dq and dk/dv kernels (sm90w route for bf16 at D in "
          f"{fa.SM90W_BWD_D}, tf32x3w route for fp32 at D in {fa.WIDE_D}, sm90 "
          f"route for bf16 at D in {fa.SM90_BWD_D}, sm90n route for bf16 at "
          f"D in {fa.SM90N_BWD_D}, tf32x3 route for fp32 at D in "
          f"{fa.TF32X3_D}) against their plain version")
    # (route, kernel) -> [max |err|, norm-relative err, cases]
    worst = {rk: [0.0, 0.0, 0] for rk in BWD_KERNELS}
    bwd_passed, bwd_full, narrow_full, gemma_full = 0, None, None, {}
    for name, q, k, v, do, kw in bwd_cases(gen):
        routes, errs, folded = check_bwd(name, q, k, v, do, kw)
        at_384 = folded[0].shape[2] == 384
        for label, (err, rel) in errs.items():
            key = "dq" if label == "dq" else "dkv"
            route = routes[key]
            w = worst["sm90w384" if route == "sm90w" and at_384 else route,
                      key]
            w[0], w[1] = max(w[0], err), max(w[1], rel)
            w[2] += label != "dv"
        wide = folded[0].shape[2] > 128
        bf16 = q.dtype == torch.bfloat16
        tc = bf16 and folded[0].shape[2] in fa.SM90W_BWD_D
        check(routes["dq"] == routes["dkv"] == ("sm90w" if tc else "tf32x3w")
              if wide else routes["dq"] == routes["dkv"] not in ("sm90w",
                                                                 "tf32x3w"),
              f"{name}: padded D {folded[0].shape[2]} took the routes "
              f"{routes}")
        check(bf16 or routes["dq"] == ("tf32x3w" if wide else "tf32x3"),
              f"{name}: an fp32 case took the routes {routes}")
        check(not bf16 or (folded[0].shape[2] in fa.SM90N_BWD_D)
              == (routes["dq"] == "sm90n"),
              f"{name}: padded D {folded[0].shape[2]} took the routes "
              f"{routes}")
        bwd_passed += 1
        if name == "train-full-bf16":
            bwd_full = (q, k, v, do, folded)
        if name == "train-d32-full-bf16":
            narrow_full = (q, k, v, do, folded)
        if name.startswith("gemma2-full-"):
            gemma_full[q.dtype] = (q, k, v, do, folded)
        del q, k, v, do, folded
        torch.cuda.empty_cache()
    check(all(w[2] > 0 for w in worst.values()),
          "a backward kernel's route ran no case")
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
    probe_tflops = probe.measure(probe_lib)["best_tflops"]
    print(f"    mma.sync m16n8k8 TF32 probe (scripts/mma_tf32_probe.py): "
          f"best {probe_tflops:.1f} TFLOP/s of TF32 "
          f"({100 * probe_tflops * 1e12 / PEAK_TF32_FLOPS:.1f}% of 495)")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_timings = {}
    # The sm90 kernel on the bf16 operands, the tf32x3 kernel on the same
    # shape in fp32; each one call at a time and back to back, beside the
    # plain version and SDPA in its dtype.
    for route, dtype in (("sm90", torch.bfloat16),
                         ("tf32x3", torch.float32)):
        q, k, v, (qf, kf, vf, p, band, doc) = full[dtype]
        n0 = launch_counts()
        kernel_ms = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band,
                                            doc=doc))
        loop_ms = statistics.median(cuda_loop_times(
            lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc)))
        moved = launches_since(n0)   # 2 + 7 one at a time, 3 + 5 x 20 b2b
        check(moved == expected_launches(112, 0, {"fwd": route}),
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
        # fp32's rate: three TF32 passes at 495 TFLOP/s.
        tf32 = ((PEAK_TF32_FLOPS, 3) if dtype == torch.float32
                else (None, 1))
        bound_ms, bound_by, flops = fwd_bound(q, k, dtype, *tf32)
        fwd_timings[route] = dict(ms=kernel_ms, loop=loop_ms, plain=plain_ms,
                                  library=library_ms,
                                  library_rep=library_rep_ms, bound=bound_ms,
                                  by=bound_by)
        b, lq, hq, d = q.shape
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"    flash_fwd {route} at B={b} L={lq} Hq={hq} "
              f"Hkv={k.shape[2]} D={d} causal {tag}: kernel "
              f"{kernel_ms:.4f} ms (back to back {loop_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, sdpa(enable_gqa) {library_ms:.4f} ms, "
              f"sdpa(repeated kv) {library_rep_ms:.4f} ms")
        line = (f"    {route}: bound {bound_ms:.4f} ms ({bound_by}: "
                f"{flops / 1e9:.1f} GFLOP")
        if dtype == torch.float32:
            ceiling = 3 * flops / (probe_tflops * 1e12) * 1e3
            bound_fma = fwd_bound(q, k, dtype, PEAK_FP32_FLOPS)[0]
            fwd_timings[route].update(probe_ceiling=ceiling,
                                      bound_fma=bound_fma)
            line += (f" x 3 TF32 passes at 495 TFLOP/s); at the probe's "
                     f"{probe_tflops:.1f} TFLOP/s {ceiling:.4f} ms; at 67 "
                     f"TFLOP/s of fp32 FMA {bound_fma:.4f} ms")
        else:
            line += " at 989 TFLOP/s)"
        print(line + f"; kernel at {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
              f"{100 * bound_ms / kernel_ms:.2f}% of the bound, back to "
              f"back {100 * bound_ms / loop_ms:.2f}%")
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
    print(f"[6] whole model: full width at depth 2, fp32 and bf16, "
          "forward_loss + backward on the kernels and on the dense oracle")
    model = {}
    for arch in (ARCH, GEMMA, GEMMA320, REDUCED):
        print(f"    {arch} at B=1 L={MODEL_L[arch]}:")
        model[arch] = model_check(arch)
        torch.cuda.empty_cache()

    # -- phase 7 ------------------------------------------------------------
    print("[7] training at full depth through launch/train.py's path")
    run = training_run(ARCH, MODEL_ROUTES[ARCH, "bfloat16"], 5)
    gemma_run = training_run(GEMMA, MODEL_ROUTES[GEMMA, "bfloat16"], 3)

    # -- phase 8 ------------------------------------------------------------
    print("[8] backward timings at qwen3-1.7b's training shape, then the "
          "kernels above D 128 at gemma2-2b's, and at head dim 320")
    b, lq, hq, _ = bwd_full[0].shape
    timings = {}
    # The sm90 kernels on phase 3's train-full bf16 operands and the tf32x3
    # kernels on the same operands in fp32, at D=128; the sm90n kernels,
    # which serve bf16 at D 16 / 32, on phase 3's train-d32-full case (the
    # same shape at D 32).  Each beside the plain version and SDPA's
    # backward in the same dtype, all from the plain forward's (out, lse)
    # at that dtype and width; each kernel and SDPA also timed back to back
    # (``cuda_loop_times``).
    for route, dtype, dh, case in (("sm90", torch.bfloat16, 128, bwd_full),
                                   ("tf32x3", torch.float32, 128, bwd_full),
                                   ("sm90n", torch.bfloat16, 32,
                                    narrow_full)):
        q, k, v, do, (qf, kf, vf, dof, _, _, p, band, doc) = case
        x = [t[..., :dh].to(dtype).contiguous() for t in (qf, kf, vf, dof)]
        out_x, lse_x = fa._fwd_plain(x[0], x[1], x[2], p, band=band, doc=doc)
        dsum_x = (x[3].float() * out_x.float()).sum(dim=-1)
        n0 = launch_counts()
        dq_ms = cuda_ms(lambda: fa._dq_cuda(x[0], x[1], x[2], x[3], lse_x,
                                            dsum_x, p, band, doc))
        dkv_ms = cuda_ms(lambda: fa._dkv_cuda(x[0], x[1], x[2], x[3], lse_x,
                                              dsum_x, p, band, doc))
        moved = launches_since(n0)          # 2 warm-ups + 7 timed, each
        check(moved == expected_launches(0, 9, {"dq": route, "dkv": route}),
              f"the {route} timing launched {moved}")
        n0 = launch_counts()
        loop = {"dq": statistics.median(cuda_loop_times(
            lambda: fa._dq_cuda(x[0], x[1], x[2], x[3], lse_x, dsum_x, p,
                                band, doc))),
                "dkv": statistics.median(cuda_loop_times(
                    lambda: fa._dkv_cuda(x[0], x[1], x[2], x[3], lse_x,
                                         dsum_x, p, band, doc)))}
        moved = launches_since(n0)          # 3 warm-ups + 5 x 20, each
        check(moved == expected_launches(0, 103, {"dq": route,
                                                  "dkv": route}),
              f"the {route} back-to-back timing launched {moved}")
        bwd_plain_ms = cuda_ms(lambda: fa._bwd_plain(
            x[0], x[1], x[2], out_x, lse_x, x[3], p, band, doc), reps=5)
        del out_x, lse_x, dsum_x, x
        qt, kt, vt = (t[..., :dh].to(dtype).transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        dot = do[..., :dh].to(dtype).transpose(1, 2).contiguous()
        group = hq // kt.shape[1]
        lib = {}
        for how in ("enable_gqa", "repeated kv")[:2 if route == "tf32x3"
                                                 else 1]:
            if how == "enable_gqa":
                sdpa_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            else:   # K/V repeated in the graph: its backward sums the group
                sdpa_out = sdpa(qt, kt.repeat_interleave(group, dim=1),
                                vt.repeat_interleave(group, dim=1),
                                is_causal=True)
            def grad():
                return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                           retain_graph=True)

            lib[how] = cuda_times(grad, reps=21, warmup=3)
            loop[how] = statistics.median(cuda_loop_times(grad))
            del sdpa_out, grad
        del qt, kt, vt, dot
        torch.cuda.empty_cache()
        qd = q[..., :dh]
        if route == "tf32x3":
            bounds = {n: bwd_bound(qd, k, n, dtype, PEAK_TF32_FLOPS, 3)
                      for n in (3, 4)}
            fma_bounds = {n: bwd_bound(qd, k, n, dtype)[0] for n in (3, 4)}
        else:
            bounds = {n: bwd_bound(qd, k, n, dtype) for n in (3, 4)}
        tm = timings[route] = dict(
            dq=(dq_ms, *bounds[3][:2]), dkv=(dkv_ms, *bounds[4][:2]),
            plain=bwd_plain_ms, dh=dh, extra={}, loop=loop,
            library={how: statistics.median(ts) for how, ts in lib.items()})
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"    {route} at B={b} L={lq} Hq={hq} Hkv={k.shape[2]} D={dh} "
              f"causal {tag}:")
        for key, label, n, ms in (("dq", "dq", 3, dq_ms),
                                  ("dkv", "dk/dv", 4, dkv_ms)):
            bound, by, flops = bounds[n]
            line = (f"      {label} kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                    f"TFLOP/s, one pass counted); bound {bound:.4f} ms "
                    f"({by}: {flops / 1e9:.1f} GFLOP")
            if route == "tf32x3":
                ceiling = 3 * flops / (probe_tflops * 1e12) * 1e3
                tm["extra"][key] = dict(bound_fma_ms=fma_bounds[n],
                                       probe_ceiling_ms=ceiling)
                line += (f" x 3 TF32 passes at 495 TFLOP/s; "
                         f"{100 * bound / ms:.1f}% of it); at the probe's "
                         f"{probe_tflops:.1f} TFLOP/s {ceiling:.4f} ms; the "
                         f"bound at 67 TFLOP/s of fp32 FMA "
                         f"{fma_bounds[n]:.4f} ms")
            else:
                line += f"; {100 * bound / ms:.1f}% of it)"
            print(line)
        print(f"      plain backward (dq, dk, dv in one call) "
              f"{bwd_plain_ms:.4f} ms; " + "; ".join(
                  f"sdpa({how}) backward alone (one forward, then "
                  f"autograd.grad with retain_graph) median "
                  f"{statistics.median(ts):.4f} ms over 21, min "
                  f"{min(ts):.4f}, max {max(ts):.4f}"
                  for how, ts in lib.items()))
        print(f"      back to back (20 calls between two events, median of "
              f"5): dq {loop['dq']:.4f} ms, dk/dv {loop['dkv']:.4f} ms; "
              + "; ".join(f"sdpa({how}) backward {loop[how]:.4f} ms"
                          for how in lib))
    gemma = gemma_timings(gemma_full)
    fwd_d32 = fwd_d32_timings(narrow_full)
    del gemma_full
    torch.cuda.empty_cache()
    d384 = d384_timings(gen, torch.bfloat16)
    d384_fp32 = d384_timings(gen, torch.float32)

    def bwd_record(route, key, tpu_line, tpu_kernel, source):
        ms, bound, by = timings[route][key]
        label = f"{key}_{route}"
        if route == "tf32x3":   # this slice's path: phase 6's fp32 model
            launches, path = (model[ARCH]["float32"][2][label],
                              "phase 6 fp32 model")
        elif route == "sm90n":  # phase 6's reduced bf16 model (D 16)
            launches, path = (model[REDUCED]["bfloat16"][2][label],
                              "phase 6 reduced qwen3-1.7b bf16 model")
        else:
            launches, path = run["totals"][label], "phase 7 training step"
        rec = {"name": f"flash_bwd_{key}_{route}", "route": "cuda",
               "kernel_route": route, "source": source,
               "replaces": f"src/repro/kernels/flash_attention.py:{tpu_line}",
               "tpu_kernel": tpu_kernel, "launches": launches,
               "launches_in": path, "cases": worst[route, key][2],
               "max_abs_err": worst[route, key][0],
               "max_norm_rel_err": worst[route, key][1], "ms": ms,
               "plain_ms": timings[route]["plain"], "bound_ms": bound,
               "bound_by": by,
               "library_ms": timings[route]["library"]["enable_gqa"],
               "ms_back_to_back": timings[route]["loop"][key],
               "library_ms_back_to_back": timings[route]["loop"][
                   "enable_gqa"],
               "dtype": "fp32" if route == "tf32x3" else "bf16",
               "head_dim": timings[route]["dh"]}
        if route == "tf32x3":
            rec.update(timings[route]["extra"][key],
                       probe_tflops=probe_tflops,
                       library_repeated_kv_ms=timings[route]["library"][
                           "repeated kv"])
        return rec

    def fwd_record(route, source):
        """The sm90 forward's record (launches in phase 7's bf16 training
        step) or the tf32x3 forward's (phase 6's fp32 model run, its
        path), with its phase-5 times."""
        t = fwd_timings[route]
        rec = {"name": f"flash_fwd_{route}", "route": "cuda",
                "kernel_route": route, "source": source,
                "replaces": "src/repro/kernels/flash_attention.py:145",
                "tpu_kernel": "_fwd_kernel",
                "launches": (run["totals"] if route == "sm90" else
                             model[ARCH]["float32"][2])[f"fwd_{route}"],
                "launches_in": ("phase 7 training step" if route == "sm90"
                                else "phase 6 fp32 model"),
                "serve_launches": serve_launches[f"fwd_{route}"],
                "model_fp32_launches": model[ARCH]["float32"][2][
                    f"fwd_{route}"],
                "cases": fwd_worst[route][2],
                "max_abs_err": fwd_worst[route][0],
                "max_lse_err": fwd_worst[route][1], "ms": t["ms"],
                "ms_back_to_back": t["loop"],
                "plain_ms": t["plain"], "bound_ms": t["bound"],
                "bound_by": t["by"], "library_ms": t["library"],
                "library": "sdpa enable_gqa",
                "library_repeated_kv_ms": t["library_rep"],
                "dtype": "bf16" if route == "sm90" else "fp32",
                "head_dim": 128}
        if route == "tf32x3":
            rec.update(probe_tflops=probe_tflops,
                       probe_ceiling_ms=t["probe_ceiling"],
                       bound_fma_ms=t["bound_fma"])
        return rec

    def narrow_fwd_record():
        """The sm90n forward's record: its times at D 32 (phase 8), its
        launches in phase 6's reduced bf16 model run."""
        t = fwd_d32
        return {"name": "flash_fwd_sm90n", "route": "cuda",
                "kernel_route": "sm90n",
                "source": csrc + "flash_fwd_sm90_narrow.cu",
                "replaces": "src/repro/kernels/flash_attention.py:145",
                "tpu_kernel": "_fwd_kernel",
                "launches": model[REDUCED]["bfloat16"][2]["fwd_sm90n"],
                "launches_in": "phase 6 reduced qwen3-1.7b bf16 model",
                "cases": fwd_worst["sm90n"][2],
                "max_abs_err": fwd_worst["sm90n"][0],
                "max_lse_err": fwd_worst["sm90n"][1], "ms": t["ms"],
                "ms_back_to_back": t["loop"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["by"],
                "exp2_floor_ms": t["exp2_floor"],
                "bound_fma_ms": t["bound_fma"], "library_ms": t["library"],
                "library_ms_back_to_back": t["library_loop"],
                "library": "sdpa enable_gqa", "dtype": "bf16", "head_dim": 32}

    def d384_record(key, tpu_line, tpu_kernel, source, errs):
        """The record of an sm90w kernel at D 384: its times at head dim 320
        (phase 8), its launches in phase 6's gemma2-2b head-dim-320 bf16
        model run; ``errs`` as ``gemma_record``'s."""
        r = d384[key]
        rec = {"name": ("flash_fwd_sm90w_d384" if key == "fwd"
                        else f"flash_bwd_{key}_sm90w_d384"),
               "route": "cuda", "kernel_route": "sm90w",
               "source": csrc + source,
               "replaces": f"src/repro/kernels/flash_attention.py:{tpu_line}",
               "tpu_kernel": tpu_kernel,
               "launches": model[GEMMA320]["bfloat16"][2][f"{key}_sm90w"],
               "launches_in": "phase 6 gemma2-2b head dim 320 bf16 model",
               "cases": errs[2], "max_abs_err": errs[0], "ms": r["ms"],
               "ms_back_to_back": r["loop"], "softcap0_ms": r["nocap"],
               "softcap0_ms_back_to_back": r["nocap_loop"],
               "plain_ms": r["plain"], "bound_ms": r["bound"],
               "bound_by": r["by"], "bound_fma_ms": r["bound_fma"],
               "library_ms": r["library"],
               "library_ms_back_to_back": r["library_loop"],
               "library": f"sdpa {d384['backend']}, repeated kv, no softcap",
               "dtype": "bf16", "head_dim": 320, "padded_head_dim": 384}
        rec["max_lse_err" if key == "fwd" else "max_norm_rel_err"] = errs[1]
        return rec

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        fwd_record("sm90", csrc + "flash_fwd_sm90.cu"),
        narrow_fwd_record(),
        fwd_record("tf32x3", csrc + "flash_fwd_tf32x3.cu"),
        *(bwd_record(route, key, line, tpu, csrc + source)
          for route, source in (("sm90", "flash_bwd_sm90.cu"),
                                ("tf32x3", "flash_bwd_tf32x3.cu"),
                                ("sm90n", "flash_bwd_sm90_narrow.cu"))
          for key, line, tpu in (("dq", 289, "_dq_kernel"),
                                 ("dkv", 331, "_dkv_kernel"))),
        # gemma2-2b's width: the bf16 training step's kernels (sm90w),
        # then the tf32x3w forward, dq and dk/dv, which serve fp32 there
        # (phase 6's gemma2-2b fp32 run).
        *(gemma_record(key, dtype, line, tpu, csrc + source, gemma,
                       launches, where, errs)
          for key, dtype, line, tpu, source, launches, where, errs in (
              ("fwd", torch.bfloat16, 145, "_fwd_kernel",
               "flash_fwd_sm90_wide.cu", gemma_run["totals"]["fwd_sm90w"],
               "phase 7 gemma2-2b training", fwd_worst["sm90w"]),
              ("dq", torch.bfloat16, 289, "_dq_kernel",
               "flash_dq_sm90_wide.cu", gemma_run["totals"]["dq_sm90w"],
               "phase 7 gemma2-2b training", worst["sm90w", "dq"]),
              ("dkv", torch.bfloat16, 331, "_dkv_kernel",
               "flash_dkv_sm90_wide.cu", gemma_run["totals"]["dkv_sm90w"],
               "phase 7 gemma2-2b training", worst["sm90w", "dkv"]),
              ("fwd", torch.float32, 145, "_fwd_kernel",
               "flash_fwd_tf32x3_wide.cu",
               model[GEMMA]["float32"][2]["fwd_tf32x3w"],
               "phase 6 gemma2-2b fp32 model", fwd_worst["tf32x3w"]),
              ("dq", torch.float32, 289, "_dq_kernel",
               "flash_bwd_tf32x3_wide.cu",
               model[GEMMA]["float32"][2]["dq_tf32x3w"],
               "phase 6 gemma2-2b fp32 model", worst["tf32x3w", "dq"]),
              ("dkv", torch.float32, 331, "_dkv_kernel",
               "flash_bwd_tf32x3_wide.cu",
               model[GEMMA]["float32"][2]["dkv_tf32x3w"],
               "phase 6 gemma2-2b fp32 model", worst["tf32x3w", "dkv"]))),
        # D 384 (head dim 320): phase 6's gemma2-2b head-dim-320 bf16 run.
        d384_record("fwd", 145, "_fwd_kernel", "flash_fwd_sm90_d384.cu",
                    fwd_worst["sm90w384"]),
        d384_record("dq", 289, "_dq_kernel", "flash_bwd_sm90_d384.cu",
                    worst["sm90w384", "dq"]),
        d384_record("dkv", 331, "_dkv_kernel", "flash_bwd_sm90_d384.cu",
                    worst["sm90w384", "dkv"])]
    # The tf32x3w rows also carry their times at head dim 320 (padded 384),
    # their launches in phase 6's head-dim-320 fp32 run and the mma.sync
    # probe's ceiling.
    for rec in kernels:
        if rec["kernel_route"] == "tf32x3w":
            key = ("fwd" if rec["tpu_kernel"] == "_fwd_kernel"
                   else "dq" if "_dq_" in rec["name"] else "dkv")
            r = d384_fp32[key]
            rec.update(
                probe_tflops=probe_tflops,
                probe_ceiling_ms=rec["bound_ms"] * PEAK_TF32_FLOPS / 1e12
                / probe_tflops,
                d320_launches=model[GEMMA320]["float32"][2][
                    f"{key}_tf32x3w"],
                d320_ms=r["ms"], d320_ms_back_to_back=r["loop"],
                d320_softcap0_ms=r["nocap"],
                d320_softcap0_ms_back_to_back=r["nocap_loop"],
                d320_bound_ms=r["bound"], d320_plain_ms=r["plain"],
                d320_library_ms=r["library"],
                d320_library_ms_back_to_back=r["library_loop"])
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
