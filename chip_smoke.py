"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, nvcc and triton; build both CUDA sources from ``src/`` in
   parallel and print their build times and ``ptxas`` registers and
   spills.  TF32 is switched off for fp32 matmuls and cuDNN.
2. The flash forward kernel against its plain PyTorch version: the
   reference suite's sweep, zigzag bands with split q_seg / k_seg, a
   kv_valid cut, packed documents with the K-tile skip on and off, and
   the full-width prefill shape, each in fp32 and bf16.  Every case must
   hold the reference suite's elementwise tolerance (fp32 2e-5, bf16
   2e-2), a norm-relative out error (fp32 2e-5, bf16 1e-2: one bf16
   rounding step is at most 2^-7 relative) and lse within 1e-4 on the
   rows that see a key.
3. The dq and dk/dv kernels against their plain version on every case of
   the CPU parity suite (sweep and band cases) and the full-width
   training shape, fp32 and bf16: max error within atol 5e-4 / rtol 1e-3
   in fp32 (the reference suite's backward tolerance) and 2e-2 in bf16,
   norm-relative error within 2e-5 / 1e-2.
4. Serving qwen3-1.7b at full width: random bf16 weights from a seed,
   greedy ``generate`` of 32 tokens for 2 prompts of 4096 tokens.  Prefill
   must launch the forward kernel once per layer (and no backward
   kernel), the tokens must lie in the vocabulary, and the last-token
   logits must match a prefill on plain attention (cosine >= 0.999).
5. Serving timings with CUDA events (the forward kernel, its plain
   version and ``scaled_dot_product_attention`` at the full-width shape,
   the bound, prefill, a decode step) and ``torch.profiler`` over one
   prefill and one decode step.
6. The whole model: full-width qwen3-1.7b at depth 2 in fp32,
   ``forward_loss`` and its backward at B=1, L=4096, on the kernels and
   on the dense oracle: loss within 1e-5 relative, every grad leaf within
   1e-4 norm-relative.
7. Training qwen3-1.7b at full depth through ``launch/train.py``'s
   path (``Trainer``): 3 steps of 2 microbatches of 1 x 4096 tokens;
   finite losses, step 0 within 1.5 of ln(vocab), exactly 56 dq and 56
   dk/dv launches a step (and 56 forward launches under scpp).  Step
   time by CUDA events, tokens/s, MFU, peak memory; 5 more steps timed.
8. The backward kernels' times at the training shape beside their
   bounds, the plain version and SDPA's backward, and ``torch.profiler``
   over one training step.

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
        if "Compiling entry function" in line and m:
            dtype = "bf16" if "bfloat16" in m.group(2) else "fp32"
            name = (f"{m.group(1)}<{dtype}, D={m.group(3)}, "
                    f"tile={m.group(4)}>")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
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
    return statistics.median(times)


def profile_call(fn, top: int = 5):
    """Run ``fn`` once under ``torch.profiler``; returns (summary, result).
    The summary gives the host wall time under the profiler, the summed
    device time of the CUDA kernels (their busy share of that wall time)
    and the kernels that took the most device time."""
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
    return (f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%, idle "
            f"{100 - 100 * busy_ms / wall_ms:.1f}%), {launches} kernel "
            f"launches; top: {tops}"), result


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
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        cases.append((f"prefill-full-{tag}",
                      rand(b, PROMPT, h, d, dtype=dtype),
                      rand(b, PROMPT, hkv, d, dtype=dtype),
                      rand(b, PROMPT, hkv, d, dtype=dtype),
                      dict(causal=True)))
    return cases


def check_kernel(name, q, k, v, kw):
    """Kernel and plain version on the same folded operands; returns the
    max |out error|, the max |lse error| on visible rows and the folded
    call for timing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import NEG_INF, _fold_chunk_args

    d = q.shape[3]
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, **kw)
    out_k, lse_k = fa._fwd(qf, kf, vf, p, band=band, doc=doc)
    torch.cuda.synchronize()
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
    print(f"  {name:22s} out max|err| {err:.3e} (tol {tol:g})  "
          f"||err||/||out|| {rel:.3e} (tol {REL_TOL[q.dtype]:g})  "
          f"lse max|err| {lse_err:.3e} (tol {LSE_TOL:g})  "
          f"{'ok' if good else 'FAIL'}")
    check(good, f"kernel disagrees with its plain version on {name}")
    del out_p, lse_p
    return err, lse_err, (qf, kf, vf, p, band, doc)


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


def bwd_cases(gen: torch.Generator):
    """(name, q, k, v, do, keyword arguments) on the card: the CPU parity
    suite's sweep and band cases, then the full-width training shape."""
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
        for name, (b, lq, lk, hq, hkv, d, kw) in EXTRA.items():
            kw = dict(kw)
            if "band" in kw:
                kw["band"] = BandMask.zigzag(*kw["band"])
            if "q_doc_start" in kw:
                kw["q_doc_start"] = torch.as_tensor(
                    kw["q_doc_start"], dtype=torch.int32, device="cuda")
            shapes.append((name, (b, lq, lk, hq, hkv, d), kw))
        shapes.append(("train-full", (BATCH, PROMPT, PROMPT, TRAIN_HQ,
                                      TRAIN_HKV, TRAIN_D), dict(causal=True)))
        for name, (b, lq, lk, hq, hkv, d), kw in shapes:
            cases.append((f"{name}-{tag}", rand(b, lq, hq, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lk, hkv, d, dtype=dtype),
                          rand(b, lq, hq, d, dtype=dtype), kw))
    return cases


def check_bwd(name, q, k, v, do, kw):
    """dq and dk/dv kernels against ``_bwd_plain`` on the same folded
    operands and the same ``(out, lse)``.  Returns ``{"dq": (max |err|,
    norm-relative err), "dk": ..., "dv": ...}`` and the folded call for
    timing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad

    d = q.shape[3]
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, **kw)
    dof = _fold_pad(do, qf.shape[2])
    out, lse = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    dsum = (dof.float() * out.float()).sum(dim=-1)
    got = fa._bwd_cuda(qf, kf, vf, dof, lse, dsum, p, band, doc)
    torch.cuda.synchronize()
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
    print(f"  {name:18s} max|err|/norm-rel: {'  '.join(parts)}  "
          f"(tol {atol:g}+{rtol:g}|x|, {BWD_REL_TOL[q.dtype]:g})  "
          f"{'ok' if good else 'FAIL'}")
    check(good, f"backward kernels disagree with their plain version on "
                f"{name}")
    del want, got
    return errs, (qf, kf, vf, dof, lse, dsum, p, band, doc)


def bwd_bound(q, k, n_products: int):
    """(bound ms, bound_by, FLOP) of one backward kernel at a causal shape:
    ``n_products`` products of 2*D FLOPs per visible (q, k) pair against
    989 TFLOP/s, or the bytes it must move (q, k, v, dO read; its outputs
    written; lse and dsum) against 3.35 TB/s."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    pairs = lq * (lq + 1) // 2
    flops = n_products * 2 * b * hq * d * pairs
    item = q.element_size()
    q_bytes, kv_bytes = b * lq * hq * d * item, b * lq * hkv * d * item
    out_bytes = q_bytes if n_products == 3 else 2 * kv_bytes
    nbytes = 2 * q_bytes + 2 * kv_bytes + out_bytes + 2 * b * hq * lq * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
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
    from repro_torch.kernels import flash_attention as fa
    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_dq": fa.DQ_LAUNCHES,
            "flash_bwd_dkv": fa.DKV_LAUNCHES}


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Phase 6: the whole model, kernels against the dense oracle
# ---------------------------------------------------------------------------

def model_check():
    """A full-width, depth-2, fp32 qwen3-1.7b ``forward_loss`` and its
    backward at B=1, L=4096, on the kernels and on ``impl="ref"``.  Returns
    (relative loss difference, worst norm-relative grad difference)."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import forward_loss, init_params

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2,
                              dtype="float32")
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
        grads = torch.autograd.grad(loss, xs)
        torch.cuda.synchronize()
        runs[impl] = (loss.item(), grads, launch_counts())
        del loss, xs
    (lk, gk, ck), (lr, gr, cr) = runs["cuda"], runs["ref"]
    check(ck == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2},
          f"the kernel run launched {ck}, expected 2 of each")
    check(not any(cr.values()), f"the ref run launched kernels: {cr}")
    loss_rel = abs(lk - lr) / abs(lr)
    grad_rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                   for a, b in zip(gk, gr))
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    print(f"    loss kernels {lk:.6f}, ref {lr:.6f}: relative difference "
          f"{loss_rel:.3e} (tol 1e-5); worst grad leaf norm-relative "
          f"difference {grad_rel:.3e} over {len(gk)} leaves (tol 1e-4)")
    check(loss_rel <= 1e-5 and grad_rel <= 1e-4 and finite,
          "the model on the kernels disagrees with the dense oracle")
    return loss_rel, grad_rel


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
                      "launches": {k: v - n0[k]
                                   for k, v in launch_counts().items()}})
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
    records = build.build_all(["flash_fwd", "flash_bwd"])
    print(f"    built both libraries in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib_name, record in records.items():
        print(f"    {record['path'].name}: nvcc {record['seconds']:.2f} s")
        for name, regs, spills in ptxas_summary(record["log"]):
            print(f"    ptxas {name}: {regs} registers, {spills} bytes "
                  "spilled")

    # -- phase 2 ------------------------------------------------------------
    print("[2] flash_fwd kernel against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err, max_lse_err, passed, full = 0.0, 0.0, 0, None
    for name, q, k, v, kw in kernel_cases(gen):
        err, lse_err, folded = check_kernel(name, q, k, v, kw)
        max_err, max_lse_err = max(max_err, err), max(max_lse_err, lse_err)
        passed += 1
        if name == "prefill-full-bf16":
            full = (q, k, v, folded)
    torch.cuda.empty_cache()

    # -- phase 3 ------------------------------------------------------------
    print("[3] flash_bwd dq and dk/dv kernels against their plain version")
    worst = {"dq": [0.0, 0.0], "dkv": [0.0, 0.0]}
    bwd_passed, bwd_full = 0, None
    for name, q, k, v, do, kw in bwd_cases(gen):
        errs, folded = check_bwd(name, q, k, v, do, kw)
        for label, (err, rel) in errs.items():
            key = "dq" if label == "dq" else "dkv"
            worst[key] = [max(worst[key][0], err), max(worst[key][1], rel)]
        bwd_passed += 1
        if name == "train-full-bf16":
            bwd_full = (q, k, v, do, folded)
        del q, k, v, do, folded
        torch.cuda.empty_cache()
    print(f"    {bwd_passed} cases passed; worst dq max|err| "
          f"{worst['dq'][0]:.3e}, norm-rel {worst['dq'][1]:.3e}; worst "
          f"dk/dv max|err| {worst['dkv'][0]:.3e}, norm-rel "
          f"{worst['dkv'][1]:.3e}")

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
    check(launches == cfg.num_layers,
          f"generate launched the kernel {launches} times")
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
    q, k, v, (qf, kf, vf, p, band, doc) = full
    kernel_ms = cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc))
    plain_ms = cuda_ms(lambda: fa._fwd_plain(qf, kf, vf, p, band=band,
                                             doc=doc), reps=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True))
    group = q.shape[2] // k.shape[2]
    kr, vr = (x.repeat_interleave(group, dim=1) for x in (kt, vt))
    library_rep_ms = cuda_ms(lambda: sdpa(qt, kr, vr, is_causal=True))
    del kr, vr
    b, lq, hq, d = q.shape
    pairs = lq * (lq + 1) // 2                  # visible (q, k) pairs, causal
    flops = 4 * b * hq * d * pairs
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + b * hq * lq * 4
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= \
        nbytes / PEAK_BYTES else "bytes"
    print(f"    flash_fwd at B={b} L={lq} Hq={hq} Hkv={k.shape[2]} D={d} "
          f"causal bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa(enable_gqa) {library_ms:.4f} ms, "
          f"sdpa(repeated kv) {library_rep_ms:.4f} ms")
    print(f"    bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP "
          f"at 989 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s); kernel at "
          f"{flops / kernel_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bound_ms / kernel_ms:.2f}% of the bound; the same work "
          f"at the fp32-core peak of 67 TFLOP/s takes "
          f"{flops / PEAK_FP32_FLOPS * 1e3:.3f} ms")
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
    del caches, params, tok, qt, kt, vt
    torch.cuda.empty_cache()

    # -- phase 6 ------------------------------------------------------------
    print(f"[6] whole model: full-width {ARCH} at depth 2, fp32, B=1 "
          f"L={PROMPT}, forward_loss + backward on the kernels and on the "
          "dense oracle")
    model_loss_rel, model_grad_rel = model_check()
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
    want = {"flash_fwd": fwd_per_step, "flash_bwd_dq": n_layers * accum,
            "flash_bwd_dkv": n_layers * accum}
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
    dq_ms = cuda_ms(lambda: fa._dq_cuda(qf, kf, vf, dof, lse, dsum, p, band,
                                        doc))
    dkv_ms = cuda_ms(lambda: fa._dkv_cuda(qf, kf, vf, dof, lse, dsum, p,
                                          band, doc))
    out_f, _ = fa._fwd(qf, kf, vf, p, band=band, doc=doc)
    bwd_plain_ms = cuda_ms(lambda: fa._bwd_plain(qf, kf, vf, out_f, lse, dof,
                                                 p, band, doc), reps=5)
    del out_f
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    sdpa_bwd_ms = cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd)
    dq_bound, dq_by, dq_flops = bwd_bound(q, k, 3)
    dkv_bound, dkv_by, dkv_flops = bwd_bound(q, k, 4)
    b, lq, hq, d = q.shape
    print(f"    at B={b} L={lq} Hq={hq} Hkv={k.shape[2]} D={d} causal bf16: "
          f"dq kernel {dq_ms:.4f} ms (bound {dq_bound:.4f} ms, {dq_by}: "
          f"{dq_flops / 1e9:.1f} GFLOP; {dq_flops / dq_ms / 1e9:.1f} "
          f"TFLOP/s); dk/dv kernel {dkv_ms:.4f} ms (bound {dkv_bound:.4f} "
          f"ms, {dkv_by}: {dkv_flops / 1e9:.1f} GFLOP; "
          f"{dkv_flops / dkv_ms / 1e9:.1f} TFLOP/s)")
    print(f"    plain backward (dq, dk, dv in one call) {bwd_plain_ms:.4f} "
          f"ms; sdpa(enable_gqa) backward (forward + backward minus "
          f"forward) {sdpa_bwd_ms:.4f} ms")
    del qt, kt, vt, dot
    torch.cuda.empty_cache()
    batch = trainer._to_device(trainer.data.batch(3))
    train_prof, _ = profile_call(
        lambda: trainer.step_fn(trainer.params, trainer.opt_state, batch),
        top=8)
    print(f"    training step: {train_prof}")

    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:145",
        "tpu_kernel": "_fwd_kernel",
        "launches": run["totals"]["flash_fwd"], "serve_launches": launches,
        "cases_passed": passed, "max_abs_err": max_err,
        "max_lse_err": max_lse_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}, {
        "name": "flash_bwd_dq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:289",
        "tpu_kernel": "_dq_kernel",
        "launches": run["totals"]["flash_bwd_dq"], "cases_passed": bwd_passed,
        "max_abs_err": worst["dq"][0], "max_norm_rel_err": worst["dq"][1],
        "ms": dq_ms, "plain_ms": bwd_plain_ms, "bound_ms": dq_bound,
        "bound_by": dq_by, "library_ms": sdpa_bwd_ms}, {
        "name": "flash_bwd_dkv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:331",
        "tpu_kernel": "_dkv_kernel",
        "launches": run["totals"]["flash_bwd_dkv"],
        "cases_passed": bwd_passed, "max_abs_err": worst["dkv"][0],
        "max_norm_rel_err": worst["dkv"][1], "ms": dkv_ms,
        "plain_ms": bwd_plain_ms, "bound_ms": dkv_bound, "bound_by": dkv_by,
        "library_ms": sdpa_bwd_ms}]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
