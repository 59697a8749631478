"""Compare variants of the fp32 3xTF32 forward kernels on one card, in one
process.

    python3 scripts/ab_flash_fwd_tf32x3.py [--parent OTHER_CSRC_DIR] [NAME ...]
    python3 scripts/ab_flash_fwd_tf32x3.py --wide [--parent OTHER_CSRC_DIR] [NAME ...]

Each variant is ``src/repro_torch/kernels/csrc/flash_fwd_tf32x3.cu`` (the
``tf32x3`` route, fp32 up to D 128) or, with ``--wide``,
``flash_fwd_tf32x3_wide.cu`` (the ``tf32x3w`` route, above D 128) with
textual replacements.  With no NAME only the kept kernel runs; the
designs measured and not kept run by NAME (``MEASURED``, all of the
narrow source: 64-key stages, 8 warps (128 q rows) a block, both, and Q
split once into hi / lo copies in shared memory, with 4 and with 8
warps).  The wide source's rejected designs (32 q rows a block with
32-key stages, 8-key score units) are no longer buildable from it;
PERF.md keeps their numbers.  With ``--parent``, OTHER_CSRC_DIR's build
of the same route joins them: its ``flash_fwd_tf32x3[_wide].cu`` if it
has one, else the fp32 FMA forward the route replaced
(``flash_fwd.cu`` or ``flash_fwd_wide.cu`` of an older commit,
unpacked with ``git archive``) under the new entry names.

Each is built with the repository's nvcc flags into ``build/ab/<name>/``
(ptxas registers and spills printed) and checked in a child process, so a
fault stays contained, on every fp32 case of ``chip_smoke.py`` phase 2 at
its widths (a variant that misses a tolerance is reported and not timed).
Then all are timed in turns (A B .. B A), one call at a time (21 CUDA-event
timings after 3 warm-ups) and back to back (5 x 20 calls): the narrow
kernels at qwen3-1.7b's prefill shape (B=2, L=4096, Hq=16, Hkv=8, D=128,
causal), the wide ones at gemma2-2b's shape (B=2, L=4096, Hq=8, Hkv=4,
causal) at D 288 and at head dim 320 (padded 384), softcap 50 and 0; each
beside its bound (two products in three TF32 passes at 495 TFLOP/s) and
SDPA's forward on the same inputs (repeated K/V, no softcap, the backend
that runs there), both ways.  Prints the card's name and power limit
first; exits non-zero if a variant fails to build or the first (kept) one
disagrees with the plain version.  About a minute a variant.
"""
from __future__ import annotations

import ctypes
import functools
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from ab_flash_bwd_tf32x3 import build_variant, report_ptxas  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ops import _d_pad, _fold_chunk_args  # noqa: E402

NARROW, WIDE = "flash_fwd_tf32x3", "flash_fwd_tf32x3_wide"
# The Q tile split once, after it lands, into hi (in place) and lo (beside
# it) in shared memory, instead of at every K stage in registers.
Q_PRESPLIT = {
    "  static constexpr size_t kBytes = sizeof(float) * (kQ + 4 * kStage);":
    "  static constexpr size_t kBytes =\n"
    "      sizeof(float) * (2 * kQ + 4 * kStage);",
    "  float* ring = sQ + L::kQ;":
    "  float* ring = sQ + 2 * L::kQ;",
    "      const int k0 = kt * kKeys;\n":
    "      const int k0 = kt * kKeys;\n"
    "      if (it == 0) {\n"
    "        for (int i = tid; i < L::kQ; i += kFwdThreads) {\n"
    "          uint32_t hi, lo;\n"
    "          split(sQ[i], hi, lo);\n"
    "          sQ[i] = __uint_as_float(hi);\n"
    "          sQ[L::kQ + i] = __uint_as_float(lo);\n"
    "        }\n"
    "        __syncthreads();\n"
    "      }\n",
    "        const FragA qa = load_a<S>(sQ, 16 * warp + g, 8 * ks + t);\n":
    "        const float* qp = sQ + (16 * warp + g) * S + 8 * ks + t;\n"
    "        FragA qa;\n"
    "        qa.hi[0] = __float_as_uint(qp[0]);\n"
    "        qa.hi[1] = __float_as_uint(qp[8 * S]);\n"
    "        qa.hi[2] = __float_as_uint(qp[4]);\n"
    "        qa.hi[3] = __float_as_uint(qp[8 * S + 4]);\n"
    "        qa.lo[0] = __float_as_uint(qp[L::kQ]);\n"
    "        qa.lo[1] = __float_as_uint(qp[L::kQ + 8 * S]);\n"
    "        qa.lo[2] = __float_as_uint(qp[L::kQ + 4]);\n"
    "        qa.lo[3] = __float_as_uint(qp[L::kQ + 8 * S + 4]);\n",
}
KEYS64 = {"constexpr int kKeys = 32;": "constexpr int kKeys = 64;"}
WARPS8 = {"constexpr int kWarps = 4;": "constexpr int kWarps = 8;"}
DEFAULT = [["kept", {}]]
DEFAULT_WIDE = [["wide_kept", {}]]
# Measured against the kept kernel and not kept; they run only when NAMEd.
MEASURED = [
    ["keys64", KEYS64],
    ["warps8", WARPS8],
    ["warps8_keys64", {**WARPS8, **KEYS64}],
    ["q_presplit", Q_PRESPLIT],
    ["warps8_q_presplit", {**WARPS8, **Q_PRESPLIT}],
]
# An older tree's fp32 FMA forward under the new route's entry names.
PARENT = {NARROW: ("flash_fwd", ["-Dflash_fwd=flash_fwd_tf32x3",
                                 "-Dflash_fwd_error_string="
                                 "flash_fwd_tf32x3_error_string"]),
          WIDE: ("flash_fwd_wide", ["-Dflash_fwd_wide=flash_fwd_tf32x3w",
                                    "-Dflash_fwd_wide_error_string="
                                    "flash_fwd_tf32x3w_error_string"])}


def use(lib: ctypes.CDLL, source: str) -> None:
    """Route the wrapper's tf32x3 (or, for ``WIDE``, tf32x3w) forward to
    ``lib``."""
    accessor = fa._fwd_tf32x3_lib if source == NARROW else fa._fwd_tf32x3w_lib
    accessor.cache_clear()
    build._LOADED[source] = lib


def check(name: str, source: str, path: str) -> None:
    """Every fp32 case of phase 2 at ``source``'s widths on ``path``'s
    kernel; raises on a disagreement."""
    use(ctypes.CDLL(path), source)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case, q, k, v, kw in cs.kernel_cases(gen):
        if q.dtype == torch.float32 and (_d_pad(q.shape[3]) > 128) == (
                source == WIDE):
            cs.check_kernel(f"{name}:{case}", q, k, v, kw)
        del q, k, v
    torch.cuda.empty_cache()


def shapes(source: str):
    """(label, q, k, v, softcap) of the timing: qwen3-1.7b's prefill shape
    at D 128, or gemma2-2b's at D 288 and head dim 320, softcap 50 and 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l = cs.BATCH, cs.PROMPT
    if source == NARROW:
        dims, (hq, hkv), caps = (128,), (16, 8), (0.0,)
    else:
        dims, (hq, hkv) = (cs.GEMMA_D, 320), (cs.GEMMA_HQ, cs.GEMMA_HKV)
        caps = (cs.GEMMA_CAP, 0.0)
    for d in dims:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, l, hq, d), (b, l, hkv, d),
                                 (b, l, hkv, d)))
        for cap in caps:
            yield f"D {d} softcap {cap:g}", q, k, v, cap


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_flash_fwd_tf32x3: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--check"]:        # a child: one variant's check
        check(*sys.argv[2:5])
        return 0
    print(cs.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    source, spec = NARROW, DEFAULT
    if args[:1] == ["--wide"]:
        source, spec, args = WIDE, DEFAULT_WIDE, args[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    if args:
        named = dict(DEFAULT + DEFAULT_WIDE + MEASURED)
        spec = [[name, named[name]] for name in args]
    jobs = [(name, reps, source, build.CSRC, ()) for name, reps in spec]
    if parent and (parent / f"{source}.cu").exists():
        jobs.append((f"parent_{source}", {}, source, parent, ()))
    elif parent:
        other, defines = PARENT[source]
        jobs.append((f"parent_fma_{other}", {}, other, parent,
                     tuple(defines)))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build_variant(*job), jobs))
    passed = {}
    for name, path, log in built:
        report_ptxas(name, log)
        proc = subprocess.run([sys.executable, __file__, "--check", name,
                               source, str(path)], capture_output=True,
                              text=True, timeout=900)
        cases = proc.stdout.count(" ok\n")
        if proc.returncode == 0:
            print(f"{name}: {cases} cases within tolerance", flush=True)
            for line in proc.stdout.splitlines():
                if "full" in line or "d320" in line:
                    print(f"    {line.strip()}")
            passed[name] = path
        else:
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-8:]
            print(f"{name}: FAILED after {cases} cases:\n    "
                  + "\n    ".join(tail), flush=True)
    if spec[0][0] not in passed:
        return 1

    from torch.nn.attention import sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls, bounds, lib = {}, {}, {}
    for label, q, k, v, cap in shapes(source):
        qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, causal=True,
                                                    softcap=cap)
        calls[label] = functools.partial(fa._fwd, qf, kf, vf, p, band=band,
                                         doc=doc)
        bounds[label] = cs.fwd_bound(q, k, torch.float32, cs.PEAK_TF32_FLOPS,
                                     3)
        d = q.shape[3]
        if d not in lib:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            group = q.shape[2] // k.shape[2]
            kr, vr = (x.repeat_interleave(group, dim=1) for x in (kt, vt))
            backend = cs.sdpa_backend(
                *(x.detach().requires_grad_() for x in (qt, kr, vr)))
            with sdpa_kernel([backend]):
                fn = functools.partial(sdpa, qt, kr, vr, is_causal=True)
                lib[d] = (backend.name, cs.cuda_times(fn, reps=21, warmup=3),
                          cs.cuda_loop_times(fn))
            del qt, kt, vt, kr, vr
    names = list(passed)
    # name -> (way, shape label) -> milliseconds
    times = {name: {(way, label): [] for way in ("call", "loop")
                    for label in calls} for name in names}
    for name in [*names, *reversed(names)]:
        use(ctypes.CDLL(str(passed[name])), source)
        n0 = cs.launch_counts()
        for label, fn in calls.items():
            times[name]["call", label] += cs.cuda_times(fn, reps=21,
                                                        warmup=3)
            times[name]["loop", label] += cs.cuda_loop_times(fn)
        moved = cs.launches_since(n0)
        route = fa.fwd_route(torch.float32, 128 if source == NARROW else 288)
        if moved[f"fwd_{route}"] != len(calls) * 127:
            print(f"{name}: the timing left the {route} route: {moved}")
            return 1
    for name in names:
        for (way, label), ts in times[name].items():
            med = statistics.median(ts)
            bound, _, flops = bounds[label]
            quart = statistics.quantiles(ts, n=4)
            print(f"{name} {label} ({way}): median {med:.4f} ms over "
                  f"{len(ts)} ({3 * flops / med / 1e9:.1f} TFLOP/s of TF32 "
                  f"issued, {100 * bound / med:.2f}% of the {bound:.4f} ms "
                  f"bound), quartiles {quart[0]:.4f}-{quart[2]:.4f} ms, min "
                  f"{min(ts):.4f}")
    for d, (backend, call, loop) in lib.items():
        print(f"sdpa forward D {d} ({backend}, repeated kv, no softcap): "
              f"median {statistics.median(call):.4f} ms over {len(call)}, "
              f"min {min(call):.4f}, max {max(call):.4f}; back to back "
              f"{statistics.median(loop):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
