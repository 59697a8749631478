"""Compare variants of the fp32 3xTF32 backward kernels on one card, in one
process.

    python3 scripts/ab_flash_bwd_tf32x3.py [spec.json]
    python3 scripts/ab_flash_bwd_tf32x3.py --header-from OTHER_CSRC_DIR

Each variant is ``src/repro_torch/kernels/csrc/flash_bwd_tf32x3.cu`` with
textual replacements (``[[name, {old: new}], ...]`` in ``spec.json``).  By
default the kept kernels run against six design choices undone:

- hi rounded by ``cvt.rna.tf32.f32`` instead of two integer instructions,
- or by three fp32 instructions (Veltkamp's split, on the fp32 pipe),
- lo rounded to nearest instead of truncated,
- the products summed straight into the long-lived accumulators instead
  of a partial sum a tile added in fp32,
- the dq block's keys split two ways (256 threads) instead of four (512),
- dk/dv's partial sums over two k steps instead of four.

With ``--header-from``, the kept source is built twice instead: against
this tree's ``sm90_common.cuh`` and against OTHER_CSRC_DIR's (for example
the parent commit's, unpacked with ``git archive``), and the script also
says whether the two builds' SASS (``cuobjdump -sass``) is the same.
Each is built with the repository's nvcc flags into ``build/ab/<name>/``
(``ab_flash_fwd.build_variant``) and held against the plain version on
every fp32 backward case of ``chip_smoke.py`` phase 3 (same tolerances; a
variant that misses one is reported, not dropped).  Then its dq and dk/dv
kernels are timed at B=2, L=4096, Hq=16, Hkv=8, D=128, causal, fp32 in
turns (A B C .. C B A; 21 CUDA-event timings each pass, after 3
warm-ups).  Prints the card's name and power limit first; exits non-zero
if a variant fails to build or the first (kept) one disagrees with the
plain version.
"""
from __future__ import annotations

import ctypes
import json
import re
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

import ab_flash_fwd  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = build.CSRC / "flash_bwd_tf32x3.cu"
DEFAULT = [
    ["kept", {}],
    ["cvt_rna", {"  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;":
                 '  uint32_t r;\n'
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                 '  return r;'}],
    ["hi_on_fp32_pipe", {"  hi = tf32_rna(x);\n":
                         "  const float big = __fmul_rn(x, 8193.f);\n"
                         "  hi = __float_as_uint(__fadd_rn(__fsub_rn(x, big),"
                         " big));\n"}],
    ["lo_rna", {"  lo = __float_as_uint(x - __uint_as_float(hi)) & "
                "0xffffe000u;": "  lo = tf32_rna(x - __uint_as_float(hi));"}],
    ["no_tile_sums", {"mma3(part, a[n],": "mma3(out[c], a[n],",
                      "    add_to(out[c], part);\n": ""}],
    ["dq_keys_2way", {"constexpr int kDqKeySplit = 4;":
                      "constexpr int kDqKeySplit = 2;"}],
    ["dkv_sums_2steps", {"constexpr int kDkvSumSteps = 4;":
                         "constexpr int kDkvSumSteps = 2;"}],
]


def sass_of(so: Path) -> list[str]:
    """The function names and instructions of ``so``'s device code, with
    the anonymous namespace's per-translation-unit tag taken out of the
    names (it differs between any two builds of a changed file)."""
    proc = subprocess.run(
        [str(Path(build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
        capture_output=True, text=True, check=True)
    return [re.sub(r"_GLOBAL__N__\w*?_cu_[0-9a-f]{8}", "_GLOBAL__N__",
                   line.strip())
            for line in proc.stdout.splitlines()
            if "Function :" in line or "/*" in line]


def use(lib: ctypes.CDLL):
    """Route the wrapper's tf32x3 backward to ``lib``."""
    fa._bwd_tf32x3_lib.cache_clear()
    build._LOADED["flash_bwd_tf32x3"] = lib


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_flash_bwd_tf32x3: no CUDA device", file=sys.stderr)
        return 1
    headers = {}
    if sys.argv[1:2] == ["--header-from"]:
        spec = [["kept", {}], ["other_header", {}]]
        headers["other_header"] = Path(sys.argv[2]) / "sm90_common.cuh"
    else:
        spec = json.loads(Path(sys.argv[1]).read_text()) \
            if len(sys.argv) > 1 else DEFAULT
    print(cs.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(spec)) as pool:
        built = list(pool.map(
            lambda v: ab_flash_fwd.build_variant(
                *v, source=SOURCE, header=headers.get(v[0])), spec))
    libs = {}
    for name, so, log in built:
        print(f"{name}: ptxas {cs.ptxas_summary(log)}")
        libs[name] = ctypes.CDLL(str(so))
    if headers:
        sass = [sass_of(so) for _, so, _ in built]
        diff = [pair for pair in zip(*sass) if pair[0] != pair[1]]
        print(f"SASS of the two builds: {len(sass[0])} and {len(sass[1])} "
              f"lines, {len(diff)} of them different"
              + "".join(f"\n    {a}\n    {b}" for a, b in diff[:4]))

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [c for c in cs.bwd_cases(gen) if c[1].dtype == torch.float32]
    failed = {name: [] for name in libs}
    for name, lib in libs.items():
        use(lib)
        for case, q, k, v, do, kw in cases:
            try:
                cs.check_bwd(f"{name}:{case}", q, k, v, do, kw)
            except RuntimeError:
                failed[name].append(case)
        print(f"{name}: {len(cases) - len(failed[name])} of {len(cases)} "
              f"fp32 cases within tolerance; missed: {failed[name] or 'none'}",
              flush=True)
    _, q, k, v, do, kw = next(c for c in cases if c[0] == "train-full-fp32")
    del cases
    use(libs[spec[0][0]])
    _, _, (qf, kf, vf, dof, lse, dsum, p, band, doc) = cs.check_bwd(
        "timing-input", q, k, v, do, kw)
    times = {(name, key): [] for name in libs for key in ("dq", "dkv")}
    for name in [*libs, *reversed(libs)]:
        use(libs[name])
        for key, fn in (("dq", fa._dq_cuda), ("dkv", fa._dkv_cuda)):
            times[name, key] += cs.cuda_times(
                lambda: fn(qf, kf, vf, dof, lse, dsum, p, band, doc),
                reps=21, warmup=3)
    for (name, key), ts in times.items():
        _, _, flops = cs.bwd_bound(q, k, 3 if key == "dq" else 4,
                                   torch.float32)
        med = statistics.median(ts)
        quart = statistics.quantiles(ts, n=4)
        print(f"{name} {key}: median {med:.4f} ms over {len(ts)} "
              f"({flops / med / 1e9:.1f} TFLOP/s of fp32 work), quartiles "
              f"{quart[0]:.4f}-{quart[2]:.4f} ms, min {min(ts):.4f}")
    return 1 if failed[spec[0][0]] else 0


if __name__ == "__main__":
    sys.exit(main())
