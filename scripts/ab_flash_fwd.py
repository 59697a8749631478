"""Compare variants of the sm90 forward kernel on one card, in one process.

    python3 scripts/ab_flash_fwd.py [spec.json]

Each variant is ``src/repro_torch/kernels/csrc/flash_fwd_sm90.cu`` with
textual replacements (``[[name, {old: new}], ...]`` in ``spec.json``; by
default the kept kernel against two design choices undone: two blocks an
SM instead of three, and ``exp2f`` instead of ``ex2.approx``).  Each is
built with the repository's nvcc flags into ``build/ab/``, checked against
the plain version on every bf16 forward case of ``chip_smoke.py`` phase 2
(same tolerances), then all are timed at B=2, L=4096, Hq=16, Hkv=8, D=128,
causal, bf16 in turns (A B C C B A; 21 CUDA-event timings each pass, after
3 warm-ups).  Prints the card's name and power limit first; exits non-zero
if a variant fails to build or disagrees with the plain version.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ops import _fold_chunk_args  # noqa: E402

SOURCE = build.CSRC / "flash_fwd_sm90.cu"
DEFAULT = [
    ["kept", {}],
    ["two_blocks_an_sm", {"__launch_bounds__(kThreads, 3)":
                          "__launch_bounds__(kThreads, 2)"}],
    ["exp2f", {'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));':
               "y = exp2f(x);"}],
]


def build_variant(name: str, reps: dict) -> tuple[str, Path, str]:
    text = SOURCE.read_text()
    for old, new in reps.items():
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {SOURCE.name}")
        text = text.replace(old, new)
    out = build.BUILD_DIR.parent / "ab"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, so, proc.stdout + proc.stderr


def use(lib: ctypes.CDLL):
    """Route the wrapper's sm90 forward to ``lib``."""
    fa._fwd_sm90_lib.cache_clear()
    build._LOADED["flash_fwd_sm90"] = lib


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_flash_fwd: no CUDA device", file=sys.stderr)
        return 1
    spec = json.loads(Path(sys.argv[1]).read_text()) if len(sys.argv) > 1 \
        else DEFAULT
    print(cs.smi_line(), flush=True)
    with ThreadPoolExecutor(len(spec)) as pool:
        built = list(pool.map(lambda v: build_variant(*v), spec))
    libs = {}
    for name, so, log in built:
        regs = [(k, r, sp) for k, r, sp in cs.ptxas_summary(log)]
        print(f"{name}: ptxas {regs}")
        for line in log.splitlines():
            if "wgmma" in line and "serialized" in line:
                print(f"    {line.strip()}")
        libs[name] = ctypes.CDLL(str(so))

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [c for c in cs.kernel_cases(gen) if c[1].dtype == torch.bfloat16]
    for name, lib in libs.items():
        use(lib)
        for case, q, k, v, kw in cases:
            cs.check_kernel(f"{name}:{case}", q, k, v, kw)   # raises
    _, q, k, v, kw = next(c for c in cases if c[0] == "prefill-full-bf16")
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, **kw)
    times = {name: [] for name in libs}
    for name in [*libs, *reversed(libs)]:
        use(libs[name])
        times[name] += cs.cuda_times(
            lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc), reps=21,
            warmup=3)
    _, _, flops = cs.fwd_bound(q, k, torch.bfloat16)
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"{name}: median {med:.4f} ms over {len(ts)} "
              f"({flops / med / 1e9:.1f} TFLOP/s), quartiles "
              f"{statistics.quantiles(ts, n=4)[0]:.4f}-"
              f"{statistics.quantiles(ts, n=4)[2]:.4f} ms, min {min(ts):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
