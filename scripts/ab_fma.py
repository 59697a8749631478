"""Time the FMA route's kernels of another source tree against this one's,
in turns in one process.

    python3 scripts/ab_fma.py OTHER_CSRC_DIR

OTHER_CSRC_DIR holds a ``flash_fwd.cu`` and a ``flash_bwd.cu`` with the C
interface of ``src/repro_torch/kernels/csrc/`` (for example the parent
commit's, unpacked with ``git archive``).  Both trees' sources are built
with the repository's nvcc flags into ``build/ab_fma/`` (``ptxas``
registers and spills printed per instantiation), each checked against the
plain version once, then timed in turns (other, this, this, other, other,
this) with CUDA events at qwen3-1.7b's training shape (B=2, L=4096, 16 / 8
heads, causal): the fp32 forward at D=128 and the bf16 dq and dk/dv at
D=32, the widths the FMA route serves.  Prints the card's name and power
limit first and the medians of each tree last.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def build_tree(tag: str, csrc: Path) -> dict:
    """``{source name: loaded library}`` of ``csrc``'s two FMA sources."""
    out = build.BUILD_DIR.parent / "ab_fma"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("flash_fwd", "flash_bwd"):
        so = out / f"{name}-{tag}.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                               str(csrc), "-o", str(so),
                               str(csrc / f"{name}.cu")],
                              capture_output=True, text=True)
        cs.check(proc.returncode == 0, f"{tag} {name}.cu: {proc.stderr}")
        for kernel, regs, spills in cs.ptxas_summary(proc.stdout
                                                     + proc.stderr):
            print(f"  {tag} {kernel}: {regs} registers, {spills} bytes "
                  "spilled")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def use(libs: dict):
    """Route the FMA wrappers to ``libs``."""
    fa._fwd_lib.cache_clear()
    fa._bwd_lib.cache_clear()
    build._LOADED.update(libs)


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    trees = {"other": build_tree("other", Path(sys.argv[1]).resolve()),
             "this": build_tree("this", build.CSRC)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(2, 4096, h, 128, generator=gen,
                               device="cuda") for h in (16, 8, 8, 16))
    kw = dict(causal=True)
    times = {tag: [] for tag in trees}
    for turn in ("other", "this", "this", "other", "other", "this"):
        use(trees[turn])
        *_, (qf, kf, vf, p, band, doc) = cs.check_kernel(
            f"fwd-{turn}", q, k, v, kw)
        x = [t[..., :32].to(torch.bfloat16).contiguous()
             for t in (q, k, v, do)]
        *_, (bq, bk, bv, bdo, lse, dsum, bp, bband, bdoc) = cs.check_bwd(
            f"bwd-{turn}", *x, kw)
        row = (cs.cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band,
                                          doc=doc)),
               cs.cuda_ms(lambda: fa._dq_cuda(bq, bk, bv, bdo, lse, dsum,
                                              bp, bband, bdoc)),
               cs.cuda_ms(lambda: fa._dkv_cuda(bq, bk, bv, bdo, lse, dsum,
                                               bp, bband, bdoc)))
        times[turn].append(row)
        print(f"{turn}: forward fp32 D=128 {row[0]:.4f} ms, dq bf16 D=32 "
              f"{row[1]:.4f} ms, dk/dv bf16 D=32 {row[2]:.4f} ms",
              flush=True)
    for tag, rows in times.items():
        print(f"{tag} medians (forward, dq, dk/dv ms): "
              f"{[round(statistics.median(c), 4) for c in zip(*rows)]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
