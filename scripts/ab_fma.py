"""Time the FMA route's forward kernel of another source tree against this
one's, in turns in one process.

    python3 scripts/ab_fma.py OTHER_CSRC_DIR

OTHER_CSRC_DIR holds a ``flash_fwd.cu`` (and the ``flash_fma.cuh`` it
includes) with the C interface of ``src/repro_torch/kernels/csrc/`` (for
example the parent commit's, unpacked with ``git archive``).  Both trees'
sources are built with the repository's nvcc flags into ``build/ab_fma/``
(``ptxas`` registers and spills printed per instantiation), each checked
against the plain version once, then timed in turns (other, this, this,
other, other, this) with CUDA events at qwen3-1.7b's training shape (B=2,
L=4096, 16 / 8 heads, causal, D=128) in fp32, the one dtype the FMA route
serves (bf16 runs on the tensor cores at every head dim; the parent's bf16
FMA forward is timed by ``scripts/ab_narrow_sm90.py --parent``).  Prints
the card's name and power limit first and the medians of each tree last.
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


def build_tree(tag: str, csrc: Path) -> ctypes.CDLL:
    """``csrc``'s ``flash_fwd.cu``, built and loaded."""
    out = build.BUILD_DIR.parent / "ab_fma"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"flash_fwd-{tag}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc),
                           "-o", str(so), str(csrc / "flash_fwd.cu")],
                          capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"{tag} flash_fwd.cu: {proc.stderr}")
    for kernel, regs, spills in cs.ptxas_summary(proc.stdout + proc.stderr):
        print(f"  {tag} {kernel}: {regs} registers, {spills} bytes spilled")
    return ctypes.CDLL(str(so))


def use(lib: ctypes.CDLL):
    """Route the FMA forward wrapper to ``lib``."""
    fa._fwd_lib.cache_clear()
    build._LOADED["flash_fwd"] = lib


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    trees = {"other": build_tree("other", Path(sys.argv[1]).resolve()),
             "this": build_tree("this", build.CSRC)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 4096, h, 128, generator=gen, device="cuda")
               for h in (16, 8, 8))
    kw = dict(causal=True)
    times = {tag: [] for tag in trees}
    for turn in ("other", "this", "this", "other", "other", "this"):
        use(trees[turn])
        *_, (qf, kf, vf, p, band, doc) = cs.check_kernel(
            f"fp32 D=128-{turn}", q, k, v, kw)
        ms = cs.cuda_ms(lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc))
        times[turn].append(ms)
        print(f"{turn}: forward fp32 D=128 {ms:.4f} ms", flush=True)
    for tag, ms in times.items():
        print(f"{tag} median (fp32 D=128): {statistics.median(ms):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
