"""Measure the TF32 rate that ``mma.sync`` sustains on one card.

    PYTHONPATH=src python3 scripts/mma_tf32_probe.py

Builds ``scripts/mma_tf32_probe.cu`` with the repository's nvcc flags into
``build/kernels/`` and times its kernel (warps issuing independent
``mma.sync.m16n8k8`` TF32 products on registers, no memory traffic) with
CUDA events over a few launch shapes: 1 to 4 blocks of 128 to 512 threads
on every SM.  The best rate is the ceiling that the warp-level instruction
gives a kernel such as ``csrc/flash_bwd_tf32x3.cu``; Hopper reaches its
published 495 TFLOP/s of dense TF32 only through ``wgmma``.  Prints the
card's name and power limit, one line a shape, and the best rate.
``chip_smoke.py`` phase 8 calls ``build`` and ``measure``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_suffix(".cu")


def build() -> ctypes.CDLL:
    """Compile the probe (unless its hashed library exists) and load it."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild

    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(kbuild.NVCC_FLAGS).encode())
    out = kbuild.BUILD_DIR / f"mma_tf32_probe-{h.hexdigest()[:16]}.so"
    if not out.exists():
        kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o",
                               str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.mma_tf32_probe.restype = ctypes.c_int
    lib.mma_tf32_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.mma_tf32_probe_flops.restype = ctypes.c_double
    lib.mma_tf32_probe_flops.argtypes = [ctypes.c_int] * 3
    return lib


def measure(lib: ctypes.CDLL, iters: int = 4096, reps: int = 5) -> dict:
    """``{"shapes": [(blocks an SM, threads, TFLOP/s)], "best_tflops":
    x}``: the median of ``reps`` CUDA-event timings a launch shape, after
    one warm-up launch."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    shapes = []
    for per_sm in (1, 2, 4):
        for threads in (128, 256, 512):
            blocks = per_sm * sms
            out = torch.empty(blocks * threads, device="cuda")

            def launch():
                err = lib.mma_tf32_probe(out.data_ptr(), blocks, threads,
                                         iters, stream)
                if err:
                    raise RuntimeError(f"mma_tf32_probe launch failed ({err})")

            launch()
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms = sorted(times)[reps // 2]
            flops = lib.mma_tf32_probe_flops(blocks, threads, iters)
            shapes.append((per_sm, threads, flops / ms / 1e9))
    return {"shapes": shapes, "best_tflops": max(s[2] for s in shapes)}


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tf32_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    print(chip_smoke.smi_line())
    result = measure(build())
    for per_sm, threads, tflops in result["shapes"]:
        print(f"{per_sm} block(s) an SM x {threads} threads: "
              f"{tflops:.1f} TFLOP/s of TF32")
    print(f"best: {result['best_tflops']:.1f} TFLOP/s of TF32 "
          f"(3xTF32: {result['best_tflops'] / 3:.1f} TFLOP/s of fp32 work)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
