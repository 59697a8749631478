"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
repository root on first use.  The hash covers the source and the compiler
flags, so an edit rebuilds it.  The library has a plain C interface (no
PyTorch headers), which keeps a build to seconds.  A failed build raises:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> (loaded library, build record); filled by ``load``.
_LOADED: dict[str, tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.

    Returns ``{"path", "seconds", "built", "log"}``; ``log`` holds what
    ``ptxas -v`` printed (registers, shared memory, spills)."""
    out = library_path(name)
    if out.exists():
        return {"path": out, "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "built": True,
            "log": proc.stdout + proc.stderr}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        record = build(name)
        _LOADED[name] = (ctypes.CDLL(str(record["path"])), record)
    return _LOADED[name][0]


def build_record(name: str) -> dict:
    """How ``load(name)`` obtained its library (path, seconds, ptxas log)."""
    load(name)
    return _LOADED[name][1]
