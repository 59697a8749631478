"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` (``flash_fwd``, ``flash_fwd_sm90``, ``flash_bwd``,
``flash_bwd_sm90``) becomes ``build/kernels/<name>-<hash>.so`` at the
repository root on first use.  The hash covers the source, every header
in ``csrc/`` (``sm90_common.cuh``) and the compiler flags, so an edit to
any of them rebuilds it.  The library has a plain C interface (no
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> loaded library; filled by ``load`` and ``build_all``.
_LOADED: dict[str, ctypes.CDLL] = {}


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
    """Where ``csrc/<name>.cu`` is built: named by a hash of the source,
    the headers it may include and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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


def build_all(names) -> dict:
    """Build several sources at once, one ``nvcc`` each, and load them;
    returns ``{name: build record}``."""
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        records = dict(zip(names, pool.map(build, names)))
    for name, record in records.items():
        _LOADED[name] = ctypes.CDLL(str(record["path"]))
    return records


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)["path"]))
    return _LOADED[name]

