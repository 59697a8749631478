"""Architecture registry: ``get_config(name)`` / ``get_reduced(name)``
(counterpart of ``src/repro/configs/__init__.py``).

Each ported architecture has a module exposing ``config()`` (the published
dims) and ``reduced()`` (a tiny same-family config for CPU tests).  The
other architectures of the JAX package raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

#: canonical ids of the ported architectures -> module names
CANONICAL = {"qwen3-1.7b": "qwen3_1_7b"}

#: architectures of the JAX package still to port -> the ROADMAP item
PENDING = {
    "olmo-1b": "queue 1, item 1 (with the training slice)",
    "gemma2-2b": "queue 1, item 9 (window, softcap, post-norms)",
    "gemma3-12b": "queue 1, item 9 (window pattern; head_dim 256 needs "
                  "the D > 128 kernel of queue 2)",
    "chameleon-34b": "queue 1, item 9",
    "qwen3-moe-30b-a3b": "queue 1, item 9 (MoE)",
    "deepseek-v2-lite-16b": "queue 1, item 9 (MLA; d_qk 192 needs the "
                            "D > 128 kernel of queue 2)",
    "whisper-small": "queue 1, item 9 (encoder-decoder)",
    "falcon-mamba-7b": "queue 1, item 9 (SSM)",
    "zamba2-7b": "queue 1, item 9 (hybrid)",
}


def _module(name: str):
    key = name.replace("_", "-")
    if key in CANONICAL:
        return importlib.import_module(f"repro_torch.configs.{CANONICAL[key]}")
    if key in PENDING:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP {PENDING[key]}")
    raise KeyError(f"unknown architecture {name!r}")


def get_config(name: str):
    return _module(name).config()


def get_reduced(name: str):
    return _module(name).reduced()

