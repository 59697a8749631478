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
CANONICAL = {"qwen3-1.7b": "qwen3_1_7b", "olmo-1b": "olmo_1b",
             "gemma2-2b": "gemma2_2b", "gemma3-12b": "gemma3_12b",
             "chameleon-34b": "chameleon_34b",
             "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
             "falcon-mamba-7b": "falcon_mamba_7b", "zamba2-7b": "zamba2_7b",
             "whisper-small": "whisper_small"}

#: architectures of the JAX package still to port -> the ROADMAP item
PENDING = {
    "deepseek-v2-lite-16b": "queue 1, item 9 (MLA; its MoE is ported)",
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

