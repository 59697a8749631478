"""PyTorch / CUDA port of the LoongTrain reproduction (``src/repro``).

The JAX package stays the reference: every module here mirrors one file
there and is held against it by ``tests/test_torch_*.py``.  This package
imports ``torch`` and ``numpy`` and never ``jax`` or ``repro``.
"""
