"""Zigzag sequence layout for causal load balance (counterpart of
``src/repro/core/zigzag.py``).

Context rank ``r`` of ``cp`` owns the logical chunks ``(r, 2cp-1-r)``, so
that every ring step does the same amount of unmasked work.  The data
pipeline permutes tokens, labels and positions into this layout once per
batch.  ``physical`` order is what lives contiguously in the sharded
sequence dimension; ``logical`` order is the real token order.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def zigzag_indices(s: int, cp: int) -> np.ndarray:
    """perm[physical_pos] = logical_pos (length S)."""
    if cp == 1:
        return np.arange(s)
    if s % (2 * cp):
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"2 * cp = {2 * cp}")
    c = s // (2 * cp)
    out = np.empty(s, dtype=np.int64)
    for r in range(cp):
        lo = r * c
        hi = (2 * cp - 1 - r) * c
        base = r * 2 * c
        out[base:base + c] = np.arange(lo, lo + c)
        out[base + c:base + 2 * c] = np.arange(hi, hi + c)
    return out


@functools.lru_cache(maxsize=None)
def zigzag_inverse(s: int, cp: int) -> np.ndarray:
    """inv[logical_pos] = physical_pos."""
    idx = zigzag_indices(s, cp)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(s)
    return inv


def _take(x, idx: np.ndarray, axis: int):
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))


def to_zigzag(x, cp: int, axis: int = 1):
    """Logical -> physical layout along ``axis``."""
    if cp == 1:
        return x
    return _take(x, zigzag_indices(x.shape[axis], cp), axis)


def from_zigzag(x, cp: int, axis: int = 1):
    """Physical -> logical layout along ``axis``."""
    if cp == 1:
        return x
    return _take(x, zigzag_inverse(x.shape[axis], cp), axis)


def zigzag_position_ids(s: int, cp: int) -> np.ndarray:
    """Logical position of every physical slot (for rotary embeddings)."""
    return zigzag_indices(s, cp)
