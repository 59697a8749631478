"""Deterministic synthetic data with the zigzag context layout
(counterpart of ``src/repro/data/pipeline.py``).

``SyntheticLM`` emits one document per sequence.  Batch ``i`` depends only
on ``(seed, i)``, and its bytes are identical to the reference's for the
same ``DataConfig``: the same numpy generator draws the same stream.
Batches are numpy arrays; the trainer moves them to its device.  The
zigzag permutation (``_apply_layout``) is the paper's data-loader
post-processing for context-first placement (§4.4).  On a mesh every
rank draws the same global batch and keeps its shard (``rank_slices``):
its rows over ``(pod, data)`` and its piece of the physical sequence over
``(outer, inner, head)``.  Positions travel with their tokens, so RoPE
sees logical positions.  ``PackedLM`` is ROADMAP queue 1, item 8.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import batch_slice, seq_slice
from repro_torch.core.zigzag import zigzag_indices


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int          # in sequences, across all microbatches
    cp: int = 1                # context size for the zigzag layout
    zigzag: bool = True
    grad_accum: int = 1        # microbatches per step; batches come out
                               # shaped (accum, global_batch//accum, ...)
    seed: int = 0
    pad_frac: float = 0.0      # fraction of tail tokens padded (-1 labels)


def _apply_layout(arr, perm, accum: int):
    """Zigzag data-loader permutation (seq axis), then the microbatch
    split: (B, S, ...) -> (accum, B // accum, S, ...)."""
    arr = arr[:, perm]
    if accum > 1:
        arr = arr.reshape((accum, arr.shape[0] // accum) + arr.shape[1:])
    return arr


def rank_slices(cfg: DataConfig, pc, coord) -> tuple[slice, slice]:
    """The rank at ``coord`` of mesh ``pc``: its rows of each microbatch
    and its piece of the sequence."""
    return (batch_slice(pc, coord, cfg.global_batch // cfg.grad_accum),
            seq_slice(pc, coord, cfg.seq_len))


class _StepIndexed:
    """``batch(step)`` depends only on ``(cfg.seed, step)``, so a resumed
    run indexes straight to its step instead of replaying the stream."""

    def iter_batches(self, start_step: int = 0,
                     num_steps: int | None = None):
        """Yield ``(step, batch)`` from ``start_step``, for ``num_steps``
        steps (unbounded when None)."""
        step = start_step
        while num_steps is None or step < start_step + num_steps:
            yield step, self.batch(step)
            step += 1


class SyntheticLM(_StepIndexed):
    """Synthetic next-token corpus: a fixed affine map with 10% uniform
    noise, so a model can lower its loss toward the noise floor.  With
    ``grad_accum > 1`` every leaf carries a leading accumulation axis.
    ``shard``: ``rank_slices``' pair, and batches are that rank's shard."""

    def __init__(self, cfg: DataConfig, model_cfg=None, shard=None):
        if cfg.global_batch % cfg.grad_accum:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of grad_accum {cfg.grad_accum}")
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.shard = shard
        if cfg.zigzag and cfg.cp > 1:
            self._perm = zigzag_indices(cfg.seq_len, cfg.cp)
        else:
            self._perm = np.arange(cfg.seq_len)

    def _layout(self, arr):
        arr = _apply_layout(arr, self._perm, self.cfg.grad_accum)
        if self.shard is None:
            return arr
        rows, piece = self.shard
        return np.ascontiguousarray(arr[..., rows, piece])

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        stream = np.empty((b, s + 1), dtype=np.int64)
        stream[:, 0] = rng.integers(1, cfg.vocab, size=b)
        noise = rng.random((b, s)) < 0.1
        noise_tok = rng.integers(1, cfg.vocab, size=(b, s))
        for t in range(s):
            nxt = (stream[:, t] * 31 + 7) % (cfg.vocab - 1) + 1
            stream[:, t + 1] = np.where(noise[:, t], noise_tok[:, t], nxt)
        stream = stream.astype(np.int32)
        tokens = stream[:, :-1]
        labels = stream[:, 1:].copy()
        if cfg.pad_frac > 0:
            n_pad = int(s * cfg.pad_frac)
            if n_pad:
                labels[:, -n_pad:] = -1
        positions = np.broadcast_to(np.arange(s, dtype=np.int32)[None],
                                    (b, s)).copy()
        return {"tokens": self._layout(tokens),
                "labels": self._layout(labels),
                "positions": self._layout(positions)}


class PackedLM(_StepIndexed):
    """Packed documents: ROADMAP queue 1, item 8."""

    def __init__(self, cfg: DataConfig, model_cfg=None):
        raise NotImplementedError("PackedLM (packed documents) is ROADMAP "
                                  "queue 1, item 8")
