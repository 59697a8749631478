"""Deterministic synthetic data with the zigzag context layout
(counterpart of ``src/repro/data/pipeline.py``).

``SyntheticLM`` emits one document per sequence; ``PackedLM`` bin-packs
variable-length documents into each sequence and adds the per-token
``doc_start`` table that masks each document to itself in attention.
Batch ``i`` depends only on ``(seed, i)``, and its bytes are identical to
the reference's for the same ``DataConfig``: the same numpy generators
draw the same streams.
Batches are numpy arrays; the trainer moves them to its device.  The
zigzag permutation (``_apply_layout``) is the paper's data-loader
post-processing for context-first placement (§4.4).  On a mesh every
rank draws the same global batch and keeps its shard (``rank_slices``):
its rows over ``(pod, data)`` and its piece of the physical sequence over
``(outer, inner, head)``.  Positions travel with their tokens, so RoPE
sees logical positions.  The encoder-decoder family's ``frames`` (the
stubbed conv frontend's output) take the microbatch split but no
sequence permutation, and a rank's piece of them is the contiguous slice
of the frame axis with the same index as its piece of the tokens (the
reference's ``P(batch, SEQ_AXES, None)``).
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
    #: PackedLM: (min, max) document length, inclusive; None is
    #: (max(8, seq_len // 8), seq_len), a mixed-length stream
    doc_len_range: tuple | None = None


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
    run indexes straight to its step instead of replaying the stream.
    ``shard``: ``rank_slices``' pair, and batches are that rank's shard."""

    def _init_layout(self, cfg: DataConfig, shard):
        if cfg.global_batch % cfg.grad_accum:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of grad_accum {cfg.grad_accum}")
        self.cfg, self.shard = cfg, shard
        if cfg.zigzag and cfg.cp > 1:
            self._perm = zigzag_indices(cfg.seq_len, cfg.cp)
        else:
            self._perm = np.arange(cfg.seq_len)

    def _layout(self, arr):
        """The zigzag permutation and the microbatch split, then this
        rank's shard."""
        arr = _apply_layout(arr, self._perm, self.cfg.grad_accum)
        if self.shard is None:
            return arr
        rows, piece = self.shard
        return np.ascontiguousarray(arr[..., rows, piece])

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
    ``grad_accum > 1`` every leaf carries a leading accumulation axis."""

    def __init__(self, cfg: DataConfig, model_cfg=None, shard=None):
        self._init_layout(cfg, shard)
        self.model_cfg = model_cfg

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
        out = {"tokens": self._layout(tokens),
               "labels": self._layout(labels),
               "positions": self._layout(positions)}
        m = self.model_cfg
        if m is not None and m.family == "encdec":
            frames = rng.standard_normal(
                (b, m.enc_frames, m.d_model)).astype(np.float32)
            out["frames"] = self._frame_layout(frames)
        return out

    def _frame_layout(self, frames):
        """The microbatch split, no permutation; then this rank's rows and
        its contiguous piece of the frame axis, of the same index as its
        piece of the tokens."""
        a = self.cfg.grad_accum
        if a > 1:
            frames = frames.reshape((a, frames.shape[0] // a)
                                    + frames.shape[1:])
        if self.shard is None:
            return frames
        rows, piece = self.shard
        size = piece.stop - piece.start
        n = self.cfg.seq_len // size
        f = frames.shape[-2]
        if f % n:
            raise ValueError(f"{f} frames do not split into the {n} "
                             "sequence pieces")
        i, fs = piece.start // size, f // n
        return np.ascontiguousarray(frames[..., rows, i * fs:(i + 1) * fs,
                                           :])


def _doc_stream(vocab: int, length: int, rng) -> np.ndarray:
    """One document: ``SyntheticLM``'s stream, restarted a document, so a
    leak across documents shows in the loss and grads."""
    stream = np.empty(length, dtype=np.int64)
    stream[0] = rng.integers(1, vocab)
    noise = rng.random(length) < 0.1
    noise_tok = rng.integers(1, vocab, size=length)
    for t in range(length - 1):
        nxt = (stream[t] * 31 + 7) % (vocab - 1) + 1
        stream[t + 1] = noise_tok[t] if noise[t] else nxt
    return stream.astype(np.int32)


class PackedLM(_StepIndexed):
    """Packed documents: variable-length documents bin-packed into the
    ``(accum, microbatch, seq)`` batches, with ``doc_start``, the table of
    each token's document start (logical position), beside the tokens.

    A step's document lengths are drawn from ``cfg.doc_len_range`` and
    packed first-fit-decreasing into ``global_batch`` bins of ``seq_len``
    tokens; a bin's tail is padding (label -1, ``doc_start`` the tail's own
    start, so pad tokens see only one another and train nothing).  A
    document's tokens are seeded by ``(seed, step, doc id)``, so where it
    lands does not change them.  Labels are next-token within a document
    (its last token predicts nothing) and positions restart at 0 a
    document.  Every per-token array takes ``SyntheticLM``'s layout and
    shard.  ``documents``, ``boundaries`` and ``segments`` are host views
    of a step, in logical order, over the whole global batch."""

    def __init__(self, cfg: DataConfig, model_cfg=None, shard=None):
        if model_cfg is not None and model_cfg.family == "encdec":
            raise ValueError("packing is a decoder-LM feature: the "
                             "encoder-decoder family has no packed mode")
        self._init_layout(cfg, shard)
        self.model_cfg = model_cfg
        s = cfg.seq_len
        lo, hi = cfg.doc_len_range or (max(8, s // 8), s)
        if not 2 <= lo <= hi <= s:
            raise ValueError(f"doc_len_range {(lo, hi)} must lie in "
                             f"[2, seq_len {s}]")
        self._range = (int(lo), int(hi))
        # One-entry caches: batch, boundaries and segments are views of one
        # step's documents, drawn once.
        self._docs_cache: tuple[int, list] | None = None
        self._asm_cache: tuple[int, tuple] | None = None

    def documents(self, step: int) -> list[list[dict]]:
        """One list a sequence of ``{"start", "tokens", "labels",
        "positions"}``, in logical order."""
        if self._docs_cache is not None and self._docs_cache[0] == step:
            return self._docs_cache[1]
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        lo, hi = self._range
        rng = np.random.default_rng((cfg.seed, step, 91))
        lens = []
        while sum(lens) < b * s:               # over-draw the pool
            lens.append(int(rng.integers(lo, hi + 1)))
        order = sorted(range(len(lens)), key=lambda i: -lens[i])
        bins: list[list[int]] = [[] for _ in range(b)]
        space = [s] * b
        for idx in order:                      # first-fit-decreasing
            for bi in range(b):
                if space[bi] >= lens[idx]:
                    bins[bi].append(idx)
                    space[bi] -= lens[idx]
                    break
        out = []
        for bi in range(b):
            docs, start = [], 0
            for idx in bins[bi]:
                n = lens[idx]
                crng = np.random.default_rng((cfg.seed, step, 7, idx))
                tokens = _doc_stream(cfg.vocab, n, crng)
                labels = np.concatenate(
                    [tokens[1:], np.full(1, -1, np.int32)])
                docs.append({"start": start, "tokens": tokens,
                             "labels": labels,
                             "positions": np.arange(n, dtype=np.int32)})
                start += n
            out.append(docs)
        self._docs_cache = (step, out)
        return out

    def boundaries(self, step: int) -> list[list[tuple[int, int]]]:
        """Per sequence, each document's ``(start, length)``."""
        return [[(d["start"], len(d["tokens"])) for d in docs]
                for docs in self.documents(step)]

    def _assemble(self, step: int):
        """The ``(B, S)`` arrays in logical order, before the layout:
        tokens, labels, positions, doc_start, segments."""
        if self._asm_cache is not None and self._asm_cache[0] == step:
            return self._asm_cache[1]
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        tokens = np.zeros((b, s), np.int32)
        labels = np.full((b, s), -1, np.int32)
        positions = np.zeros((b, s), np.int32)
        doc_start = np.zeros((b, s), np.int32)
        segments = np.full((b, s), -1, np.int32)
        for bi, docs in enumerate(self.documents(step)):
            end = 0
            for di, d in enumerate(docs):
                s0, n = d["start"], len(d["tokens"])
                tokens[bi, s0:s0 + n] = d["tokens"]
                labels[bi, s0:s0 + n] = d["labels"]
                positions[bi, s0:s0 + n] = d["positions"]
                doc_start[bi, s0:s0 + n] = s0
                segments[bi, s0:s0 + n] = di
                end = s0 + n
            doc_start[bi, end:] = end          # tail pad: its own document
        out = (tokens, labels, positions, doc_start, segments)
        self._asm_cache = (step, out)
        return out

    def segments(self, step: int) -> np.ndarray:
        """``(B, S)`` int32 document ids in logical order; -1 marks pad."""
        return self._assemble(step)[4]

    def batch(self, step: int) -> dict:
        tokens, labels, positions, doc_start, _ = self._assemble(step)
        return {"tokens": self._layout(tokens),
                "labels": self._layout(labels),
                "positions": self._layout(positions),
                "doc_start": self._layout(doc_start)}
