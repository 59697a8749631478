"""Batched token sampling: greedy, temperature, top-k and top-p with
per-request parameters and per-request random streams (counterpart of
``src/repro/serve/sampling.py``).

One call samples the whole decode batch: every request carries its own
``(temperature, top_k, top_p)`` and its own stream.  The filters are the
reference's, in its order.  ``jax.random`` streams cannot be matched, so
the draw is a counter-based hash on the device instead of the reference's
``fold_in`` chain: a request's stream is a 32-bit mix of ``(seed, rid)``
(``request_stream``), and step ``t``'s draw for token ``j`` hashes
``(stream, t, j)`` into a uniform, taken through the Gumbel-max rule.  A
draw thus depends on ``(seed, rid, step)`` alone, so an evicted and
re-admitted request, or one moved to another slot, repeats its tokens,
and no host sync is needed.
"""
from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature <= 0`` means greedy argmax (top-k / top-p ignored);
    ``top_k == 0`` turns the top-k filter off; ``top_p >= 1`` turns the
    nucleus filter off.  The filters compose: top-k first, then top-p over
    the *unfiltered* sorted mass (the usual serving semantics)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


def _mix(x):
    """A 32-bit integer hash of a Python int or an int64 tensor holding
    values below 2^32 (every product stays below 2^63)."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


def request_stream(params: SamplingParams, rid: int) -> int:
    """The request's stream: its seed mixed with its request id."""
    return _mix(_mix(params.seed & _M32) ^ (rid & _M32))


def _uniforms(streams, steps, vocab: int):
    """``(B, vocab)`` float64 uniforms in (0, 1): element ``(b, j)`` hashes
    ``(streams[b], steps[b], j)``."""
    base = _mix(_mix(streams.long() & _M32) ^ (steps.long() & _M32))
    ids = torch.arange(vocab, device=base.device, dtype=torch.int64)
    x = _mix(_mix((base[:, None] + ids[None] * _GOLDEN) & _M32))
    return (x.double() + 0.5) / 2.0 ** 32


def filter_logits(scaled, top_ks, top_ps):
    """``scaled`` ``(B, V)`` with the tokens outside the top-k set and the
    top-p nucleus at ``-inf``.  Ties at the top-k boundary keep every tied
    logit; the exclusive cumsum keeps the argmax even for a tiny p."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (top_ks.long() - 1).clamp(0, v - 1)[:, None])
    keep_k = (top_ks[:, None] <= 0) | (scaled >= kth)
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum_excl = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    keep_sorted = cum_excl < top_ps[:, None]
    thresh = torch.where(keep_sorted, sorted_desc,
                         torch.full_like(sorted_desc, float("inf"))
                         ).min(dim=-1).values
    keep_p = scaled >= thresh[:, None]
    return torch.where(keep_k & keep_p, scaled,
                       torch.full_like(scaled, float("-inf")))


def sample_tokens(logits, temps, top_ks, top_ps, streams, steps):
    """One token a request.

    logits ``(B, V)``; temps ``(B,)`` fp32; top_ks ``(B,)`` int; top_ps
    ``(B,)`` fp32; streams ``(B,)`` int64 (``request_stream``); steps
    ``(B,)`` int, the request's step index.  Returns ``(B,)`` int64."""
    logits = logits.float()
    temps = temps.float()
    top_ps = top_ps.float().clamp(1e-6, 1.0)
    greedy = logits.argmax(dim=-1)
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    masked = filter_logits(scaled, top_ks, top_ps)
    gumbel = -torch.log(-torch.log(_uniforms(streams, steps,
                                             logits.shape[-1])))
    drawn = (masked.double() + gumbel).argmax(dim=-1)
    return torch.where(temps <= 0.0, greedy, drawn)
