"""Request lifecycle and admission control for the continuous-batching
engine (counterpart of ``src/repro/serve/scheduler.py``; host-only code,
ported as it is).

A ``Request`` moves ``waiting -> prefill -> decode -> finished``.  The
``Scheduler`` owns the waiting queue, the fixed pool of engine slots, and
the block allocator: a request is admitted only when a slot is free AND
its *worst-case* footprint (``ceil((prompt + max_new) / page) `` blocks)
can be reserved, so a running request can never be starved of pages
mid-stream.  ``evict`` demotes a running request back to the head of the
waiting queue (its pages are released and its progress reset) — the
pressure valve for oversubscribed pools.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.serve.paged_cache import BlockAllocator, blocks_needed
from repro_torch.serve.sampling import SamplingParams

WAITING, PREFILL, DECODE, FINISHED = "waiting", "prefill", "decode", \
    "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (S,) int32
    sampling: SamplingParams
    max_new_tokens: int = 16
    eos_id: int | None = None
    # -- engine state --
    state: str = WAITING
    slot: int = -1
    blocks: list = dataclasses.field(default_factory=list)
    prefilled: int = 0                   # prompt tokens already in cache
    out_tokens: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0                 # first generated token
    t_done: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


class Scheduler:
    """Admission / eviction over ``max_batch`` slots + the block pool."""

    def __init__(self, max_batch: int, allocator: BlockAllocator,
                 page_size: int, max_blocks_per_seq: int):
        self.max_batch = max_batch
        self.alloc = allocator
        self.page_size = page_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.waiting: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_batch

    # -- queries ------------------------------------------------------------

    def free_slot(self) -> int | None:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def running(self, *states) -> list[Request]:
        states = states or (PREFILL, DECODE)
        return [r for r in self.slots if r is not None and r.state in states]

    def next_prefill(self) -> Request | None:
        for r in self.slots:
            if r is not None and r.state == PREFILL:
                return r
        return None

    def idle(self) -> bool:
        return not self.waiting and all(r is None for r in self.slots)

    # -- transitions --------------------------------------------------------

    def submit(self, req: Request) -> None:
        assert req.state == WAITING, req.state
        n = blocks_needed(req.total_len, self.page_size)
        if n > self.max_blocks_per_seq:
            raise ValueError(
                f"request {req.rid}: {req.total_len} tokens need {n} blocks"
                f" > max_blocks_per_seq={self.max_blocks_per_seq}")
        self.waiting.append(req)

    def admit(self) -> list[Request]:
        """Move waiting requests into free slots while blocks last (FIFO —
        no request starves behind a shorter latecomer)."""
        admitted = []
        while self.waiting:
            slot = self.free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            blocks = self.alloc.alloc(
                blocks_needed(req.total_len, self.page_size))
            if blocks is None:
                break
            self.waiting.popleft()
            req.state, req.slot, req.blocks = PREFILL, slot, blocks
            req.prefilled = 0
            req.out_tokens = []
            self.slots[slot] = req
            admitted.append(req)
        return admitted

    def evict(self, req: Request) -> None:
        """Demote a running request to the waiting-queue head, releasing
        its pages (progress restarts from scratch on re-admission).
        Engine users must go through ``ServeEngine.evict``, which also
        clears the device-state slot and the hot-loop mirror."""
        assert req.state in (PREFILL, DECODE), req.state
        self._release(req)
        req.state = WAITING
        self.waiting.appendleft(req)

    def retire(self, req: Request) -> None:
        assert req.state in (PREFILL, DECODE), req.state
        self._release(req)
        req.state = FINISHED

    def _release(self, req: Request) -> None:
        self.alloc.free(req.blocks)
        self.slots[req.slot] = None
        req.blocks, req.slot, req.prefilled = [], -1, 0
