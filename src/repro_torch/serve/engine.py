"""The continuous-batching serve engine (counterpart of
``src/repro/serve/engine.py``).

One engine step interleaves (a) admission of waiting requests into free
slots, (b) one chunked-prefill call for the oldest admitted request, and
(c) one decode + sample step over every in-flight sequence, so a long
prompt never stalls the decode batch and finished sequences retire in
place for the next waiting request.

Shapes are bucketed: decode always runs at ``(max_batch, 1)`` with
inactive slots masked by ``lengths == -1``, the block-table view is cut
to a power-of-two number of columns that covers the longest active
sequence, prefill chunks are padded to a power-of-two ladder, and each
request's worst case ``prompt + max_new_tokens`` is reserved at admission.
There is no jit here: ``decode_traces`` and ``prefill_traces`` count the
distinct bucketed shapes a step has run at (the keys a jit would compile,
under the reference's names), and they stay at the ladder's size across a
stream.

The decode loop does not sync with the host: every per-slot state
(lengths, last tokens, sampling parameters, random streams, the output
buffer, block tables) lives on the device, updated in place, and the
generated tokens are fetched when a request retires, unless a request
asked for EOS detection, which reads the tokens every step.  Prefill
chunks run at B=1 with an int band, so their attention runs on the
forward kernel on the card (``models/decode.py::prefill_chunk``).  The
engine serves on one rank (the paged engine on a mesh is ROADMAP queue 1,
item 12).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.decode import PagedLayout, decode_step, prefill_chunk
from repro_torch.models.model import cast_params_once
from repro_torch.serve.paged_cache import (BlockAllocator, init_paged_caches,
                                           window_flags)
from repro_torch.serve.sampling import (SamplingParams, request_stream,
                                        sample_tokens)
from repro_torch.serve.scheduler import DECODE, Request, Scheduler

MIN_BUCKET = 16


def _pow2(n: int, lo: int, hi: int | None = None) -> int:
    """The smallest power of two ``>= n``, floored at ``lo``, capped at
    ``hi``: the one bucket ladder of prefill chunks, decode views and
    warmup."""
    b = lo
    while b < n:
        b *= 2
    return b if hi is None else min(b, hi)


class ServeEngine:
    """Continuous-batching engine over an ``ExecutionPlan`` and params.

    ``submit()`` queues prompts; ``step()`` advances by one scheduler
    tick; ``run()`` drains everything and returns per-request outputs with
    latency stats.  Dense and MoE families (GQA full and sliding-window
    attention, absorbed MLA)."""

    #: output-buffer width: a request generates at most this many tokens
    MAX_NEW_CAP = 1024

    @torch.inference_mode()
    def __init__(self, plan, params, spec=None):
        self.plan, self.cfg, self.rt = plan, plan.cfg, plan.rt
        cfg, rt = self.cfg, self.rt
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"the paged engine serves the dense and MoE "
                             f"families, not {cfg.family}")
        if rt.mesh is not None and plan.pc.num_devices > 1:
            raise NotImplementedError(
                "the paged engine serves on one rank; on a mesh "
                "(paged_cache_shardings) it is ROADMAP queue 1, item 12")
        spec = spec or plan.serve_spec()
        if spec is None:
            raise ValueError(f"the plan has no serve spec for {cfg.family}")
        self.spec = spec
        # Serving weights are stationary: cast once, not every step.
        self.params = cast_params_once(params, cfg)

        dev = rt.device
        pools = init_paged_caches(cfg, num_blocks=spec.num_blocks,
                                  page_size=spec.page_size,
                                  max_batch=spec.max_batch, device=dev)
        self._flags = window_flags(cfg, pools)
        self.has_window = any(f for slot in self._flags["blocks"]
                              for f in slot.values())
        self.alloc = BlockAllocator(spec.num_blocks)
        self.sched = Scheduler(spec.max_batch, self.alloc, spec.page_size,
                               spec.max_blocks_per_seq)

        b, long = spec.max_batch, torch.int64
        # Device-resident per-slot state: the decode loop never reads it
        # back; slots are written at admission and prefill boundaries.
        self.st = {
            "pools": pools,
            "btabs": torch.zeros((b, spec.max_blocks_per_seq), dtype=long,
                                 device=dev),
            "lengths": torch.full((b,), -1, dtype=long, device=dev),
            "last": torch.zeros((b,), dtype=long, device=dev),
            "steps": torch.zeros((b,), dtype=long, device=dev),
            "out": torch.zeros((b, self.MAX_NEW_CAP), dtype=long,
                               device=dev),
            "temps": torch.zeros((b,), dtype=torch.float32, device=dev),
            "top_ks": torch.zeros((b,), dtype=long, device=dev),
            "top_ps": torch.ones((b,), dtype=torch.float32, device=dev),
            "streams": torch.zeros((b,), dtype=long, device=dev),
        }
        self._rows = torch.arange(b, device=dev)

        self.requests: dict[int, Request] = {}
        self._decoding: list[Request] = []      # the hot loop's DECODE list
        self._next_rid = 0
        self._decode_keys: set = set()
        self.prefill_traces: dict[tuple, int] = {}

    @property
    def decode_traces(self) -> int:
        """The distinct ``(view bucket, sampling)`` keys decode has run
        at."""
        return len(self._decode_keys)

    # -- the device steps ---------------------------------------------------

    def _fused(self, nbv: int, do_sample: bool) -> None:
        """decode_step, sampling and bookkeeping over every slot.  ``nbv``
        is the view bucket: only the first ``nbv`` block-table columns are
        gathered, so attention follows the longest *active* sequence, not
        the worst case.  ``do_sample`` False (every in-flight request
        greedy) leaves a bare argmax."""
        self._decode_keys.add((nbv, do_sample))
        st, spec = self.st, self.spec
        active = st["lengths"] >= 0
        paged = PagedLayout(st["btabs"][:, :nbv], spec.page_size,
                            spec.num_blocks)
        logits, _ = decode_step(self.params, st["pools"],
                                st["last"][:, None], st["lengths"], self.rt,
                                self.cfg, paged)
        if do_sample:
            toks = sample_tokens(logits[:, 0], st["temps"], st["top_ks"],
                                 st["top_ps"], st["streams"], st["steps"])
        else:
            toks = logits[:, 0].argmax(dim=-1)
        toks = torch.where(active, toks, st["last"])
        col = st["steps"].clamp(max=self.MAX_NEW_CAP - 1)
        st["out"][self._rows, col] = torch.where(
            active, toks, st["out"][self._rows, col])
        st["last"].copy_(toks)
        inc = active.long()
        st["lengths"] += inc
        st["steps"] += inc

    def _start(self, logits, slot: int, plen: int) -> None:
        """The first generated token after the last prefill chunk."""
        st, sl = self.st, slice(slot, slot + 1)
        tok = sample_tokens(logits, st["temps"][sl], st["top_ks"][sl],
                            st["top_ps"][sl], st["streams"][sl],
                            st["steps"][sl])
        st["last"][sl] = tok
        st["out"][sl, 0] = tok
        st["lengths"][slot] = plen
        st["steps"][slot] = 1

    # -- request intake -----------------------------------------------------

    def submit(self, prompt, sampling: SamplingParams | None = None,
               max_new_tokens: int = 16, eos_id: int | None = None) -> int:
        if max_new_tokens > self.MAX_NEW_CAP:
            raise ValueError(f"max_new_tokens {max_new_tokens} > "
                             f"{self.MAX_NEW_CAP}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid,
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      sampling=sampling or SamplingParams(),
                      max_new_tokens=int(max_new_tokens), eos_id=eos_id)
        req.t_submit = time.perf_counter()
        self.sched.submit(req)
        self.requests[rid] = req
        return rid

    # -- prefill --------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        return _pow2(n, MIN_BUCKET)

    def _prefill_chunk(self, tokens, start: int, valid: int, slot: int,
                       nbv: int):
        """One chunk at B=1: a window leaf's row of this slot (a view,
        written in place), the shared pools whole, the block-table view cut
        to ``nbv`` columns."""
        self.prefill_traces.setdefault((tokens.shape[0], nbv), 1)
        pools = self.st["pools"]
        local = {"blocks": [
            {k: leaf[:, slot:slot + 1] if flags[k] else leaf
             for k, leaf in blk.items()}
            for blk, flags in zip(pools["blocks"], self._flags["blocks"])]}
        paged = PagedLayout(self.st["btabs"][slot:slot + 1, :nbv],
                            self.spec.page_size, self.spec.num_blocks)
        logits, _ = prefill_chunk(self.params, local, tokens[None], start,
                                  valid, self.rt, self.cfg, paged)
        return logits[:, 0]

    @torch.inference_mode()
    def warmup(self, prompt_lens=(), max_new: int = 2) -> None:
        """Run every decode view bucket (greedy and sampling) and the
        prefill buckets the given prompt lengths hit, so a latency-sensitive
        caller pays the first calls' costs before opening the doors."""
        nbv = 4
        while True:
            nbv = _pow2(nbv, 4, self.spec.max_blocks_per_seq)
            # no active slot: a decode call changes nothing
            self._fused(nbv, False)
            self._fused(nbv, True)
            if nbv >= self.spec.max_blocks_per_seq:
                break
            nbv *= 2
        lens = sorted({self._bucket(n) for n in prompt_lens} or
                      {MIN_BUCKET})
        rng = np.random.default_rng(0)
        for n in lens:
            self.submit(rng.integers(0, self.cfg.vocab, size=n),
                        SamplingParams(), max_new_tokens=max_new)
        self.run()
        self.requests.clear()

    # -- one scheduler tick -------------------------------------------------

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """Admit, one prefill chunk, one decode step.  Returns the requests
        that finished in this tick."""
        finished: list[Request] = []
        if self.sched.waiting:
            for req in self.sched.admit():
                self._on_admit(req)
        pf = self.sched.next_prefill()
        if pf is not None:
            done = self._prefill_step(pf)
            if done is not None:
                finished.append(done)
        if self._decoding:
            finished.extend(self._decode_step_all())
        return finished

    def _on_admit(self, req: Request) -> None:
        s, st = req.slot, self.st
        row = np.zeros((self.spec.max_blocks_per_seq,), np.int64)
        row[:len(req.blocks)] = req.blocks
        sp = req.sampling
        st["btabs"][s] = torch.as_tensor(row, device=st["btabs"].device)
        st["lengths"][s] = -1
        st["steps"][s] = 0
        st["temps"][s] = sp.temperature
        st["top_ks"][s] = sp.top_k
        st["top_ps"][s] = sp.top_p
        st["streams"][s] = request_stream(sp, req.rid)

    def _prefill_step(self, req: Request) -> Request | None:
        s = req.slot
        remaining = req.prompt_len - req.prefilled
        if self.has_window:
            # Sliding-window layers: chunk-local banded attention is exact
            # only when the chunk covers the whole prompt.
            assert req.prefilled == 0, "window layers prefill in one chunk"
            chunk = remaining
        else:
            chunk = min(self.spec.prefill_chunk, remaining)
        lc = self._bucket(chunk)
        need_blocks = -(-(req.prefilled + chunk) // self.spec.page_size)
        nbv = _pow2(need_blocks, 4, self.spec.max_blocks_per_seq)
        tokens = np.zeros((lc,), np.int64)
        tokens[:chunk] = req.prompt[req.prefilled:req.prefilled + chunk]
        logits = self._prefill_chunk(
            torch.as_tensor(tokens, device=self.rt.device), req.prefilled,
            chunk, s, nbv)
        req.prefilled += chunk
        if req.prefilled < req.prompt_len:
            return None
        # The prompt is in: its last logits give the first token.
        self._start(logits, s, req.prompt_len)
        req.t_first = time.perf_counter()
        req.state = DECODE
        req.out_tokens = [None]          # host mirror: the count only
        self._decoding.append(req)
        if req.eos_id is not None and \
                int(self.st["last"][s]) == req.eos_id:
            return self._retire(req, s)  # EOS as the very first token
        if self._done(req):
            return self._retire(req, s)
        return None

    # -- decode -------------------------------------------------------------

    def _view_bucket(self) -> int:
        """The smallest power-of-two block count that covers every active
        sequence's next write position."""
        need = max(r.prompt_len + len(r.out_tokens) for r in self._decoding)
        need_blocks = -(-(need + 1) // self.spec.page_size)
        return _pow2(need_blocks, 4, self.spec.max_blocks_per_seq)

    def _decode_step_all(self) -> list[Request]:
        do_sample = any(r.sampling.temperature > 0 for r in self._decoding)
        self._fused(self._view_bucket(), do_sample)
        eos_toks = None
        if any(r.eos_id is not None for r in self._decoding):
            eos_toks = self.st["last"].tolist()        # a host sync
        finished = []
        for req in list(self._decoding):
            s = req.slot
            req.out_tokens.append(None)
            if eos_toks is not None and req.eos_id is not None and \
                    eos_toks[s] == req.eos_id:
                finished.append(self._retire(req, s))
            elif self._done(req):
                finished.append(self._retire(req, s))
        return finished

    def _done(self, req: Request) -> bool:
        return len(req.out_tokens) >= req.max_new_tokens

    @torch.inference_mode()
    def evict(self, rid: int) -> None:
        """Demote a running request to the waiting queue's head: pages
        released, progress reset, slot masked out of the decode batch.  Use
        this, not ``sched.evict()``, so the device state and the hot loop's
        list stay in step with the scheduler."""
        req = self.requests[rid]
        slot = req.slot
        self.sched.evict(req)
        if req in self._decoding:
            self._decoding.remove(req)
        req.out_tokens = []
        if slot >= 0:
            self.st["lengths"][slot] = -1

    def _retire(self, req: Request, slot: int) -> Request:
        n = len(req.out_tokens)
        req.out_tokens = self.st["out"][slot, :n].tolist()
        req.t_done = time.perf_counter()
        self.sched.retire(req)
        if req in self._decoding:
            self._decoding.remove(req)
        self.st["lengths"][slot] = -1
        return req

    # -- drain --------------------------------------------------------------

    def run(self, max_steps: int = 100_000) -> dict:
        """Drain every submitted request.  Returns ``{"requests": {rid:
        {"tokens", "latency_s", "first_token_s"}}, "wall_s", "generated",
        "engine_steps", "tokens_per_s"}`` over exactly the requests that
        finished in *this* call; latency is submit to done, queueing
        included."""
        t0 = time.perf_counter()
        steps = 0
        drained: list[Request] = []
        while not self.sched.idle():
            drained.extend(self.step())
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"engine did not drain in {steps} steps")
        wall = time.perf_counter() - t0
        out, generated = {}, 0
        for req in drained:
            generated += len(req.out_tokens)
            out[req.rid] = {"tokens": list(req.out_tokens),
                            "latency_s": req.t_done - req.t_submit,
                            "first_token_s": req.t_first - req.t_submit}
        return {"requests": out, "wall_s": wall, "generated": generated,
                "engine_steps": steps,
                "tokens_per_s": generated / max(wall, 1e-9)}
