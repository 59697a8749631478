"""Host KV offload: chunk residency for the sequence-chunk pipeline (FPDT,
arxiv 2408.16978; counterpart of ``src/repro/runtime/offload.py``).

The resident 2D-Attention keeps the whole local sequence on the device,
so the longest trainable context is capped by device memory.  The chunk
pipeline (``core/attention2d.py::ChunkedAttention``) streams the sequence
through attention a chunk at a time; every chunk not in flight lives in
pinned host memory.  ``OffloadManager`` is the broker:

* ``put(key, x)``      device -> host copy, complete when ``put`` returns;
  any device copy of ``key`` leaves the residency account.
* ``prefetch(key)``    starts the host -> device copy: on a card, a
  ``non_blocking`` copy on the manager's side stream, with an event
  recorded after it, so a prefetch issued a chunk ahead overlaps the
  current chunk's kernels.
* ``get(key)``         the device tensor, never before its copy landed:
  the consuming stream waits on the copy's event, and ``record_stream``
  keeps the caching allocator from reusing the block before that stream
  is done with it.  A ``get`` without a prior ``prefetch`` still works
  but counts a ``stall``.
* ``release(key)``     drops the device copy (waiting for a copy still in
  flight first); the host bits are already current.
* ``accumulate(key, delta)``  host fp32 ``+=`` for grads that come home a
  chunk at a time (dk / dv in the backward).

Residency accounting is the contract: ``device_bytes`` counts every
manager-held device chunk, ``peak_device_bytes`` its high-water mark, and
``budget_bytes`` is enforced: a fetch that would exceed it raises
``BudgetExceeded``.  On the CPU the copies are plain copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable

import numpy as np
import torch

#: chunk residency states
HOST, FETCHING, DEVICE = "host", "fetching", "device"


class BudgetExceeded(RuntimeError):
    """A fetch would push manager-held device bytes over the budget."""


@dataclasses.dataclass
class _Entry:
    host: torch.Tensor | None = None
    dev: Any = None
    device: torch.device | None = None   # where ``prefetch`` copies to:
                                         # the device it was put from
    state: str = HOST
    landed: bool = False                 # host -> device copy complete
    event: Any = None                    # the copy's CUDA event
    nbytes: int = 0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to_host(x, *, pin: bool) -> torch.Tensor:
    """A host copy of ``x`` (tensor or array), complete on return."""
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(np.array(x, copy=True))
    x = x.detach()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
    host.copy_(x)               # blocking: the bytes are home on return
    return host


class OffloadManager:
    """Host <-> device chunk broker with enforced residency accounting.

    ``budget_bytes=None`` disables enforcement (the accounts still run).
    A chunk is fetched back to the device it was put from."""

    def __init__(self, budget_bytes: int | None = None):
        self.budget_bytes = budget_bytes
        self._entries: dict[Hashable, _Entry] = {}
        self._stream = None          # the side stream of the h2d copies
        # accounting / telemetry
        self.device_bytes = 0
        self.peak_device_bytes = 0
        self.host_bytes = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.stalls = 0     # get() before any prefetch (sync fetch)
        self.waits = 0      # get() of a copy still in flight

    # -- internal ----------------------------------------------------------

    def _charge(self, key, n: int):
        if self.budget_bytes is not None \
                and self.device_bytes + n > self.budget_bytes:
            raise BudgetExceeded(
                f"fetching {key!r} ({n}B) would put device residency at "
                f"{self.device_bytes + n}B > budget {self.budget_bytes}B")
        self.device_bytes += n
        self.peak_device_bytes = max(self.peak_device_bytes,
                                     self.device_bytes)

    def _entry(self, key) -> _Entry:
        e = self._entries.get(key)
        if e is None:
            raise KeyError(f"unknown offload chunk {key!r}")
        return e

    def _side_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        return self._stream

    @staticmethod
    def _target(x) -> torch.device:
        return x.device if isinstance(x, torch.Tensor) \
            else torch.device("cpu")

    # -- public ------------------------------------------------------------

    def put(self, key, x) -> None:
        """Stage ``x`` on the host (device -> host copy, complete when this
        returns); drops any device copy of ``key``."""
        device = self._target(x)
        host = _to_host(x, pin=device.type == "cuda")
        old = self._entries.get(key)
        if old is not None:
            if old.state != HOST:
                self.device_bytes -= old.nbytes
            if old.host is not None:
                self.host_bytes -= _nbytes(old.host)
        n = _nbytes(host)
        self._entries[key] = _Entry(host=host, device=device, state=HOST,
                                    nbytes=n)
        self.host_bytes += n
        self.d2h_bytes += n

    def accumulate(self, key, delta) -> None:
        """Host-side fp32 ``+=`` (the first call initializes from
        ``delta``)."""
        device = self._target(delta)
        d = _to_host(delta.detach().float() if isinstance(delta, torch.Tensor)
                     else np.asarray(delta, np.float32),
                     pin=device.type == "cuda")
        e = self._entries.get(key)
        self.d2h_bytes += _nbytes(d)
        if e is None or e.host is None:
            self._entries[key] = _Entry(host=d, device=device, state=HOST,
                                        nbytes=_nbytes(d))
            self.host_bytes += _nbytes(d)
        else:
            if e.state != HOST:
                raise RuntimeError(f"accumulate into resident {key!r}")
            e.host += d

    def prefetch(self, key) -> None:
        """Start the host -> device copy; no-op if already in flight or
        resident."""
        e = self._entry(key)
        if e.state != HOST:
            return
        if e.host is None:
            raise RuntimeError(f"{key!r} has no host copy to fetch")
        self._charge(key, e.nbytes)
        if e.device.type == "cuda":
            stream = self._side_stream(e.device)
            with torch.cuda.stream(stream):
                e.dev = e.host.to(e.device, non_blocking=True)
                e.event = torch.cuda.Event()
                e.event.record(stream)
        else:
            e.dev = e.host.to(e.device, copy=True)
        e.state, e.landed = FETCHING, False
        self.h2d_bytes += e.nbytes

    def get(self, key):
        """The device tensor for ``key``, never before its copy landed."""
        e = self._entry(key)
        if e.state == HOST:
            self.stalls += 1                 # pipeline bubble: sync fetch
            self.prefetch(key)
        if e.state == FETCHING:
            self.waits += 1
            if e.event is not None:          # the landing barrier
                consumer = torch.cuda.current_stream(e.device)
                consumer.wait_event(e.event)
                e.dev.record_stream(consumer)
            e.state, e.landed = DEVICE, True
        if not (e.state == DEVICE and e.landed):
            raise RuntimeError(f"{key!r} is {e.state}, not landed")
        return e.dev

    def release(self, key) -> None:
        """Drop the device copy; the host bits stay current (no copy)."""
        e = self._entry(key)
        if e.state == HOST:
            return
        if e.state == FETCHING and e.event is not None:
            e.event.synchronize()            # never free mid-copy
        e.dev, e.event, e.state, e.landed = None, None, HOST, False
        self.device_bytes -= e.nbytes

    def host_array(self, key) -> torch.Tensor:
        """The host copy (the final gather of accumulated grads)."""
        e = self._entry(key)
        if e.host is None:
            raise RuntimeError(f"{key!r} has no host copy")
        return e.host

    def discard(self, key) -> None:
        """Forget ``key``, returning its bytes to the accounts."""
        e = self._entries.pop(key, None)
        if e is None:
            return
        if e.state == FETCHING and e.event is not None:
            e.event.synchronize()
        if e.state != HOST:
            self.device_bytes -= e.nbytes
        if e.host is not None:
            self.host_bytes -= _nbytes(e.host)

    def keys(self):
        return self._entries.keys()

    def resident(self):
        """Keys holding device bytes (fetching or landed)."""
        return [k for k, e in self._entries.items() if e.state != HOST]

    def stats(self) -> dict:
        return {"device_bytes": self.device_bytes,
                "peak_device_bytes": self.peak_device_bytes,
                "host_bytes": self.host_bytes,
                "h2d_bytes": self.h2d_bytes, "d2h_bytes": self.d2h_bytes,
                "stalls": self.stalls, "waits": self.waits}


def prefetched(mgr: OffloadManager, keys, *, depth: int = 2,
               release: bool = True):
    """Iterate ``(key, device tensor)`` with a ``depth``-deep prefetch
    window: the double-buffer schedule (depth 2: active + next) of the
    pipelined loops.  With budget for ``depth`` chunks it never stalls."""
    keys = list(keys)
    for k in keys[:depth]:
        mgr.prefetch(k)
    for n, k in enumerate(keys):
        x = mgr.get(k)
        if n + depth < len(keys):
            mgr.prefetch(keys[n + depth])
        yield k, x
        if release:
            mgr.release(k)
