"""Paged KV-cache pools and the host-side free-list block allocator
(counterpart of ``src/repro/serve/paged_cache.py``).

Full-attention K/V (and the MLA latent) live in fixed-size block pools
``(layers, num_blocks, page_size, ...)`` shared by every request; a
request owns an ordered list of physical blocks, recorded in its block
table row.  Sliding-window layers keep per-slot ring buffers ``(groups,
max_batch, window, Hkv, d)``: they are already O(window), and a ring
write composes with paging as it is (``models/decode.py``).  The pools
serve on one rank: their sharding over a mesh (the reference's
``paged_cache_shardings``) is ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import torch


def blocks_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def init_paged_caches(cfg, *, num_blocks: int, page_size: int,
                      max_batch: int, device=None):
    """Zero block pools in ``init_caches``'s structure, so ``decode_step``
    and ``prefill_chunk`` walk the layers unchanged.  Dense and MoE
    families only (the engine's scope)."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"paged caches serve the dense and MoE families, "
                         f"not {cfg.family}")
    dt = cfg.compute_dtype

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.mla is not None:
        m, n = cfg.mla, cfg.num_layers
        return {"blocks": [{
            "c": zeros((n, num_blocks, page_size, m.kv_lora)),
            "rope": zeros((n, num_blocks, page_size, m.d_rope))}]}
    groups = cfg.num_layers // cfg.period
    caches = []
    for slot in range(cfg.period):
        kind = cfg.attn_kind(slot)
        if kind.window is not None:
            shp = (groups, max_batch, kind.window, cfg.n_kv_heads, cfg.hd)
        else:
            shp = (groups, num_blocks, page_size, cfg.n_kv_heads, cfg.hd)
        caches.append({"k": zeros(shp), "v": zeros(shp)})
    return {"blocks": caches}


def window_flags(cfg, caches):
    """A tree of bools in ``init_paged_caches``'s structure: True for the
    per-slot ring-buffer leaves, which carry a ``max_batch`` dim the engine
    takes a request's row of in prefill."""
    def flag(slot_cache, is_window: bool):
        return {k: is_window for k in slot_cache}

    if cfg.mla is not None:
        return {"blocks": [flag(caches["blocks"][0], False)]}
    return {"blocks": [
        flag(c, cfg.attn_kind(slot).window is not None)
        for slot, c in enumerate(caches["blocks"])]}


class BlockAllocator:
    """Host-side free-list allocator over the physical block pool.

    Blocks are plain ints below ``num_blocks``.  ``alloc`` is all or
    nothing (a request's worst-case footprint is reserved at admission, so
    the scheduler never deadlocks mid-stream); ``free`` returns a retired
    request's blocks.  Double frees and frees of blocks not held raise."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self._held: set[int] = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` physical blocks, or None if the pool cannot give them."""
        if n < 0 or n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._held.update(out)
        return out

    def free(self, blocks) -> None:
        for blk in blocks:
            if blk not in self._held:
                raise ValueError(f"double/foreign free of block {blk}")
            self._held.discard(blk)
            self._free.append(blk)
