"""The continuous-batching paged-KV serving engine (counterpart of
``src/repro/serve/``): a paged KV cache (fixed-size blocks, a free-list
allocator, per-request block tables; ``paged_cache``), a batched sampler
(``sampling``), a request scheduler with admission, eviction and chunked
prefill (``scheduler``), and the engine that drives prefill-chunk and
decode steps at bucketed shapes, so new requests join mid-stream
(``engine``).
"""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged_cache import (BlockAllocator, blocks_needed,
                                           init_paged_caches, window_flags)
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = [
    "BlockAllocator", "Request", "SamplingParams", "Scheduler", "ServeEngine",
    "blocks_needed", "init_paged_caches", "sample_tokens", "window_flags",
]
