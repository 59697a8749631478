"""Serving launcher: the fixed-batch greedy server (counterpart of
``src/repro/launch/serve.py --engine fixed``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --prompt-len 4096 --gen 32 --batch 2

Prefill runs each layer's attention through the CUDA forward kernel; decode
attention runs on the ref path.  The paged engine is ROADMAP queue 1,
item 12.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.runtime import Runtime
from repro_torch.core.topology import ParallelConfig
from repro_torch.models.decode import decode_step, grow_caches, prefill
from repro_torch.models.model import cast_params_once, init_params


def make_generate_fns(cfg, rt):
    """(prefill, decode_step, call-counter) triple for ``generate``.  There
    is no jit: the counters count calls, under the JAX package's names."""
    traces = {"prefill": 0, "decode": 0}

    def _pf(p, bt):
        traces["prefill"] += 1
        return prefill(p, bt, rt, cfg)

    def _step(p, c, t, pos):
        traces["decode"] += 1
        return decode_step(p, c, t, pos, rt, cfg)

    return _pf, _step, traces


@torch.inference_mode()
def generate(params, cfg, rt, tokens, gen: int = 16,
             return_stats: bool = False, fns=None):
    """Fixed-batch greedy decoding.  tokens ``(B, S_prompt)`` on
    ``rt.device``; returns ``(B, gen)`` int64 tokens.

    The cache is padded to the full ``prompt + gen`` extent once, before
    the loop, and each step writes into it in place."""
    b, s = tokens.shape
    pf, step, traces = fns or make_generate_fns(cfg, rt)
    logits, caches = pf(params, {"tokens": tokens})
    caches = grow_caches(cfg, caches, gen)
    out = [logits[:, -1].argmax(-1)[:, None]]
    for t in range(gen - 1):
        logits, caches = step(params, caches, out[-1], s + t)
        out.append(logits[:, -1].argmax(-1)[:, None])
    toks = torch.cat(out, dim=1)
    return (toks, traces) if return_stats else toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--requests", type=int, default=0,
                    help="request-stream length (default: --batch)")
    ap.add_argument("--engine", choices=["fixed", "paged"], default="fixed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.engine == "paged":
        sys.exit("--engine paged: the paged engine is ROADMAP queue 1, "
                 "item 12; use --engine fixed")

    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    rt = Runtime(ParallelConfig(), impl="auto", device=args.device)
    gen = torch.Generator(device=rt.device).manual_seed(args.seed)
    params = cast_params_once(init_params(cfg, gen), cfg)
    n_req = args.requests or args.batch
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len)
               for _ in range(n_req)]

    fns = make_generate_fns(cfg, rt)
    done = 0
    t0 = time.perf_counter()
    for i in range(0, n_req, args.batch):
        group = prompts[i:i + args.batch]
        tokens = torch.as_tensor(
            np.stack(group + [group[-1]] * (args.batch - len(group))),
            device=rt.device)
        out = generate(params, cfg, rt, tokens, args.gen, fns=fns).cpu()
        done += len(group) * args.gen
    dt = time.perf_counter() - t0
    print(f"fixed batch on {rt.device}: generated {done} tokens in "
          f"{dt:.2f}s ({done / dt:.1f} tok/s)")
    print(out[:, :12])


if __name__ == "__main__":
    main()
