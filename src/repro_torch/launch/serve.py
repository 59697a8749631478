"""Serving launcher: the continuous-batching paged engine (dense and MoE
families) or the fixed-batch greedy baseline (counterpart of
``src/repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --prompt-len 4096 --gen 32 --batch 4 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke --device cpu --engine paged --requests 6 --batch 2

``--engine`` defaults to ``paged`` for the dense and MoE families and to
``fixed`` for the others.  The paged engine (``serve/engine.py``) sizes
its block pool from the plan (``serve_spec``: ``--page-size``,
``--prefill-chunk``, ``--batch`` slots) and samples with
``--temperature`` / ``--top-k`` / ``--top-p``; its prefill chunks run the
CUDA forward kernel, its decode the ref path.  The fixed engine prefills
on the forward kernel and decodes on the ref path.  The SSM and hybrid
families (``--arch falcon-mamba-7b`` / ``zamba2-7b``) prefill their Mamba
layers with the chunked scan and decode them with the one-token
recurrence.  The encoder-decoder family (``--arch whisper-small``)
prefills the encoder over frames drawn from ``--seed`` with a
``torch.Generator`` (the conv frontend is a stub, as in the reference;
``jax.random`` streams cannot be matched), then decodes against the fixed
cross caches.

Under ``torchrun`` the fixed engine runs on the 2D-Attention mesh: the
grid comes from the world size (``launch/mesh.py``, ``--hp`` /
``--inner``), the prompt is sharded over every rank as in training, and
decode combines the context ranks' partials; rank 0 prints.  The paged
engine on a mesh is ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.plan import build_plan
from repro_torch.launch.mesh import production_plan, world_size
from repro_torch.models.decode import decode_step, grow_caches, prefill
from repro_torch.models.model import init_params
from repro_torch.serve import SamplingParams, ServeEngine


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
def generate(params, cfg, rt, tokens, frames=None, gen: int = 16,
             return_stats: bool = False, fns=None):
    """Fixed-batch greedy decoding.  tokens ``(B, S_prompt)`` on
    ``rt.device`` (and the encoder-decoder family's ``frames``); returns
    ``(B, gen)`` int64 tokens.

    The cache is padded to the full ``prompt + gen`` extent once, before
    the loop (on a mesh re-split over the context ranks), and each step
    writes into it in place."""
    b, s = tokens.shape
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    pf, step, traces = fns or make_generate_fns(cfg, rt)
    logits, caches = pf(params, batch)
    caches = grow_caches(cfg, caches, gen, rt)
    out = [logits[:, -1].argmax(-1)[:, None]]
    for t in range(gen - 1):
        logits, caches = step(params, caches, out[-1], s + t)
        out.append(logits[:, -1].argmax(-1)[:, None])
    toks = torch.cat(out, dim=1)
    return (toks, traces) if return_stats else toks


def main(argv=None):
    """Parse ``argv``, serve, and return what ``_serve`` returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2,
                    help="engine decode slots / baseline batch size")
    ap.add_argument("--requests", type=int, default=0,
                    help="request-stream length (default: --batch)")
    ap.add_argument("--engine", choices=["paged", "fixed"], default=None,
                    help="default: paged for dense/moe, fixed otherwise")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hp", type=int, default=None)
    ap.add_argument("--inner", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    engine_kind = args.engine or (
        "paged" if cfg.family in ("dense", "moe") else "fixed")
    mesh = world_size() > 1 or args.hp is not None or args.inner is not None
    if engine_kind == "paged" and mesh:
        sys.exit("--engine paged: the paged engine on a mesh "
                 "(paged_cache_shardings) is ROADMAP queue 1, item 12; "
                 "use --engine fixed")
    started = not dist.is_initialized()
    try:
        return _serve(args, cfg, engine_kind, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, cfg, engine_kind: str, mesh: bool):
    """Serve the prompts drawn from seed 1; returns the paged engine's
    ``run`` result, or the fixed engine's last batch of tokens on the
    host (on a mesh, every rank's)."""
    seq = args.prompt_len + args.gen
    if mesh:
        plan = production_plan(cfg, hp=args.hp, inner=args.inner,
                               device=args.device, seq_len=seq,
                               global_batch=args.batch)
    else:
        plan = build_plan(cfg, device=args.device, seq_len=seq,
                          global_batch=args.batch)
    rt = plan.rt
    talk = not mesh or dist.get_rank() == 0
    if talk:
        print(plan.describe())
    gen = torch.Generator(device=rt.device).manual_seed(args.seed)
    params = init_params(cfg, gen, cast=True)
    n_req = args.requests or args.batch
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len)
               for _ in range(n_req)]

    if engine_kind == "paged":
        spec = plan.serve_spec(page_size=args.page_size,
                               max_batch=args.batch, max_seq_len=seq,
                               prefill_chunk=args.prefill_chunk)
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed)
        eng = ServeEngine(plan, params, spec)
        for p in prompts:
            eng.submit(p, sp, max_new_tokens=args.gen)
        res = eng.run()
        lats = sorted(r["latency_s"] for r in res["requests"].values())
        p50 = lats[len(lats) // 2]
        p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
        print(f"paged engine on {rt.device}: generated {res['generated']} "
              f"tokens from {n_req} requests in {res['wall_s']:.2f}s "
              f"({res['tokens_per_s']:.1f} tok/s, p50={p50:.2f}s "
              f"p99={p99:.2f}s, {res['engine_steps']} engine steps, "
              f"decode traces={eng.decode_traces})")
        print(f"request 0: {res['requests'][0]['tokens'][:12]}")
        return res

    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((args.batch, cfg.enc_frames, cfg.d_model),
                             generator=gen, device=rt.device)
    fns = make_generate_fns(cfg, rt)
    done = 0
    t0 = time.perf_counter()
    for i in range(0, n_req, args.batch):
        group = prompts[i:i + args.batch]
        tokens = torch.as_tensor(
            np.stack(group + [group[-1]] * (args.batch - len(group))),
            device=rt.device)
        out = generate(params, cfg, rt, tokens, frames, args.gen,
                       fns=fns).cpu()
        done += len(group) * args.gen
    dt = time.perf_counter() - t0
    if talk:
        where = (f"{plan.pc.num_devices} ranks ({rt.backend})" if mesh
                 else str(rt.device))
        print(f"fixed batch on {where}: generated {done} tokens in "
              f"{dt:.2f}s ({done / dt:.1f} tok/s)")
        print(out[:, :12])
    return out


if __name__ == "__main__":
    main()
