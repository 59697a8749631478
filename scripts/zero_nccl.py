"""Hybrid ZeRO with gathers at use, unpacked and packed, on several cards
over NCCL, and the same runs on one card to hold their losses to.

Three steps of full-depth qwen3-1.7b in bf16 at S=8192, one sequence:
on a ``torchrun`` world the grid is hp 2 and the rest context (``cp =
world / 2``), under ``zero="dp_sp"``; on one card the whole tree.  Each
run prints its ZeRO mode, losses, step ms (host clock around a
synchronised step) and peak memory a rank, on a line starting
``RESULT <world>``.

    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    torchrun --nproc-per-node 4 scripts/zero_nccl.py
    python3 scripts/zero_nccl.py
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

SEQ, STEPS, MEAN_DOC = 8192, 3, 2048


def run(world: int, packed: bool) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.plan import build_plan
    from repro_torch.launch.mesh import production_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    kw = dict(opt=OptConfig(lr=3e-4, total_steps=STEPS), seq_len=SEQ,
              global_batch=1, packed=packed,
              mean_doc_len=MEAN_DOC if packed else None)
    cfg = get_config("qwen3-1.7b")
    if world > 1:
        plan = production_plan(cfg, hp=2, inner=2, zero="dp_sp", **kw)
    else:
        plan = build_plan(cfg, device="cuda", **kw)
    trainer = Trainer(plan, plan.data_config(SEQ, 1),
                      TrainerConfig(num_steps=STEPS, log_every=1))
    step_fn, ms = trainer.step_fn, []

    def timed(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        ms.append(round((time.perf_counter() - t0) * 1e3, 1))
        return out

    trainer.step_fn = timed
    torch.cuda.reset_peak_memory_stats()
    losses = trainer.run()
    return {"zero": plan.zero_mode, "packed": packed, "losses": losses,
            "ms": ms,
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2)}


def main():
    world = int(os.environ.get("WORLD_SIZE", "1"))
    try:
        out = []
        for packed in (False, True):
            out.append(run(world, packed))
            torch.cuda.empty_cache()
        if world == 1 or dist.get_rank() == 0:
            print(f"RESULT {world} {json.dumps(out)}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
