"""Training launcher for one device (counterpart of
``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --seq-len 4096 --global-batch 2 --grad-accum 2 --steps 3

``--smoke`` swaps in the reduced config at a CPU-sized shape (``--device
cpu --smoke`` runs the whole path on the CPU).  Every decision is made by
``build_plan`` and printed by ``plan.describe()``.  The multi-rank flags
(``--hp``, ``--inner``, ``--placement``), ``--pack``, ``--offload-chunks``,
``--plan-file``/``--tune`` and ``--ckpt-dir`` exit with the ROADMAP item
that ports them.
"""
from __future__ import annotations

import argparse
import logging
import sys

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.plan import build_plan
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

#: flag -> why it exits
PENDING_FLAGS = {
    "hp": "head parallelism is ROADMAP queue 1, items 5-6",
    "inner": "the double ring is ROADMAP queue 1, items 5-6",
    "placement": "placements are ROADMAP queue 1, item 5",
    "pack": "packed documents are ROADMAP queue 1, item 8",
    "offload_chunks": "the FPDT offload pipeline is ROADMAP queue 1, item 11",
    "plan_file": "tuned plans are ROADMAP queue 1, item 13",
    "tune": "the plan tuner is ROADMAP queue 1, item 13",
    "ckpt_dir": "checkpointing is ROADMAP queue 1, item 10",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config at a CPU-sized shape")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=2)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default=None, help="none|full|scpp "
                    "(default: the model config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hp", type=int, default=None)
    ap.add_argument("--inner", type=int, default=None)
    ap.add_argument("--placement", default=None)
    ap.add_argument("--pack", action="store_true")
    ap.add_argument("--offload-chunks", type=int, default=None)
    ap.add_argument("--plan-file", default=None)
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    return ap.parse_args(argv)


def make_trainer(args):
    """The ``(plan, trainer)`` pair the arguments describe."""
    for flag, why in PENDING_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            sys.exit(f"--{flag.replace('_', '-')}: {why}")
    if args.smoke:
        cfg = get_reduced(args.arch)
        seq, gb = min(args.seq_len, 128), min(args.global_batch, 8)
    else:
        cfg = get_config(args.arch)
        seq, gb = args.seq_len, args.global_batch
    plan = build_plan(cfg, opt=OptConfig(lr=args.lr, total_steps=args.steps),
                      device=args.device, grad_accum=args.grad_accum,
                      remat=args.remat, seq_len=seq, global_batch=gb)
    trainer = Trainer(plan, plan.data_config(seq, gb),
                      TrainerConfig(num_steps=args.steps, seed=args.seed))
    return plan, trainer


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    plan, trainer = make_trainer(args)
    print(plan.describe())
    losses = trainer.run()
    print(f"losses: {[round(x, 4) for x in losses]}")
    print(f"final loss: {losses[-1]:.4f} "
          f"(median step {trainer.monitor.median:.3f}s)")
    rep = trainer.monitor.report()
    if rep["stragglers"]:
        print(f"stragglers flagged: {rep['stragglers']}")
    return losses


if __name__ == "__main__":
    main()
