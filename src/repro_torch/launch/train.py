"""Training launcher (counterpart of ``src/repro/launch/train.py``).

One device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --seq-len 4096 --global-batch 2 --grad-accum 2 --steps 3

A mesh, one card a rank on NCCL (``--hp`` head ranks; ``cp = world //
hp`` context ranks as ``outer x inner``, ``--inner`` defaulting to
``min(cp, 4)``; ``--placement head_first|context_first``):

    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch qwen3-1.7b --hp 2 --inner 2 --seq-len 16384 --global-batch 1

``--pack`` trains on packed documents (``PackedLM``: variable-length
documents bin-packed into each sequence, each masked to itself in
attention), their mean length ``--mean-doc-len`` (default ``max(8, seq //
4)``).

Checkpoints (``--ckpt-dir``): async per-shard saves every
``--save-every`` steps (``--ckpt-every`` is its older name; default 50);
SIGTERM saves a final checkpoint at a step boundary and exits 0; a
relaunch resumes from the latest step, also under another grid or ZeRO
extent (the restore reshards).  ``--no-resume`` starts fresh.

``--offload-chunks N`` moves only the plan, as in the reference: the
memory model charges the resident chunk fraction of the activations and
``plan.describe()`` prints the wire time and ``max_seq@budget``.

``--smoke`` swaps in the reduced config at a CPU-sized shape (``--device
cpu --smoke`` runs the whole path on the CPU, on gloo under torchrun);
``--layers`` cuts the depth (for zamba2-7b it may leave a tail after the
last whole group: ``--layers 7`` is one group of 6 and one tail layer; for
whisper-small it cuts the encoder and the decoder alike).  Every decision is made by ``build_plan`` and
printed by ``plan.describe()`` on rank 0: the ZeRO extent from the memory
model at this rank's share of its device (hybrid ZeRO over the mesh), and
with ``--remat auto`` the remat policy.  ``--plan-file``/``--tune`` exit
with the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.plan import build_plan
from repro_torch.launch import args as launch_args
from repro_torch.launch.mesh import production_plan, world_size
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

#: flag -> why it exits
PENDING_FLAGS = {
    "plan_file": "tuned plans are ROADMAP queue 1, item 13",
    "tune": "the plan tuner is ROADMAP queue 1, item 13",
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
    ap.add_argument("--remat", default=None, help="none|full|scpp|auto "
                    "(default: the model config's; auto: from the memory "
                    "model)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hp", type=int, default=None)
    ap.add_argument("--inner", type=int, default=None)
    ap.add_argument("--placement", default=None)
    ap.add_argument("--pack", action="store_true",
                    help="packed documents (PackedLM): bin-packed "
                         "variable-length documents, each masked to itself")
    ap.add_argument("--mean-doc-len", type=int, default=None,
                    help="the packed stream's mean document length "
                         "(default: max(8, seq_len // 4))")
    ap.add_argument("--offload-chunks", type=int, default=None,
                    help="FPDT sequence chunks of the memory model (default "
                         "1: fully resident); moves only the plan")
    ap.add_argument("--plan-file", default=None)
    ap.add_argument("--tune", action="store_true")
    launch_args.add_checkpointing(ap)
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
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, encoder_layers=args.layers)
    mean_doc = (args.mean_doc_len or max(8, seq // 4)) if args.pack else None
    kw = dict(opt=OptConfig(lr=args.lr, total_steps=args.steps),
              device=args.device, grad_accum=args.grad_accum,
              remat=args.remat, seq_len=seq, global_batch=gb,
              packed=args.pack, mean_doc_len=mean_doc,
              offload_chunks=args.offload_chunks)
    if world_size() > 1 or any(x is not None for x in (args.hp, args.inner,
                                                       args.placement)):
        plan = production_plan(cfg, hp=args.hp, inner=args.inner,
                               placement=args.placement, **kw)
    else:
        plan = build_plan(cfg, **kw)
    trainer = Trainer(plan, plan.data_config(seq, gb),
                      TrainerConfig(num_steps=args.steps, seed=args.seed,
                                    ckpt_dir=args.ckpt_dir,
                                    ckpt_every=launch_args.save_every(args),
                                    resume=args.resume))
    return plan, trainer


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    started = not dist.is_initialized()
    try:
        plan, trainer = make_trainer(args)
        if trainer.logs:
            print(plan.describe())
        if trainer.logs and trainer.ckpter is not None:
            print(f"start step: {trainer.start_step}")
        losses = trainer.run()
        if trainer.logs:
            print(f"losses: {[round(x, 4) for x in losses]}")
            if losses:
                print(f"final loss: {losses[-1]:.4f} "
                      f"(median step {trainer.monitor.median:.3f}s)")
            rep = trainer.monitor.report()
            if rep["stragglers"]:
                print(f"stragglers flagged: {rep['stragglers']}")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
