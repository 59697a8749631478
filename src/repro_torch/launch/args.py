"""Launcher argument builders (counterpart of ``src/repro/launch/args.py``):
the checkpoint flags and their effective save cadence."""
from __future__ import annotations


def add_checkpointing(ap):
    """``--ckpt-dir`` / ``--save-every`` (``--ckpt-every``) /
    ``--resume`` / ``--no-resume``: the trainer's checkpoint surface."""
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: per-shard async saves, "
                         "resume from the latest step")
    ap.add_argument("--save-every", type=int, default=None,
                    help="async-save cadence in steps (default 50)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="deprecated alias of --save-every")
    ap.add_argument("--resume", dest="resume", action="store_true",
                    default=True,
                    help="resume from the latest checkpoint in --ckpt-dir "
                         "(default)")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    help="start fresh even when --ckpt-dir holds "
                         "checkpoints")


def save_every(args) -> int:
    """The effective save cadence: ``--save-every`` wins, the deprecated
    ``--ckpt-every`` still works, default 50."""
    if args.save_every is not None:
        return args.save_every
    if args.ckpt_every is not None:
        return args.ckpt_every
    return 50
