"""End-to-end trainer: data -> train step -> metrics, with preemption and
step-time monitoring (counterpart of ``src/repro/train/trainer.py``).

The trainer consumes an ``ExecutionPlan`` and makes no decision of its own:
a packed plan trains on ``PackedLM``, any other on ``SyntheticLM``.
The loop syncs with the device only at ``log_every`` boundaries: metrics
stay device scalars until then, so the host queues the next step while
the device runs the last.  On a mesh every rank runs the same loop on its
shard of each batch; the losses are global, so every rank returns the
same ones, and only rank 0 logs.  Every rank draws the full parameters
from the seeded generator and keeps only its ZeRO shards of them
(``core/zero.py``); ``self.params`` and the moments are those shards
(``gather_params`` puts a tree together).  Checkpointing (``ckpt_dir``)
is ROADMAP queue 1, item 10.
"""
from __future__ import annotations

import dataclasses
import logging

import torch
import torch.distributed as dist

from repro_torch.core.zero import shard_params
from repro_torch.data.pipeline import PackedLM, SyntheticLM, rank_slices
from repro_torch.models.model import init_params
from repro_torch.runtime.resilience import PreemptionGuard, StepMonitor
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_dir: str | None = None
    log_every: int = 10
    seed: int = 0


class Trainer:
    """Random fp32 parameters from a ``torch.Generator`` seeded by
    ``tcfg.seed`` on the plan's device (this rank's shards of them), then
    ``run``."""

    def __init__(self, plan, data_cfg, tcfg: TrainerConfig):
        if tcfg.ckpt_dir:
            raise NotImplementedError("checkpointing (ckpt_dir) is ROADMAP "
                                      "queue 1, item 10")
        self.plan, self.tcfg = plan, tcfg
        self.cfg, self.rt = plan.cfg, plan.rt
        if data_cfg.grad_accum != plan.grad_accum:
            data_cfg = dataclasses.replace(data_cfg,
                                           grad_accum=plan.grad_accum)
        shard = (None if self.rt.mesh is None
                 else rank_slices(data_cfg, plan.pc, self.rt.coord))
        # Packed plans draw documents with their doc-start tables.
        self.data = (PackedLM if plan.packed else SyntheticLM)(
            data_cfg, plan.cfg, shard=shard)
        self.logs = self.rt.mesh is None or dist.get_rank() == 0
        self.monitor = StepMonitor()
        self.guard = PreemptionGuard()
        gen = torch.Generator(device=self.rt.device)
        self.params = shard_params(
            init_params(plan.cfg, gen.manual_seed(tcfg.seed)), plan)
        self.opt_state = init_opt_state(self.params)
        self.step_fn = make_train_step(plan)
        self.start_step = 0

    def _to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.rt.device, non_blocking=True)
                for k, v in batch.items()}

    def run(self):
        """Train ``num_steps`` steps; returns the losses as floats."""
        losses = []                    # device scalars until the end
        pending = 0                    # steps dispatched since last sync
        remaining = self.tcfg.num_steps - self.start_step
        self.guard.install()
        try:
            self.monitor.start()
            for step, batch in self.data.iter_batches(self.start_step,
                                                      remaining):
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, self._to_device(batch))
                pending += 1
                if step % self.tcfg.log_every == 0:
                    # the only in-loop host sync; step time is amortized
                    # over the steps dispatched since the previous sync
                    loss = float(metrics["loss"])
                    n_flagged = len(self.monitor.flagged)
                    self.monitor.lap(pending)
                    pending = 0
                    if self.logs:
                        log.info("step %d loss %.4f gnorm %.3f "
                                 "(%.2fs/step)", step, loss,
                                 float(metrics["grad_norm"]),
                                 self.monitor.median)
                    for s, dt, med in self.monitor.flagged[n_flagged:]:
                        log.warning("straggler flagged at step %d: "
                                    "%.3fs vs median %.3fs", s, dt, med)
                losses.append(metrics["loss"])
                if self.guard.requested:
                    log.warning("preemption requested: stopping at step %d",
                                step + 1)
                    break
            losses = torch.stack(losses).tolist() if losses else []
            if pending:                # attribute the synced tail
                self.monitor.lap(pending)
        finally:
            self.guard.uninstall()
        return losses
