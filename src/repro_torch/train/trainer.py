"""End-to-end trainer: data -> train step -> metrics, with checkpoints,
preemption flush, deterministic resume and step-time monitoring
(counterpart of ``src/repro/train/trainer.py``).

The trainer consumes an ``ExecutionPlan`` and makes no decision of its own:
a packed plan trains on ``PackedLM``, any other on ``SyntheticLM``.
The loop syncs with the device only at ``log_every`` boundaries: metrics
stay device scalars until then, so the host queues the next step while
the device runs the last.  On a mesh every rank runs the same loop on its
shard of each batch; the losses are global, so every rank returns the
same ones, and only rank 0 logs.  Every rank draws the full parameters
from the seeded generator and keeps only its ZeRO shards of them
(``core/zero.py``); ``self.params`` and the moments are those shards
(``gather_params`` puts a tree together).

With ``ckpt_dir``, the trainer resumes at the latest checkpoint there
(``resume``), through this run's plan, whatever grid or ZeRO extent
saved it; ``iter_batches`` starts at that step, so a resume skips the
batches done rather than replaying them.  It saves asynchronously every
``ckpt_every`` steps and flushes at the end.  On SIGTERM it saves a final
checkpoint at a step boundary, flushes and stops.  On one device that is
the step the signal landed in; on a mesh the ranks agree on it at the
next ``log_every`` sync, where one flag is summed over the world, so the
loop gains no host sync and every rank stops at the same step.
"""
from __future__ import annotations

import dataclasses
import logging

import torch
import torch.distributed as dist

from repro_torch.core.runtime import all_reduce_
from repro_torch.core.zero import shard_params
from repro_torch.data.pipeline import PackedLM, SyntheticLM, rank_slices
from repro_torch.models.model import init_params
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.resilience import PreemptionGuard, StepMonitor
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50      # async-save cadence (steps)
    log_every: int = 10
    seed: int = 0
    resume: bool = True       # restore the latest step in ckpt_dir


class Trainer:
    """Random fp32 parameters from a ``torch.Generator`` seeded by
    ``tcfg.seed`` on the plan's device (this rank's shards of them), then
    ``run``."""

    def __init__(self, plan, data_cfg, tcfg: TrainerConfig):
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
        self.ckpter = None
        if tcfg.ckpt_dir:
            self.ckpter = ckpt.CheckpointManager(tcfg.ckpt_dir, plan=plan)
            if tcfg.resume and self.ckpter.latest_step() is not None:
                self.restore()

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def restore(self, step: int | None = None):
        """Restore (the latest step by default) through this run's plan:
        the saved shards are put together and cut to this run's layout,
        so a checkpoint of another grid or ZeRO extent resumes here."""
        state, step = self.ckpter.restore(self._state(), step=step)
        self.params, self.opt_state = state["params"], state["opt"]
        self.start_step = step
        if self.logs:
            log.info("restored checkpoint at step %d", step)

    def save(self, step: int):
        """Snapshot the state now and write it in the background."""
        if self.ckpter is not None:
            self.ckpter.save_async(self._state(), step)

    def _preempted(self, synced: bool) -> bool:
        """Whether to stop after this step.  On a mesh the flag is summed
        over the world at the loop's syncs only, so every rank stops at
        the same step."""
        if self.rt.mesh is None:
            return self.guard.requested
        if not synced:
            return False
        flag = torch.tensor([float(self.guard.requested)],
                            device=self.rt.device)
        return bool(all_reduce_(flag, self.rt).item() > 0)

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
                synced = step % self.tcfg.log_every == 0
                if synced:
                    # the only in-loop host sync; step time is amortized
                    # over the steps dispatched since the previous sync
                    loss = float(metrics["loss"])
                    n_flagged = len(self.monitor.flagged)
                    self.monitor.lap(pending)
                    pending = 0
                    if self.logs:
                        # the MoE family's aux loss rides in the loss
                        aux = (f" aux {float(metrics['aux']):.4f}"
                               if self.cfg.family == "moe" else "")
                        log.info("step %d loss %.4f gnorm %.3f%s "
                                 "(%.2fs/step)", step, loss,
                                 float(metrics["grad_norm"]), aux,
                                 self.monitor.median)
                    for s, dt, med in self.monitor.flagged[n_flagged:]:
                        log.warning("straggler flagged at step %d: "
                                    "%.3fs vs median %.3fs", s, dt, med)
                losses.append(metrics["loss"])
                saved = bool(self.ckpter) \
                    and (step + 1) % self.tcfg.ckpt_every == 0
                if saved:
                    self.save(step + 1)
                if self._preempted(synced):
                    # SIGTERM: a final checkpoint at this step boundary
                    log.warning("preemption requested: saving a checkpoint "
                                "at step %d and stopping", step + 1)
                    if not saved:
                        self.save(step + 1)
                    break
            losses = torch.stack(losses).tolist() if losses else []
            if pending:                # attribute the synced tail
                self.monitor.lap(pending)
            if self.ckpter:
                self.ckpter.flush()
        finally:
            self.guard.uninstall()
        return losses
