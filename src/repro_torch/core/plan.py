"""The execution plan: every cross-layer decision, made once (counterpart
of ``src/repro/core/plan.py``).

The plan resolves remat, builds the ``Runtime`` (on more than one device:
the mesh over the initialised ``torch.distributed`` world, its backend and
this rank's coordinates) and the microbatch grid, and describes itself.
Parameters and optimizer state are replicated on every rank (the
reference's ``"replica"`` ZeRO mode).  What needs more than that raises
and names its ROADMAP item: another ZeRO extent, ``remat="auto"`` or the
memory model ``plan_memory`` (item 7), packed documents (item 8), the FPDT
offload pipeline (item 11) and tuned plans (item 13).
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from repro_torch.core.runtime import Runtime, world_runtime
from repro_torch.core.topology import ParallelConfig
from repro_torch.models.model import remat_policy
from repro_torch.train.optimizer import OptConfig


#: The ZeRO modes this slice plans: None and ``"replica"`` (the
#: reference's ``ZERO_MODES[0]``), both replicating every leaf.
ZERO_MODES = (None, "replica")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Consumers read decisions from here: ``plan.cfg`` (remat already
    resolved), ``plan.rt`` (device and attention impl), ``plan.opt`` and
    ``plan.grad_accum``."""
    cfg: "ModelConfig"               # remat already resolved
    pc: ParallelConfig
    opt: OptConfig
    rt: Runtime
    grad_accum: int = 1
    seq_len: int | None = None
    global_batch: int | None = None
    packed: bool = False

    def data_config(self, seq_len: int, global_batch: int,
                    zigzag: bool | None = None, **kw):
        """The ``DataConfig`` consistent with this plan (cp, zigzag layout,
        microbatch grid)."""
        from repro_torch.data.pipeline import DataConfig
        if zigzag is None:
            zigzag = self.cfg.zigzag and self.cfg.family == "dense"
        return DataConfig(vocab=self.cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch, cp=self.pc.cp,
                          zigzag=zigzag, grad_accum=self.grad_accum, **kw)

    def describe(self) -> str:
        cfg, pc, rt = self.cfg, self.pc, self.rt
        micro = (self.global_batch // self.grad_accum
                 if self.global_batch else None)
        if rt.mesh is None:
            where = [f"ExecutionPlan: {cfg.name} [{cfg.family}] on 1 device "
                     f"({rt.device})"]
        else:
            c = rt.coord
            where = [
                f"ExecutionPlan: {cfg.name} [{cfg.family}] on "
                f"{pc.num_devices} ranks ({rt.backend}, {rt.device}"
                f"{', host-staged collectives' if rt.stage_host else ''})",
                f"  mesh        (pod, data, head, outer, inner) = "
                f"{tuple(rt.mesh.mesh.shape)} placement={pc.placement}",
                f"  this rank   {dist.get_rank()}: pod={c.pod} "
                f"data={c.data} head={c.head} outer={c.outer} "
                f"inner={c.inner}"]
        return "\n".join(where + [
            f"  parallel    dp={pc.dp} hp={pc.hp} cp={pc.cp} "
            f"(outer={pc.cp_outer} inner={pc.cp_inner})",
            "  zero        replica (params and optimizer state on every "
            "rank)",
            f"  batch       global_batch={self.global_batch} "
            f"seq_len={self.seq_len} grad_accum={self.grad_accum} "
            f"microbatch={micro}",
            f"  attention   impl={self.rt.impl} zigzag={cfg.zigzag}",
            f"  precision   compute={cfg.dtype} masters=float32",
            f"  remat       {cfg.remat}",
            f"  optimizer   AdamW lr={self.opt.lr} "
            f"steps={self.opt.total_steps}",
        ])


def build_plan(cfg, pc: ParallelConfig | None = None,
               opt: OptConfig | None = None, *, device=None,
               impl: str | None = None, grad_accum: int | None = None,
               remat: str | None = None, zero: str | None = None,
               seq_len: int | None = None, global_batch: int | None = None,
               packed: bool = False, mean_doc_len: int | None = None,
               offload_chunks: int | None = None,
               tuned=None) -> ExecutionPlan:
    """Build the plan.  ``remat`` None keeps ``cfg.remat``; ``impl`` None
    is ``"auto"`` (the kernels on the card, the dense oracle on the CPU);
    ``device`` None is ``cuda``.  With ``pc.num_devices > 1``,
    ``torch.distributed`` must be initialised with that world size; the
    plan then holds this rank's mesh ``Runtime``."""
    pc = pc or ParallelConfig()
    pc.validate()
    if pc.num_devices > 1:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != pc.num_devices:
            raise RuntimeError(
                f"{pc} spans {pc.num_devices} ranks, but torch.distributed "
                + (f"has a world of {world}" if dist.is_initialized()
                   else "is not initialised")
                + ": launch one process a rank (torchrun)")
    if zero not in ZERO_MODES:
        raise NotImplementedError(
            f"zero={zero!r}: ZeRO extents other than {ZERO_MODES[1]!r} and "
            "plan_memory are ROADMAP queue 1, item 7")
    if remat == "auto":
        raise NotImplementedError("remat='auto' needs plan_memory: ROADMAP "
                                  "queue 1, item 7")
    if packed or mean_doc_len is not None:
        raise NotImplementedError("packed documents are ROADMAP queue 1, "
                                  "item 8")
    if offload_chunks not in (None, 1):
        raise NotImplementedError("the FPDT offload pipeline is ROADMAP "
                                  "queue 1, item 11")
    if tuned is not None:
        raise NotImplementedError("tuned plans are ROADMAP queue 1, item 13")
    grad_accum = 1 if grad_accum is None else int(grad_accum)
    if grad_accum < 1 or (global_batch is not None
                          and global_batch % grad_accum):
        raise ValueError(f"grad_accum {grad_accum} must divide "
                         f"global_batch {global_batch}")
    policy = remat_policy(cfg.remat if remat is None else remat)
    if policy != cfg.remat:
        cfg = dataclasses.replace(cfg, remat=policy)
    if pc.num_devices > 1:
        rt = world_runtime(pc, impl=impl or "auto", device=device)
    else:
        rt = Runtime(pc=pc, impl=impl or "auto", device=device)
    return ExecutionPlan(cfg=cfg, pc=pc, opt=opt or OptConfig(), rt=rt,
                         grad_accum=grad_accum, seq_len=seq_len,
                         global_batch=global_batch)
