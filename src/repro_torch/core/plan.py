"""The execution plan: every cross-layer decision, made once (counterpart
of ``src/repro/core/plan.py``).

This slice plans one device (``dp == hp == cp == 1``): the plan resolves
remat, builds the ``Runtime`` and the microbatch grid, and describes
itself.  What needs more than that raises and names its ROADMAP item:
more than one device (the mesh and 2D-Attention, queue 1, items 5-6), a
ZeRO extent, ``remat="auto"`` or the memory model ``plan_memory`` (item
7), packed documents (item 8), the FPDT offload pipeline (item 11) and
tuned plans (item 13).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.runtime import Runtime
from repro_torch.core.topology import ParallelConfig
from repro_torch.models.model import remat_policy
from repro_torch.train.optimizer import OptConfig


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
        cfg, pc = self.cfg, self.pc
        micro = (self.global_batch // self.grad_accum
                 if self.global_batch else None)
        return "\n".join([
            f"ExecutionPlan: {cfg.name} [{cfg.family}] on 1 device "
            f"({self.rt.device})",
            f"  parallel    dp={pc.dp} hp={pc.hp} cp={pc.cp}",
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
    """Build the plan for one device.  ``remat`` None keeps
    ``cfg.remat``; ``impl`` None is ``"auto"`` (the kernels on the card,
    the dense oracle on the CPU); ``device`` None is ``cuda``."""
    pc = pc or ParallelConfig()
    pc.validate()
    if pc.num_devices > 1:
        raise NotImplementedError(
            f"{pc.num_devices} devices: the mesh, head all-to-all and "
            "double ring are ROADMAP queue 1, items 5-6")
    if zero is not None:
        raise NotImplementedError("ZeRO extents and plan_memory are ROADMAP "
                                  "queue 1, item 7")
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
    rt = Runtime(pc=pc, impl=impl or "auto", device=device)
    return ExecutionPlan(cfg=cfg, pc=pc, opt=opt or OptConfig(), rt=rt,
                         grad_accum=grad_accum, seq_len=seq_len,
                         global_batch=global_batch)
