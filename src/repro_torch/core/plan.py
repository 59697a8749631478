"""The execution plan: every cross-layer decision, made once (counterpart
of ``src/repro/core/plan.py``).

The plan builds the ``Runtime`` (on more than one device: the mesh over
the initialised ``torch.distributed`` world, its backend and this rank's
coordinates), then runs the reference's memory model (``plan_memory``)
against this rank's memory budget:

* **hybrid ZeRO**: the AMSP extent (``replica``, ``dp``, ``sp``,
  ``dp_sp``, ``pod_dp_sp``) is the least sharded one whose parameter and
  optimizer state fits (``choose_zero_mode``); ``zero`` None is
  ``"auto"``.  Each leaf's spec comes from ``core/zero.py`` on the
  reference's logical tree, and ``ZeroLayout`` creates the process groups
  on every rank;
* **remat**: ``"auto"`` picks ``none | scpp | full`` from the activation
  estimate (``choose_remat``);
* packed documents (``packed``, ``mean_doc_len``): ``data_source`` is
  ``PackedLM``, its document lengths drawn around ``mean_doc_len``, and
  ``packing_frac`` is the share of the causal band a packed stream
  attends;
* the microbatch grid, and ``describe()``.

The budget is this rank's share of its device: the device's memory (the
card's, or physical RAM on the CPU) over the number of the world's ranks
on that device; ``memory_budget_gb`` overrides it.  The model is the
reference's, for parity: it charges the compute-dtype copy of the
parameters at ``1/extent``, which the step holds (its shards), beside one
layer gathered at a time; it charges no grads, of which the step holds
the fp32 shards, the whole tied table's while its two uses add to it,
and, with ``grad_accum > 1``, the whole compute-dtype grads the
microbatches sum (as the reference's scan does).  ``offload_chunks``
(the FPDT chunk pipeline) moves only the memory model, as in the
reference: the plan charges the resident chunk fraction of the
activations and reports the wire time and ``max_seq_at_budget``; no
model path calls ``core/attention2d.py::ChunkedAttention``.  Tuned plans
(ROADMAP item 13) raise.
"""
from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core.runtime import Runtime, per_world, world_runtime
from repro_torch.core.topology import (AXIS_DATA, AXIS_POD, MODEL_AXES,
                                       ParallelConfig)
from repro_torch.core.zero import (REPLICATE, ZeroLayout, _group_size,
                                   zero_shardings)
from repro_torch.models.model import remat_policy
from repro_torch.train.optimizer import OptConfig

#: per-parameter state bytes: fp32 master + Adam m + Adam v
STATE_BYTES_PER_PARAM = 12
#: transient bf16 compute copy of the (matrix) params
HALF_BYTES_PER_PARAM = 2
#: device -> host snapshot rate of the checkpoint-stall estimate: a pinned
#: copy of 1 GiB, median of 5, as ``chip_smoke.py`` phase 10 (c) measured
#: it on an NVIDIA H100 80GB HBM3 at a 700.00 W limit
CKPT_D2H_BYTES_PER_S = 55.10e9
#: rough live activation width per token per layer, in units of
#: d_model x 2 bytes: hidden + norms + q/k/v/o + gate/up intermediates
#: when nothing is rematerialized; the saved-residual footprint per layer
#: under full / SC++ checkpointing.
ACT_UNITS = {"none": 14, "scpp": 2, "full": 1}
#: fraction of the device budget the optimizer/param state may occupy:
#: the rest is headroom for activations, grads and workspace.
STATE_BUDGET_FRAC = 0.6
#: serve mode: fraction of the budget for the weights and the paged-KV
#: pool (ROADMAP item 12 reads it).
SERVE_BUDGET_FRAC = 0.8
#: host -> device rate of the chunk-offload traffic model (chunks streamed
#: back to the card): a pinned copy of 1 GiB, median of 5, as
#: ``chip_smoke.py`` phase 10 (c) measured it on an NVIDIA H100 80GB HBM3
#: at a 700.00 W limit
OFFLOAD_WIRE_BYTES_PER_S = 55.21e9


def offload_resident_frac(chunks: int) -> float:
    """Device-resident fraction of a chunk-pipelined tensor: the active
    chunk plus the prefetched next one.  1.0 when not chunked."""
    if chunks <= 1:
        return 1.0
    return min(1.0, 2.0 / chunks)


def offload_split(total_bytes: float, chunks: int) -> tuple[float, float]:
    """``(device_bytes, host_bytes)`` of a chunk-pipelined tensor: a byte
    is counted on exactly one side."""
    dev = total_bytes * offload_resident_frac(chunks)
    return dev, total_bytes - dev


#: AMSP sharding modes, smallest extent first (Full-Replica -> dp-only ->
#: sp-only -> full dp x sp).  ``build_plan`` picks the first that fits.
ZERO_MODES = (
    ("replica", ()),
    ("dp", (AXIS_DATA,)),
    ("sp", MODEL_AXES),
    ("dp_sp", (AXIS_DATA,) + MODEL_AXES),
    ("pod_dp_sp", (AXIS_POD, AXIS_DATA) + MODEL_AXES),
)


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(b) < 1024 or unit == "GB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{int(b)}B"
        b /= 1024
    return f"{b:.1f}GB"


class _ShapeOnlyMesh:
    """The mesh's axis sizes alone (``.shape``), which is all the memory
    model and ``core/zero.py``'s specs read."""

    def __init__(self, pc: ParallelConfig):
        self.shape = {AXIS_POD: pc.pods, AXIS_DATA: pc.dp,
                      MODEL_AXES[0]: pc.hp, MODEL_AXES[1]: pc.cp_outer,
                      MODEL_AXES[2]: pc.cp_inner}


def choose_zero_mode(n_params: int, mesh, budget_bytes: float,
                     *, include_pod: bool = False):
    """AMSP mode selection from the param+optimizer memory model.

    Returns ``(mode_name, group, groups)``: ``groups`` is the preference
    order handed to ``leaf_spec``, the chosen group first, then every
    smaller extent as a fallback for leaves it cannot divide."""
    state = n_params * (STATE_BYTES_PER_PARAM + HALF_BYTES_PER_PARAM)
    modes = [(name, grp) for name, grp in ZERO_MODES
             if include_pod or AXIS_POD not in grp]
    sized = sorted(((name, grp, _group_size(mesh, grp)) for name, grp
                    in modes), key=lambda t: t[2])
    chosen = sized[-1]                 # largest extent if nothing fits
    for name, grp, g in sized:
        if state / max(g, 1) <= budget_bytes * STATE_BUDGET_FRAC:
            chosen = (name, grp, g)
            break
    fallbacks = tuple(grp for _, grp, g in reversed(sized)
                      if g < chosen[2] and grp)
    groups = ((chosen[1],) if chosen[1] else ()) + fallbacks
    return chosen[0], chosen[1], groups


def choose_remat(cfg, budget_bytes: float, state_dev: float,
                 tokens_dev: float) -> str:
    """``none | scpp | full``: the cheapest-recompute policy whose saved
    activations fit the headroom."""
    headroom = budget_bytes - state_dev
    for policy in ("none", "scpp", "full"):
        saved = (tokens_dev * cfg.d_model * 2
                 * ACT_UNITS[policy] * cfg.num_layers)
        if policy != "none":           # + one layer recompute peak
            saved += tokens_dev * cfg.d_model * 2 * ACT_UNITS["none"]
        if saved <= headroom:
            return policy
    return "full"


def plan_memory(cfg, pc: ParallelConfig, *, memory_budget_gb: float,
                grad_accum: int = 1, remat: str | None = None,
                zero: str = "auto", include_pod: bool = False,
                seq_len: int | None = None,
                global_batch: int | None = None, offload_chunks: int = 1):
    """The reference's param+optimizer+activation memory model, per
    device, from the ``ParallelConfig``'s shape alone.  Returns
    ``(remat_policy, zero_mode, groups, mem)``; ``mem`` carries the
    estimates and the verdicts ``fits_state`` / ``fits``.
    ``offload_chunks > 1`` keeps only ``offload_resident_frac`` of the
    activations on the device, for the wire time ``offload_wire_s``;
    ``max_seq_at_budget`` is the longest sequence the headroom admits."""
    pc.validate()
    if grad_accum < 1 or offload_chunks < 1:
        raise ValueError(f"grad_accum {grad_accum} and offload_chunks "
                         f"{offload_chunks} must be >= 1")
    if global_batch is not None and global_batch % grad_accum:
        raise ValueError(f"grad_accum {grad_accum} must divide "
                         f"global_batch {global_batch}")
    shape = _ShapeOnlyMesh(pc)

    budget = memory_budget_gb * 1e9
    n_params = convert.param_count(cfg)

    if zero == "auto":
        zero_mode, group, groups = choose_zero_mode(
            n_params, shape, budget, include_pod=include_pod)
    else:
        by_name = dict(ZERO_MODES)
        if zero not in by_name:
            raise ValueError(f"zero must be 'auto' or one of "
                             f"{sorted(by_name)}, got {zero!r}")
        zero_mode, group = zero, by_name[zero]
        smaller = tuple(g for _, g in ZERO_MODES
                        if g and _group_size(shape, g) <
                        max(_group_size(shape, group), 1))
        groups = ((group,) if group else ()) + tuple(reversed(smaller))
    extent = max(_group_size(shape, group), 1)
    state_dev = n_params * STATE_BYTES_PER_PARAM / extent
    half_dev = n_params * HALF_BYTES_PER_PARAM / extent

    n_batch_dev = pc.pods * pc.dp
    batch_shardable = True
    microbatch = tokens_dev = None
    tokens_per_seq_unit = None
    if global_batch is not None:
        microbatch = global_batch // grad_accum
        batch_shardable = microbatch % n_batch_dev == 0
        div = (n_batch_dev if batch_shardable else 1) * pc.sp
        tokens_per_seq_unit = microbatch / div
        if seq_len is not None:
            tokens_dev = microbatch * seq_len / div

    if remat == "auto":
        policy = choose_remat(cfg, budget, state_dev + half_dev,
                              tokens_dev) if tokens_dev is not None \
            else cfg.remat
    else:
        policy = remat or cfg.remat

    act_total = (tokens_dev or 0) * cfg.d_model * 2 \
        * ACT_UNITS[policy] * cfg.num_layers
    act_dev, act_host = offload_split(act_total, offload_chunks)

    # chunk-pipeline wire time: KV chunk j is re-fetched for every q-chunk
    # i >= j, so a forward (and again a backward) round streams about
    # (C+1)/2 copies of the local K+V; q/out/lse/do staging adds about 4
    # one-shot tensors.
    offload_wire_s = 0.0
    if offload_chunks > 1 and tokens_dev:
        kv_bytes = tokens_dev * cfg.d_model * 2 * 2          # K+V, bf16
        refetch = (offload_chunks + 1) / 2
        wire = (2 * refetch * kv_bytes + 4 * tokens_dev * cfg.d_model * 2) \
            * cfg.num_layers
        offload_wire_s = wire / OFFLOAD_WIRE_BYTES_PER_S

    total_dev = state_dev + half_dev + act_dev
    max_seq_at_budget = None
    if tokens_per_seq_unit:
        per_seq_unit = tokens_per_seq_unit * cfg.d_model * 2 \
            * ACT_UNITS[policy] * cfg.num_layers \
            * offload_resident_frac(offload_chunks)
        headroom = max(budget - state_dev - half_dev, 0.0)
        max_seq_at_budget = int(headroom / max(per_seq_unit, 1e-9))
    # each host serializes only its shards of the masters and moments
    ckpt_host = n_params * STATE_BYTES_PER_PARAM / extent
    mem = {"n_params": n_params, "state_dev": state_dev,
           "half_dev": half_dev, "act_dev": act_dev,
           "act_host": act_host,
           "total_dev": total_dev,
           "offload_chunks": offload_chunks,
           "offload_wire_s": offload_wire_s,
           "max_seq_at_budget": max_seq_at_budget,
           "ckpt_bytes_host": ckpt_host,
           "ckpt_stall_s": ckpt_host / CKPT_D2H_BYTES_PER_S,
           "zero_extent": extent, "microbatch": microbatch,
           "batch_shardable": batch_shardable,
           "fits_state": state_dev + half_dev
           <= budget * STATE_BUDGET_FRAC,
           "fits": (state_dev + half_dev <= budget * STATE_BUDGET_FRAC
                    and total_dev <= budget)}
    return policy, zero_mode, groups, mem


def device_share_bytes(rt: Runtime) -> float:
    """This rank's share of its device's memory: the card's memory, or
    physical RAM on the CPU, over the number of the world's ranks that
    run on that device (counted with an ``all_gather_object`` of (host,
    device), once per world)."""
    dev = rt.device
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        total = torch.cuda.get_device_properties(index).total_memory
        where = (socket.gethostname(), f"cuda:{index}")
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        where = (socket.gethostname(), dev.type)
    if rt.mesh is None:
        return float(total)

    def gather():
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, where)
        return everyone

    return total / per_world(("places", dev.type), gather).count(where)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Consumers read decisions from here: ``plan.cfg`` (remat already
    resolved), ``plan.rt`` (device, attention impl, mesh), ``plan.zero``
    (the ZeRO layout of the port's leaves), ``plan.opt`` and
    ``plan.grad_accum``."""
    cfg: "ModelConfig"               # remat already resolved
    pc: ParallelConfig
    opt: OptConfig
    rt: Runtime
    zero: ZeroLayout
    grad_accum: int = 1
    zero_mode: str = "replica"
    zero_groups: tuple = ()
    memory_budget: float = 0.0       # bytes a rank
    seq_len: int | None = None
    global_batch: int | None = None
    packed: bool = False
    mean_doc_len: int | None = None
    #: FPDT chunk pipeline: the memory model's sequence chunks (1 = fully
    #: resident)
    offload_chunks: int = 1
    mem: dict = dataclasses.field(default_factory=dict)

    def param_shardings(self) -> dict:
        """``{reference path: LeafSpec}`` at the chosen extent."""
        return dict(self.zero.specs)

    def opt_shardings(self, param_sh: dict) -> dict:
        """The moments inherit the parameters' specs (ZeRO-1/2); the step
        count is on every rank."""
        return {"m": param_sh, "v": param_sh, "step": REPLICATE}

    def state_shardings(self) -> dict:
        """The trainer state's specs, ``{"params": ..., "opt": {"m", "v",
        "step"}}`` over the reference's leaves: the parameters and both
        moments follow the ZeRO layout, the step count is replicated.
        Checkpoints are sharded by it on save, and restored through the
        target plan's (``runtime/checkpoint.py``)."""
        params = self.param_shardings()
        return {"params": params, "opt": self.opt_shardings(params)}

    @property
    def packing_frac(self) -> float:
        """The share of the full causal band a packed stream attends (about
        ``mean_doc_len / seq_len``); 1.0 when not packed or the shapes are
        unknown."""
        if not self.packed or not self.seq_len:
            return 1.0
        mean = self.mean_doc_len or self.seq_len
        return min(1.0, max(mean / self.seq_len, 1e-6))

    def data_config(self, seq_len: int, global_batch: int,
                    zigzag: bool | None = None, **kw):
        """The ``DataConfig`` consistent with this plan (cp, zigzag layout,
        microbatch grid).  Packed plans fill ``doc_len_range`` around
        ``mean_doc_len``, clamped to ``seq_len``."""
        from repro_torch.data.pipeline import DataConfig
        if zigzag is None:
            zigzag = self.cfg.zigzag and self.cfg.family in (
                "dense", "moe", "encdec")
        if self.packed and "doc_len_range" not in kw \
                and self.mean_doc_len is not None:
            m = min(self.mean_doc_len, seq_len)
            kw["doc_len_range"] = (max(2, m // 2), min(seq_len, 2 * m))
        return DataConfig(vocab=self.cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch, cp=self.pc.cp,
                          zigzag=zigzag, grad_accum=self.grad_accum, **kw)

    def data_source(self, seq_len: int, global_batch: int, shard=None,
                    **kw):
        """The plan's data source: ``PackedLM`` for packed plans,
        ``SyntheticLM`` otherwise; ``shard`` as ``rank_slices`` gives
        it."""
        from repro_torch.data.pipeline import PackedLM, SyntheticLM
        src = PackedLM if self.packed else SyntheticLM
        return src(self.data_config(seq_len, global_batch, **kw), self.cfg,
                   shard=shard)

    def leaf_extents(self) -> dict:
        """``{top-level key: sorted unique (extent, axes)}``: the ZeRO
        degree applied to each class of the reference's leaves."""
        mesh = _ShapeOnlyMesh(self.pc)
        out: dict[str, set] = {}
        for path, spec in self.zero.specs.items():
            ext = (_group_size(mesh, spec.axes), spec.axes) if spec.axes \
                else (1, ())
            out.setdefault(path[0], set()).add(ext)
        return {k: sorted(v) for k, v in sorted(out.items())}

    def describe(self) -> str:
        cfg, pc, rt, m = self.cfg, self.pc, self.rt, self.mem
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
        lines = where + [
            f"  parallel    dp={pc.dp} hp={pc.hp} cp={pc.cp} "
            f"(outer={pc.cp_outer} inner={pc.cp_inner})",
            f"  batch       global_batch={self.global_batch} "
            f"seq_len={self.seq_len} grad_accum={self.grad_accum} "
            f"microbatch={m.get('microbatch')}",
            f"  attention   impl={rt.impl} zigzag={cfg.zigzag}",
            *([f"  encoder     layers={cfg.encoder_layers} "
               f"frames={cfg.enc_frames} ({cfg.enc_frames // pc.sp} a rank,"
               f" contiguous over (outer, inner, head); non-causal, no "
               f"zigzag)"] if cfg.family == "encdec" else []),
            f"  packing     {'on' if self.packed else 'off'}"
            + (f" mean_doc={self.mean_doc_len} "
               f"frac={self.packing_frac:.3f}" if self.packed else ""),
            f"  precision   compute={cfg.dtype} masters=float32",
            f"  remat       {cfg.remat}",
            f"  zero        mode={self.zero_mode} "
            f"extent={m.get('zero_extent', 1)} "
            f"axes={self.zero_groups[0] if self.zero_groups else ()}",
        ]
        per = " ".join(f"{k}={'/'.join(str(e) for e, _ in v)}"
                       for k, v in self.leaf_extents().items())
        lines.append(f"    leaf extents: {per}")
        lines.append(
            f"  memory/dev  (the reference's model) params+opt="
            f"{_fmt_bytes(m.get('state_dev', 0))} "
            f"compute-copy={_fmt_bytes(m.get('half_dev', 0))} "
            f"acts≈{_fmt_bytes(m.get('act_dev', 0))} "
            f"total≈{_fmt_bytes(m.get('total_dev', 0))} "
            f"/ budget {_fmt_bytes(self.memory_budget)}")
        max_seq, chunks = m.get("max_seq_at_budget"), m["offload_chunks"]
        lines.append(
            f"  offload     chunks={chunks} "
            f"resident={offload_resident_frac(chunks):.2f} "
            f"act_host={_fmt_bytes(m.get('act_host', 0))} "
            f"wire≈{m.get('offload_wire_s', 0) * 1e3:.1f}ms/step "
            f"max_seq@budget≈"
            f"{max_seq if max_seq is not None else 'n/a'}")
        lines.append(
            f"  ckpt        bytes/host="
            f"{_fmt_bytes(m.get('ckpt_bytes_host', 0))} "
            f"(state/{m.get('zero_extent', 1)}) "
            f"snapshot-stall≈{m.get('ckpt_stall_s', 0) * 1e3:.1f}ms")
        lines.append(f"  optimizer   AdamW lr={self.opt.lr} "
                     f"steps={self.opt.total_steps}")
        return "\n".join(lines)


def build_plan(cfg, pc: ParallelConfig | None = None,
               opt: OptConfig | None = None, *, device=None,
               impl: str | None = None, grad_accum: int | None = None,
               remat: str | None = None, zero: str | None = None,
               memory_budget_gb: float | None = None,
               include_pod: bool = False, seq_len: int | None = None,
               global_batch: int | None = None, packed: bool = False,
               mean_doc_len: int | None = None,
               offload_chunks: int | None = None,
               tuned=None) -> ExecutionPlan:
    """Build the plan.  ``remat`` None keeps ``cfg.remat`` and ``"auto"``
    decides from the activation model (with ``seq_len`` and
    ``global_batch``); ``zero`` None or ``"auto"`` picks the AMSP mode
    from the memory model, or names one of ``ZERO_MODES``;
    ``memory_budget_gb`` None is this rank's share of its device
    (``device_share_bytes``); ``impl`` None is ``"auto"`` (the kernels on
    the card, the dense oracle on the CPU); ``device`` None is ``cuda``.
    ``packed`` trains on packed documents (``PackedLM``, block-causal
    masking a document), an attention family only; ``mean_doc_len`` sets
    the data source's length range and ``packing_frac``.
    ``offload_chunks`` (None: 1) enters the memory model only.
    With ``pc.num_devices > 1``, ``torch.distributed`` must be initialised
    with that world size; every rank builds the plan (it creates the ZeRO
    process groups)."""
    pc = pc or ParallelConfig()
    pc.validate()
    if cfg.family == "encdec" and cfg.enc_frames % pc.sp:
        raise ValueError(f"{cfg.enc_frames} encoder frames do not split "
                         f"over d_sp = {pc.sp} ranks")
    if pc.num_devices > 1:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != pc.num_devices:
            raise RuntimeError(
                f"{pc} spans {pc.num_devices} ranks, but torch.distributed "
                + (f"has a world of {world}" if dist.is_initialized()
                   else "is not initialised")
                + ": launch one process a rank (torchrun)")
    if packed and cfg.family not in ("dense", "moe"):
        raise ValueError(f"packed training needs an attention family, got "
                         f"{cfg.family} (SSM state has no per-document "
                         "reset)")
    offload_chunks = 1 if offload_chunks is None else int(offload_chunks)
    if tuned is not None:
        raise NotImplementedError("tuned plans are ROADMAP queue 1, item 13")
    grad_accum = 1 if grad_accum is None else int(grad_accum)
    if grad_accum < 1 or (global_batch is not None
                          and global_batch % grad_accum):
        raise ValueError(f"grad_accum {grad_accum} must divide "
                         f"global_batch {global_batch}")
    if remat not in (None, "auto"):
        remat_policy(remat)
    zero = zero or "auto"
    if zero != "auto" and zero not in dict(ZERO_MODES):
        raise ValueError(f"zero must be 'auto' or one of "
                         f"{[name for name, _ in ZERO_MODES]}, got {zero!r}")
    if pc.num_devices > 1:
        rt = world_runtime(pc, impl=impl or "auto", device=device)
    else:
        rt = Runtime(pc=pc, impl=impl or "auto", device=device)
    budget = (memory_budget_gb * 1e9 if memory_budget_gb is not None
              else device_share_bytes(rt))
    policy, zero_mode, groups, mem = plan_memory(
        cfg, pc, memory_budget_gb=budget / 1e9, grad_accum=grad_accum,
        remat=remat, zero=zero, include_pod=include_pod, seq_len=seq_len,
        global_batch=global_batch, offload_chunks=offload_chunks)
    policy = remat_policy(policy)
    if policy != cfg.remat:
        cfg = dataclasses.replace(cfg, remat=policy)
    mesh = _ShapeOnlyMesh(pc)
    specs = zero_shardings(convert.ref_param_shapes(cfg), mesh, groups)
    return ExecutionPlan(cfg=cfg, pc=pc, opt=opt or OptConfig(), rt=rt,
                         zero=ZeroLayout(cfg, specs, mesh, rt),
                         grad_accum=grad_accum, zero_mode=zero_mode,
                         zero_groups=groups, memory_budget=budget,
                         seq_len=seq_len, global_batch=global_batch,
                         packed=packed, mean_doc_len=mean_doc_len,
                         offload_chunks=offload_chunks, mem=mem)
