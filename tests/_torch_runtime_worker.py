"""The rank program of ``tests/test_torch_runtime_mesh.py``: four gloo
ranks on the CPU, each running every case and writing its results to
``<out>/rank<r>.pt``.  Imports torch and ``repro_torch`` only (no JAX):
the test process holds the results against one process and the JAX
package.

* ``elastic_case``: an uninterrupted run under plan B (``dp=4``, ZeRO
  ``"dp"`` at extent 4); plan A (``dp=2``, ``inner=2``, extent 2) saving
  at step ``K``; plan B restoring there and continuing.  The files each
  rank wrote are recorded.
* ``chunk_case``: the chunk pipeline against the resident 2D-Attention
  on (hp, outer, inner) = (1, 2, 2) and (2, 1, 2), with and without a
  doc table across the chunk edges.
* ``preempt_case``: SIGTERM raised in rank 2 alone during step 1 of a
  run under plan A.
* ``crash_case``: rank 2's shard write fails during an async save.
* ``moe_case``: expert parallelism.  ``moe_apply`` on (dp, hp, outer,
  inner) = (1, 2, 1, 2), EP = 4, each rank on its sequence shard, at
  capacity factor 8.0 (no drops) and 0.5 (drops), with its grads summed
  over the ranks; and reduced qwen3-moe-30b-a3b's step grads under
  ``dp_sp`` on (2, 1, 1, 2), zigzag batches sharded by the plan, with
  the aux weight the config's and 0.
* ``ssm_case``: the context-parallel scan on (dp, hp, outer, inner) =
  (1, 2, 1, 2), four sequence ranks with ``head`` among them:
  ``gather_stack``'s grads; ``mamba1_apply`` and ``mamba2_apply`` on each
  rank's piece (y, the prefill state, the grads of x and of the leaves
  summed over the ranks); and reduced zamba2-7b's step grads under
  ``dp_sp`` on the same grid, contiguous batches sharded by the plan.
* ``encdec_case``: reduced whisper-small's step grads under ``dp_sp`` on
  (1, 2, 1, 2) under each remat mode: zigzag tokens and contiguous
  frames sharded by the plan, the encoder's non-causal ring, the cross
  K/V gathered over the four sequence ranks.
* ``mla_case``: reduced deepseek-v2-lite-16b's step grads under ``dp_sp``
  on (1, 2, 1, 2) under each remat mode (the aux weight 0): MLA's heads
  over Ulysses on head, the zigzag ring over inner, the experts over
  head and inner (EP = 4).
* ``decode_case`` (``tests/test_torch_serve_mesh.py``, a spawn of its
  own): prefill over the contiguous ring, ``grow_caches`` and one decode
  step on each ``DECODE_CASES`` grid, the logits and this rank's cache
  shards after the growth.
* ``launch_case`` (the same spawn): ``repro_torch.launch.serve.main``
  with ``LAUNCH_ARGV`` and ``--hp 2``, the fixed engine on the mesh the
  world size gives, (1, 2, 1, 2); the tokens it returns.

``main`` runs the cases it is given (default: all but ``decode_case``).
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import signal

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
S, GB, N, K = 64, 8, 6, 3
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=N)
BUDGET_GB = 80.0
#: (dp, hp, outer, inner) of plans A and B.
PLAN_A, PLAN_B = (2, 1, 1, 2), (4, 1, 1, 1)
#: The chunk pipeline's grids (hp, outer, inner) and shapes.
CHUNK_GRIDS = ((1, 2, 2), (2, 1, 2))
CB, CS, CH, CHKV, CD, CC = 1, 128, 4, 1, 16, 4
#: Document starts whose boundaries fall inside chunks (chunk length 32).
CDOC = np.repeat([0, 21, 50, 83, 100], [21, 29, 33, 17, 28])[None].astype(
    np.int32)
PREEMPT_RANK = 2
#: The MoE cases: ``moe_apply``'s grid, dims and shape; the step's grid,
#: sequence, batch and parameter seed.
MOE_GRID, MOE_STEP_GRID = (1, 2, 1, 2), (2, 1, 1, 2)
MOE_DIMS = dict(d_model=64, n_experts=8, top_k=2, d_ff=64, n_shared=1)
MB, MS = 2, 64
MOE_CFS = (8.0, 0.5)
#: The aux's weight in the loss of the drop case: large enough that the
#: aux's own grads show beside those of sum(y * w).
MOE_AUX_SCALE = 1e3
MOE_S, MOE_GB, MOE_SEED = 64, 2, 5
#: The config's aux weight, and none (the aux is a mean over ranks of
#: per-rank terms, which one device's aux is not).
MOE_AUX_WEIGHTS = (1e-3, 0.0)


#: The SSM cases: the grid, the layers' dims, their shape and seeds, and the
#: zamba2 step's sequence, batch and parameter seed.
SSM_GRID = (1, 2, 1, 2)
SSM_DIMS = {"mamba1": dict(d_model=32, d_inner=64, d_state=8, seg=8),
            "mamba2": dict(d_model=32, d_inner=64, d_state=8, head_dim=8,
                           seg=8)}
SB, SS = 2, 64
SSM_S, SSM_GB, SSM_SEED = 64, 2, 9
#: The whisper step's grid, sequence, batch and parameter seed.
ENCDEC_GRID = (1, 2, 1, 2)
ENC_S, ENC_GB, ENC_SEED = 64, 2, 13
#: The MLA step's grid, sequence, batch and parameter seed.
MLA_GRID = (1, 2, 1, 2)
MLA_S, MLA_GB, MLA_SEED = 64, 2, 17


def pc_of(grid):
    from repro_torch.core.topology import ParallelConfig
    dp, hp, no, wi = grid
    return ParallelConfig(dp=dp, hp=hp, cp_outer=no, cp_inner=wi)


def trainer(grid, ckpt_dir=None, steps=N, every=10**6, log_every=1000):
    from repro_torch.configs import get_reduced
    from repro_torch.core.plan import build_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    plan = build_plan(get_reduced("qwen3-1.7b"), pc_of(grid),
                      OptConfig(**OPT), device="cpu", impl="plain",
                      zero="dp", seq_len=S, global_batch=GB,
                      memory_budget_gb=BUDGET_GB)
    return Trainer(plan, plan.data_config(S, GB),
                   TrainerConfig(num_steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=every, log_every=log_every))


class _Recorder:
    """Every ``np.save`` path of this process while it is active."""

    def __init__(self):
        self.paths, self._save = [], np.save

    def __enter__(self):
        def save(path, arr, **kw):
            self.paths.append(str(path))
            return self._save(path, arr, **kw)
        np.save = save
        return self

    def __exit__(self, *exc):
        np.save = self._save


def elastic_case(out: str) -> dict:
    d = os.path.join(out, "elastic")
    base = trainer(PLAN_B).run()
    with _Recorder() as rec:
        t_a = trainer(PLAN_A, d, steps=K, every=K)
        part1 = t_a.run()
    t_b = trainer(PLAN_B, d)
    part2 = t_b.run()
    return {"base": base, "part1": part1, "part2": part2,
            "start": t_b.start_step,
            "extents": (t_a.plan.mem["zero_extent"],
                        t_b.plan.mem["zero_extent"]),
            "written": [os.path.basename(p) for p in rec.paths],
            "manifest": t_b.ckpter.manifest(K), "dir": d}


def chunk_case(rank: int) -> dict:
    from repro_torch.core.attention2d import (attention_2d, attn2d_config,
                                              chunked_attention_2d,
                                              to_chunk_layout)
    from repro_torch.core.runtime import world_runtime
    from repro_torch.core.topology import seq_slice
    from repro_torch.core.zigzag import to_zigzag
    from repro_torch.runtime.offload import OffloadManager
    rng = np.random.default_rng(11)
    q, w = (torch.from_numpy(rng.standard_normal((CB, CS, CH, CD))
                             .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((CB, CS, CHKV, CD))
                             .astype(np.float32)) for _ in range(2))
    out = {}
    for grid in CHUNK_GRIDS:
        pc = pc_of((1,) + grid)
        rt = world_runtime(pc, impl="plain", device="cpu")
        cfg = attn2d_config(pc, impl="plain")
        for docs in (False, True):
            doc = torch.from_numpy(CDOC) if docs else None
            piece = lambda x: to_zigzag(x, pc.cp)[                # noqa: E731
                :, seq_slice(pc, rt.coord, CS)].contiguous()
            tq, tk, tv = (piece(x).requires_grad_() for x in (q, k, v))
            res = attention_2d(tq, tk, tv, cfg=cfg, rt=rt,
                               doc_start=None if doc is None else piece(doc))
            (res * piece(w)).sum().backward()
            lay = lambda x: to_chunk_layout(x, CC, pc, rt.coord)  # noqa: E731
            mgr = OffloadManager()
            o, vjp = chunked_attention_2d(
                lay(q), lay(k), lay(v), cfg=cfg, chunks=CC, rt=rt,
                doc_start=None if doc is None else lay(doc), offload=mgr)
            grads = vjp(lay(w))
            out[grid, docs] = {
                "coord": rt.coord,
                "resident": [res.detach(), tq.grad, tk.grad, tv.grad],
                "chunked": [o, *grads], "stats": mgr.stats()}
    return out


def preempt_case(out: str, rank: int) -> dict:
    from repro_torch.runtime import checkpoint as ckpt
    d = os.path.join(out, "preempt")
    tr = trainer(PLAN_A, d, log_every=1)
    step_fn, calls = tr.step_fn, []

    def signalled(*a):
        calls.append(1)
        if rank == PREEMPT_RANK and len(calls) == 2:
            signal.raise_signal(signal.SIGTERM)
        return step_fn(*a)

    tr.step_fn = signalled
    losses = tr.run()
    dist.barrier()
    return {"losses": losses, "steps": ckpt.list_steps(d),
            "requested": tr.guard.requested}


def crash_case(out: str, rank: int) -> dict:
    """Rank 2's first shard file fails during an async save under plan A
    (ranks 0 and 2 write; 1 and 3 hold the other copy of each shard):
    every rank's ``flush`` raises, and no step is left visible."""
    from repro_torch.runtime import checkpoint as ckpt
    d = os.path.join(out, "crash")
    tr = trainer(PLAN_A, d, steps=1)
    real = np.save

    def boom(path, arr, **kw):
        raise OSError("disk gone")

    if rank == 2:
        np.save = boom
    try:
        tr.ckpter.save_async({"params": tr.params, "opt": tr.opt_state}, 1)
        try:
            tr.ckpter.flush()
            err = None
        except (OSError, RuntimeError) as e:
            err = type(e).__name__
    finally:
        np.save = real
    dist.barrier()
    return {"error": err, "steps": ckpt.list_steps(d),
            "dirs": sorted(n for n in os.listdir(d)
                           if os.path.isdir(os.path.join(d, n)))}


def moe_inputs():
    """``(params, x, w)``: the MoE leaves in the port's layout (the shared
    GLU's linear weights ``(d_out, d_in)``), x ``(MB, MS, d)`` and the
    cotangent weights, drawn with numpy."""
    rng = np.random.default_rng(21)
    d, e, f = MOE_DIMS["d_model"], MOE_DIMS["n_experts"], MOE_DIMS["d_ff"]

    def draw(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    p = {"router": draw((d, e), d ** -0.5), "w1": draw((e, d, f), d ** -0.5),
         "w3": draw((e, d, f), d ** -0.5), "w2": draw((e, f, d), f ** -0.5),
         "shared": {"w1": {"w": draw((f, d), d ** -0.5)},
                    "w3": {"w": draw((f, d), d ** -0.5)},
                    "w2": {"w": draw((d, f), f ** -0.5)}}}
    return p, draw((MB, MS, d), 1.0), draw((MB, MS, d), 1.0)


def moe_step_cfg(aux_weight: float):
    from repro_torch.configs import get_reduced
    cfg = get_reduced("qwen3-moe-30b-a3b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, aux_weight=aux_weight))


def moe_case() -> dict:
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
    from repro_torch.core.plan import build_plan
    from repro_torch.core.runtime import (all_reduce_, sum_over_world,
                                          world_runtime)
    from repro_torch.core.topology import seq_slice
    from repro_torch.core.zero import gather_params, shard_params
    from repro_torch.data.pipeline import SyntheticLM, rank_slices
    from repro_torch.models.model import init_params
    from repro_torch.models import moe
    from repro_torch.train.train_step import make_grad_fn
    pc = pc_of(MOE_GRID)
    rt = world_runtime(pc, impl="plain", device="cpu")
    p, x, w = moe_inputs()
    sl = seq_slice(pc, rt.coord, MS)
    out = {"apply": {}, "slice": (sl.start, sl.stop), "step": {}}
    for cf in MOE_CFS:
        tp = tree_map(lambda a: torch.from_numpy(a).requires_grad_(), p)
        moe.DROPS = []
        try:
            y, aux = moe.moe_apply(tp, torch.from_numpy(x[:, sl]), rt,
                                   moe.MoEDims(capacity_factor=cf,
                                               **MOE_DIMS))
            dropped = int(moe.DROPS[0][0])
        finally:
            moe.DROPS = None
        loss = sum_over_world((y * torch.from_numpy(w[:, sl])).sum(), rt)
        if cf < 1:                   # the per-shard decomposition's aux
            loss = loss + MOE_AUX_SCALE * aux
        loss.backward()
        grads = [all_reduce_(g.grad, rt) for g in tree_flatten(tp)[0]]
        out["apply"][cf] = {"y": y.detach(), "aux": float(aux),
                            "dropped": dropped,
                            "grads": tree_unflatten(grads,
                                                    tree_flatten(tp)[1])}
    for aux_weight in MOE_AUX_WEIGHTS:
        cfg = moe_step_cfg(aux_weight)
        plan = build_plan(cfg, pc_of(MOE_STEP_GRID), device="cpu",
                          impl="plain", zero="dp_sp", seq_len=MOE_S,
                          global_batch=MOE_GB, memory_budget_gb=BUDGET_GB)
        dcfg = plan.data_config(MOE_S, MOE_GB)
        batch = SyntheticLM(dcfg, cfg, shard=rank_slices(
            dcfg, plan.pc, plan.rt.coord)).batch(0)
        params = shard_params(init_params(
            cfg, torch.Generator().manual_seed(MOE_SEED)), plan)
        metrics, grads = make_grad_fn(plan)(
            params, {k: torch.as_tensor(v) for k, v in batch.items()})
        full = gather_params(tree_unflatten(grads, tree_flatten(params)[1]),
                             plan)
        out["step"][aux_weight] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": tree_flatten(full)[0], "zigzag": dcfg.zigzag,
            "extent": plan.mem["zero_extent"]}
    return out


def ssm_inputs(kind: str):
    """``(params, x, w)`` of one mixer, numpy, the port's layout (linear
    weights ``(d_out, d_in)``): ``A_log``, ``D``, ``dt_bias`` and the
    norm off their init."""
    from repro_torch.models import ssm
    rng = np.random.default_rng(31)
    m = (ssm.Mamba1Dims if kind == "mamba1" else ssm.Mamba2Dims)(
        **SSM_DIMS[kind])
    init = ssm.init_mamba1 if kind == "mamba1" else ssm.init_mamba2
    shapes = init(torch.Generator(), m, device="meta")

    def draw(key, shape):
        if key == "w" and len(shape) == 2:
            x = shape[-1] ** -0.5 * rng.standard_normal(shape)
        elif key == "A_log":
            x = np.log(rng.uniform(1.0, 8.0, shape))
        elif key == "D":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            x = 0.1 * rng.standard_normal(shape)
        return x.astype(np.float32)

    p = {k: ({n: draw(n, tuple(t.shape)) for n, t in v.items()}
             if isinstance(v, dict) else draw(k, tuple(v.shape)))
         for k, v in shapes.items()}
    x = rng.standard_normal((SB, SS, m.d_model)).astype(np.float32)
    return m, p, x, rng.standard_normal(x.shape).astype(np.float32)


def ssm_case() -> dict:
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
    from repro_torch.configs import get_reduced
    from repro_torch.core.plan import build_plan
    from repro_torch.core.runtime import (all_reduce_, axes_groups,
                                          gather_stack, sum_over_world,
                                          world_runtime)
    from repro_torch.core.topology import SEQ_AXES, seq_slice
    from repro_torch.core.zero import gather_params, shard_params
    from repro_torch.data.pipeline import SyntheticLM, rank_slices
    from repro_torch.models import ssm
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import make_grad_fn
    pc = pc_of(SSM_GRID)
    rt = world_runtime(pc, impl="plain", device="cpu")
    ag = axes_groups(rt, [SEQ_AXES])[SEQ_AXES]
    # gather_stack: rank r's x_r = r + 1; the loss sums w_r * gathered on
    # every rank, so x_r's grad is the sum over the ranks of w_r'[r]
    xg = torch.full((3,), float(ag.index + 1), requires_grad=True)
    wg = torch.arange(ag.size * 3, dtype=torch.float32).reshape(
        ag.size, 3) * (ag.index + 1)
    stacked = gather_stack(xg, ag, rt)
    sum_over_world((stacked * wg).sum(), rt).backward()
    out = {"gather": {"index": ag.index, "stacked": stacked.detach(),
                      "grad": xg.grad}, "layers": {}}
    sl = seq_slice(pc, rt.coord, SS)
    out["slice"] = (sl.start, sl.stop)
    for kind, apply in (("mamba1", ssm.mamba1_apply),
                        ("mamba2", ssm.mamba2_apply)):
        m, p, x, w = ssm_inputs(kind)
        tp = tree_map(lambda a: torch.from_numpy(a).requires_grad_(), p)
        tx = torch.from_numpy(x[:, sl].copy()).requires_grad_()
        y, st = apply(tp, tx, rt, m, return_state=True)
        sum_over_world((y * torch.from_numpy(w[:, sl])).sum(), rt).backward()
        grads = [all_reduce_(g.grad, rt) for g in tree_flatten(tp)[0]]
        out["layers"][kind] = {
            "y": y.detach(), "dx": tx.grad, "state": {
                k: v.detach() for k, v in st.items()},
            "grads": tree_unflatten(grads, tree_flatten(tp)[1])}
    cfg = get_reduced("zamba2-7b")
    plan = build_plan(cfg, pc, device="cpu", impl="plain", zero="dp_sp",
                      seq_len=SSM_S, global_batch=SSM_GB,
                      memory_budget_gb=BUDGET_GB)
    dcfg = plan.data_config(SSM_S, SSM_GB)
    batch = SyntheticLM(dcfg, cfg, shard=rank_slices(
        dcfg, plan.pc, plan.rt.coord)).batch(0)
    params = shard_params(init_params(
        cfg, torch.Generator().manual_seed(SSM_SEED)), plan)
    metrics, grads = make_grad_fn(plan)(
        params, {k: torch.as_tensor(v) for k, v in batch.items()})
    full = gather_params(tree_unflatten(grads, tree_flatten(params)[1]),
                         plan)
    out["step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "grads": tree_flatten(full)[0], "zigzag": dcfg.zigzag,
                   "extent": plan.mem["zero_extent"]}
    return out


def encdec_case() -> dict:
    from torch.utils._pytree import tree_flatten, tree_unflatten
    from repro_torch.configs import get_reduced
    from repro_torch.core.plan import build_plan
    from repro_torch.core.zero import gather_params, shard_params
    from repro_torch.data.pipeline import SyntheticLM, rank_slices
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import make_grad_fn
    out = {}
    for remat in ("none", "full", "scpp"):
        plan = build_plan(get_reduced("whisper-small"), pc_of(ENCDEC_GRID),
                          device="cpu", impl="plain", zero="dp_sp",
                          remat=remat, seq_len=ENC_S, global_batch=ENC_GB,
                          memory_budget_gb=BUDGET_GB)
        dcfg = plan.data_config(ENC_S, ENC_GB)
        batch = SyntheticLM(dcfg, plan.cfg, shard=rank_slices(
            dcfg, plan.pc, plan.rt.coord)).batch(0)
        params = shard_params(init_params(
            plan.cfg, torch.Generator().manual_seed(ENC_SEED)), plan)
        metrics, grads = make_grad_fn(plan)(
            params, {k: torch.as_tensor(v) for k, v in batch.items()})
        full = gather_params(tree_unflatten(grads, tree_flatten(params)[1]),
                             plan)
        out[remat] = {"loss": float(metrics["loss"]),
                      "grads": tree_flatten(full)[0],
                      "frames": batch["frames"].shape}
    out["zigzag"], out["extent"] = dcfg.zigzag, plan.mem["zero_extent"]
    return out


def mla_cfg():
    """Reduced deepseek-v2-lite-16b without the aux in the loss (on a mesh
    the aux is a mean over ranks of per-rank terms, which one device's
    aux is not)."""
    from repro_torch.configs import get_reduced
    cfg = get_reduced("deepseek-v2-lite-16b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, aux_weight=0.0))


def mla_case() -> dict:
    from torch.utils._pytree import tree_flatten, tree_unflatten
    from repro_torch.core.plan import build_plan
    from repro_torch.core.zero import gather_params, shard_params
    from repro_torch.data.pipeline import SyntheticLM, rank_slices
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import make_grad_fn
    out = {}
    for remat in ("none", "full", "scpp"):
        plan = build_plan(mla_cfg(), pc_of(MLA_GRID), device="cpu",
                          impl="plain", zero="dp_sp", remat=remat,
                          seq_len=MLA_S, global_batch=MLA_GB,
                          memory_budget_gb=BUDGET_GB)
        dcfg = plan.data_config(MLA_S, MLA_GB)
        batch = SyntheticLM(dcfg, plan.cfg, shard=rank_slices(
            dcfg, plan.pc, plan.rt.coord)).batch(0)
        params = shard_params(init_params(
            plan.cfg, torch.Generator().manual_seed(MLA_SEED)), plan)
        metrics, grads = make_grad_fn(plan)(
            params, {k: torch.as_tensor(v) for k, v in batch.items()})
        full = gather_params(tree_unflatten(grads, tree_flatten(params)[1]),
                             plan)
        out[remat] = {"loss": float(metrics["loss"]),
                      "grads": tree_flatten(full)[0]}
    out["zigzag"], out["extent"] = dcfg.zigzag, plan.mem["zero_extent"]
    return out


#: The decode grids (dp, hp, outer, inner) of the reference's
#: ``tests/_dist_checks.py::check_decode_consistency``, its batch, prompt,
#: growth and the parameter seed.
DECODE_CASES = (("qwen3-1.7b", (1, 2, 2, 1)), ("gemma2-2b", (1, 2, 1, 2)),
                ("deepseek-v2-lite-16b", (1, 4, 1, 1)),
                ("falcon-mamba-7b", (1, 1, 2, 2)))
DEC_B, DEC_S, DEC_GROW, DEC_SEED = 2, 32, 4, 21


def decode_tokens(vocab: int):
    return np.random.default_rng(DEC_SEED).integers(0, vocab, (DEC_B, DEC_S))


def decode_case() -> dict:
    from repro_torch import convert
    from repro_torch.configs import get_reduced
    from repro_torch.core.plan import build_plan
    from repro_torch.models.decode import decode_step, grow_caches, prefill
    from repro_torch.models.model import init_params
    out = {}
    for name, grid in DECODE_CASES:
        cfg = get_reduced(name)
        plan = build_plan(cfg, pc_of(grid), device="cpu", impl="plain",
                          memory_budget_gb=BUDGET_GB)
        params = init_params(cfg, torch.Generator().manual_seed(DEC_SEED))
        tokens = torch.as_tensor(decode_tokens(cfg.vocab))
        with torch.inference_mode():
            lg, caches = prefill(params, {"tokens": tokens}, plan.rt, cfg)
            caches = grow_caches(cfg, caches, DEC_GROW, plan.rt)
            # a copy: decode_step writes into the caches in place
            grown = copy.deepcopy(convert.caches_to_numpy(caches))
            nxt = lg[:, -1].argmax(-1)[:, None]
            lg2, _ = decode_step(params, caches, nxt, DEC_S, plan.rt, cfg)
        out[name] = {"coord": tuple(plan.rt.coord), "prefill": lg.numpy(),
                     "decode": lg2.numpy(), "next": nxt.numpy(),
                     "caches": grown}
    return out


#: The serve launcher's arguments: the fixed engine on reduced qwen3-1.7b
#: on the CPU, one batch of two prompts (``launch_case`` adds ``--hp 2``).
LAUNCH_ARGV = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--engine", "fixed", "--prompt-len", "32", "--gen", "6",
               "--batch", "2"]


def launch_case() -> np.ndarray:
    from repro_torch.launch import serve
    return serve.main(LAUNCH_ARGV + ["--hp", "2"]).numpy()


#: Every case ``main`` runs when it is given none.
CASES = ("elastic", "chunk", "preempt", "crash", "moe", "ssm", "encdec",
         "mla")


def main(rank: int, world: int, out: str, cases=CASES):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    runs = {"elastic": lambda: elastic_case(out),
            "chunk": lambda: chunk_case(rank),
            "preempt": lambda: preempt_case(out, rank),
            "crash": lambda: crash_case(out, rank), "moe": moe_case,
            "ssm": ssm_case, "encdec": encdec_case, "mla": mla_case,
            "decode": decode_case, "launch": launch_case}
    try:
        res = {case: runs[case]() for case in cases}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
