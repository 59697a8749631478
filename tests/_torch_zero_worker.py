"""The rank program of ``tests/test_torch_zero.py``: four gloo ranks on
the CPU, each running every case and writing its results to
``<out>/rank<r>.pt``.  Imports torch and ``repro_torch`` only (no JAX):
the test process holds the results against the JAX package.

* ``shard_case``: ``shard_params`` / ``gather_params`` of a full tree,
  and the grad reduction and norm, under a ZeRO mode on each grid;
* ``trainer_case``: the initial shards, then three steps of ``Trainer``
  under hybrid ZeRO from the initial params the JAX trainer starts from;
* ``accum_case``: the ZeRO collectives of one step at ``grad_accum`` 1
  and 4;
* ``compress_case``: ``compressed_psum`` over the world for 20 steps.
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4

#: name -> (dp, hp, outer, inner, placement).
GRIDS = {"1x2x1x2-head_first": (1, 2, 1, 2, "head_first"),
         "1x2x1x2-context_first": (1, 2, 1, 2, "context_first"),
         "2x1x1x2": (2, 1, 1, 2, "head_first"),
         "2x2x1x1": (2, 2, 1, 1, "head_first")}
#: (grid, ZeRO mode, layers) of the shard case: dp_sp head-first, "sp"
#: context-first (the model axes alone), and dp_sp at depth 4 on
#: (2, 1, 1, 2), where ln1 / ln2 shard over the group axis.  The trainer
#: runs add their initial shards under dp_sp and "dp".
SHARD_RUNS = [("1x2x1x2-head_first", "dp_sp", 2),
              ("1x2x1x2-context_first", "sp", 2), ("2x1x1x2", "dp_sp", 4)]
#: (grid, ZeRO mode) of the trainer case: dp_sp shards every large leaf
#: 4 ways; "dp" on (2, 2, 1, 1) shards 2 ways over data, so the
#: complement all-reduce over head makes the grads whole.
TRAIN_RUNS = [("2x1x1x2", "dp_sp"), ("2x2x1x1", "dp")]
TRAIN = dict(seq=64, gb=4, steps=3, accum=2,
             opt=dict(lr=1e-2, warmup_steps=1, total_steps=3))
#: An explicit budget, so every plan's extent is the mode asked for.
BUDGET_GB = 80.0
COMPRESS = dict(steps=20, width=64)


def layout_cfg(cfg, layers: int):
    """Reduced qwen3-1.7b reshaped so each rule of the layout shows: the
    ``(514, 1026)`` embedding falls back to a 2-way sub-group on a 4-way
    mode, the linear weights shard along a dim, and at 4 layers ln1 / ln2
    ``(4, 1026)`` (4,104 elements, over ``min_elems``, and 1026 not a
    multiple of 4) shard over the group axis (a layer a shard).  Narrow
    heads and MLP keep the tree small."""
    return dataclasses.replace(cfg, num_layers=layers, d_model=1026,
                               vocab=514, head_dim=16, d_ff=64)


def pc_of(name):
    from repro_torch.core.topology import ParallelConfig
    dp, hp, no, wi, placement = GRIDS[name]
    return ParallelConfig(dp=dp, hp=hp, cp_outer=no, cp_inner=wi,
                          placement=placement)


def compress_grads(step: int) -> np.ndarray:
    """Every rank's gradient of ``step``: row ``r`` is rank ``r``'s."""
    rng = np.random.default_rng(step)
    return rng.standard_normal((WORLD, COMPRESS["width"])).astype(
        np.float32)


def shard_case(out_dir, cfg, rank: int):
    """Per run: the plan's specs, this rank's shards of the full tree,
    whether ``gather_params`` gives it back bit for bit, and whether
    ``reduce`` of the grads ``g * (rank + 1)``, ``g`` the signs of the
    params, gives this rank's shard of ``10 g`` (the sum over four ranks)
    exactly, with ``grad_norm`` over those shards against the norm of
    ``10 g``, ``10 sqrt(n)`` for a tree of ``n`` elements.  Every square
    is 100 and each leaf has under 2**24 / 25 elements, so each sum of
    squares is exact in fp32, and counting a leaf twice or not at all
    shows."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.core.plan import build_plan
    from repro_torch.core.zero import gather_params, shard_params
    out = {}
    for grid, mode, layers in SHARD_RUNS:
        full = torch.load(os.path.join(out_dir, f"layout{layers}.pt"))
        plan = build_plan(layout_cfg(cfg, layers), pc_of(grid),
                          device="cpu", zero=mode,
                          memory_budget_gb=BUDGET_GB)
        shards = shard_params(full, plan)
        back = gather_params(shards, plan)
        leaves = tree_flatten(full)[0]
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_flatten(back)[0], leaves))
        layout, g = plan.zero, [x.sign() for x in leaves]
        reduced = [layout.reduce(i, y * (rank + 1)) for i, y in
                   enumerate(g)]
        summed = all(torch.equal(a, layout.shard(i, y * 10)) for i, (a, y)
                     in enumerate(zip(reduced, g)))
        norm = 10 * math.sqrt(sum(x.numel() for x in leaves))
        out[grid, mode, layers] = {
            "specs": plan.param_shardings(),
            "shards": tree_flatten(shards)[0], "gathered_equal": same,
            "reduced_equal": summed,
            "norm": (float(layout.grad_norm(reduced)), norm)}
    return out


def _trainer(cfg, grid, mode, init, accum=None, gb=None):
    from repro_torch.core.plan import build_plan
    from repro_torch.core.zero import shard_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t = TRAIN
    accum, gb = accum or t["accum"], gb or t["gb"]
    plan = build_plan(cfg, pc_of(grid), OptConfig(**t["opt"]), device="cpu",
                      grad_accum=accum, zero=mode,
                      memory_budget_gb=BUDGET_GB, seq_len=t["seq"],
                      global_batch=gb)
    tr = Trainer(plan, plan.data_config(t["seq"], gb),
                 TrainerConfig(num_steps=t["steps"], log_every=1))
    tr.params = shard_params(copy.deepcopy(init), plan)
    tr.opt_state = init_opt_state(tr.params)
    return plan, tr


def trainer_case(cfg, init):
    """Per run: the initial shards and specs, then three steps: losses,
    grad norms, what each rank holds, and the gathered params."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.core.zero import gather_params
    out = {}
    for grid, mode in TRAIN_RUNS:
        plan, tr = _trainer(cfg, grid, mode, init)
        shards = [x.clone() for x in tree_flatten(tr.params)[0]]
        step_fn, gnorms = tr.step_fn, []

        def recorded(params, opt_state, batch, step_fn=step_fn):
            res = step_fn(params, opt_state, batch)
            gnorms.append(float(res[2]["grad_norm"]))
            return res

        tr.step_fn = recorded
        losses = tr.run()
        numel = [[x.numel() for x in tree_flatten(tree)[0]]
                 for tree in (tr.params, tr.opt_state["m"],
                              tr.opt_state["v"])]
        out[grid, mode] = {
            "shards": shards, "specs": plan.param_shardings(),
            "losses": losses, "gnorms": gnorms, "numel": numel,
            "extent": [plan.zero.extent(i) for i in range(len(numel[0]))],
            "params": tree_flatten(gather_params(tr.params, plan))[0],
            "describe": plan.describe()}
    return out


def accum_case(cfg, init):
    """Calls of the ZeRO collectives in one step, at grad_accum 1 and 4
    (global batch 8)."""
    from repro_torch.core import zero
    counts = {}
    real = {"reduce_scatter_": zero.reduce_scatter_,
            "gather_shards": zero.gather_shards}
    try:
        for name, fn in real.items():
            def counted(*a, _name=name, _fn=fn, **kw):
                counts[_name] = counts.get(_name, 0) + 1
                return _fn(*a, **kw)
            setattr(zero, name, counted)
        out = {}
        for accum in (1, 4):
            _, tr = _trainer(cfg, "2x1x1x2", "dp_sp", init, accum=accum,
                             gb=8)
            batch = tr._to_device(tr.data.batch(0))
            counts.clear()
            tr.step_fn(tr.params, tr.opt_state, batch)
            out[accum] = dict(counts)
    finally:
        for name, fn in real.items():
            setattr(zero, name, fn)
    return out


def compress_case(rank: int):
    from repro_torch.core.runtime import world_runtime
    from repro_torch.core.topology import ParallelConfig
    from repro_torch.train.optimizer import compressed_psum
    rt = world_runtime(ParallelConfig(dp=WORLD), device="cpu")
    err = torch.zeros(COMPRESS["width"])
    sums = []
    for step in range(COMPRESS["steps"]):
        g = torch.from_numpy(compress_grads(step)[rank])
        s, err = compressed_psum(g, err, rt.group("data"), rt)
        sums.append(s)
    return torch.stack(sums)


def main(rank: int, world: int, out: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.configs import get_reduced
        cfg = get_reduced("qwen3-1.7b")
        init = torch.load(os.path.join(out, "init.pt"))
        res = {"shard": shard_case(out, cfg, rank),
               "trainer": trainer_case(cfg, init),
               "accum": accum_case(cfg, init),
               "compress": compress_case(rank)}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
