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
* ``gather_case``: the per-layer step's gathers at use: how many layers'
  gathered leaves are alive at once under each remat, the dtype and count
  of the grad reductions of a bf16 step at ``grad_accum`` 1 and 4, and
  fp32 loss and grads under ``dp_sp`` against ``replica``;
* ``packed_case``: a packed batch's loss and grads on the reference's
  three packed grids;
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
#: The per-layer step's cases: dp_sp on this grid at this depth, the
#: trainer's shapes.
GATHER_GRID, GATHER_LAYERS = "2x1x1x2", 4
#: The reference's packed grids (``tests/_dist_checks.py::
#: check_packed_parity``) as (dp, hp, outer, inner): the ring, Ulysses
#: (with two data ranks to fill the world) and both; its batch.
PACKED_GRIDS = {"ring": (1, 1, 2, 2), "ulysses": (2, 2, 1, 1),
                "both": (1, 2, 1, 2)}
PACKED = dict(seq=64, gb=2, doc_len_range=(10, 38))


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


def _grad_shards(cfg, grid, mode, init, accum=1, gb=None, packed=False,
                 pc=None):
    """One call of the step's ``make_grad_fn`` under ``mode`` on ``grid``
    (or ``pc``) on batch 0: the loss, this rank's fp32 grad shards of the
    global loss, and the plan."""
    from repro_torch.core.plan import build_plan
    from repro_torch.core.zero import shard_params
    from repro_torch.data.pipeline import rank_slices
    from repro_torch.train.train_step import make_grad_fn
    t = PACKED if packed else TRAIN
    gb = gb or t["gb"]
    plan = build_plan(cfg, pc or pc_of(grid), device="cpu", impl="plain",
                      grad_accum=accum, zero=mode,
                      memory_budget_gb=BUDGET_GB, seq_len=t["seq"],
                      global_batch=gb, packed=packed)
    kw = dict(doc_len_range=t["doc_len_range"]) if packed else {}
    dcfg = plan.data_config(t["seq"], gb, **kw)
    data = plan.data_source(t["seq"], gb, shard=rank_slices(
        dcfg, plan.pc, plan.rt.coord), **kw)
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    metrics, grads = make_grad_fn(plan)(shard_params(copy.deepcopy(init),
                                                     plan), batch)
    return float(metrics["loss"]), grads, plan


def _full(grads, init, plan) -> list:
    """The full leaves of a list of grad shards (collective)."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.core.zero import gather_params
    return tree_flatten(gather_params(
        tree_unflatten(grads, tree_flatten(init)[1]), plan))[0]


def gather_case(cfg):
    """At depth 4, from seeded params: (a) under remat none, scpp and
    full, dp_sp: the largest number of layers whose gathered leaves were
    alive at once, and which other gathered leaves ever were (a hook on
    ``ZeroLayout.gather`` keeps a weak reference to each gathered leaf);
    the loss and full grads, and replica's.  (b) A bf16 step at
    grad_accum 1 and 4: the dtype of every grad and of every collective
    inside ``ZeroLayout.reduce``, with the top-level key of its leaf, and
    the calls of it."""
    import weakref

    from repro_torch import convert
    from repro_torch.core import zero
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(cfg, num_layers=GATHER_LAYERS)
    init = init_params(cfg, torch.Generator().manual_seed(1))
    paths = [p for p, _ in convert.port_leaves(cfg)]
    live, seen = [], {"layers": 0, "other": set(), "gathers": 0}
    recording = [False]
    real_gather, real_reduce = zero.ZeroLayout.gather, zero.ZeroLayout.reduce

    def gather(self, i, x):
        out = real_gather(self, i, x)
        if out is not x and recording[0]:
            live.append((weakref.ref(out), paths[i]))
            alive = [p for w, p in live if w() is not None]
            layers = {p[1] for p in alive if p[0] == "layers"}
            seen["layers"] = max(seen["layers"], len(layers))
            seen["other"] |= {p[0] for p in alive if p[0] != "layers"}
            seen["gathers"] += 1
        return out

    out = {"remat": {}}
    zero.ZeroLayout.gather = gather
    try:
        for remat in ("none", "scpp", "full"):
            live.clear()
            seen.update(layers=0, other=set(), gathers=0)
            rcfg = dataclasses.replace(cfg, remat=remat)
            recording[0] = True
            loss, grads, plan = _grad_shards(rcfg, GATHER_GRID, "dp_sp",
                                             init)
            recording[0] = False
            out["remat"][remat] = {"loss": loss,
                                   "grads": _full(grads, init, plan),
                                   "layers": seen["layers"],
                                   "other": seen["other"],
                                   "gathers": seen["gathers"]}
    finally:
        zero.ZeroLayout.gather = real_gather
    loss, grads, plan = _grad_shards(cfg, GATHER_GRID, "replica", init)
    out["replica"] = loss, _full(grads, init, plan)

    moved, inside = [], [None]
    wrapped = {name: getattr(zero, name) for name in
               ("reduce_scatter_", "all_reduce_", "broadcast_")}

    def reduce(self, i, g):
        moved.append(("grad", paths[i][0], g.dtype))
        inside[0] = paths[i][0]
        try:
            return real_reduce(self, i, g)
        finally:
            inside[0] = None

    def watch(name, fn):
        def called(x, *a, **kw):
            if inside[0] is not None:
                moved.append((name, inside[0], x.dtype))
            return fn(x, *a, **kw)
        return called

    zero.ZeroLayout.reduce = reduce
    for name, fn in wrapped.items():
        setattr(zero, name, watch(name, fn))
    out["bf16"] = {}
    try:
        bcfg = dataclasses.replace(cfg, dtype="bfloat16")
        for accum in (1, 4):
            moved.clear()
            _grad_shards(bcfg, GATHER_GRID, "dp_sp", init, accum=accum,
                         gb=8)
            out["bf16"][accum] = list(moved)
    finally:
        zero.ZeroLayout.reduce = real_reduce
        for name, fn in wrapped.items():
            setattr(zero, name, fn)
    out["n_leaves"] = len(paths)
    return out


def packed_case(cfg, init):
    """Per packed grid: the loss and the full grads of one packed batch
    (the reference's ``check_packed_parity`` batch) through the per-layer
    step under dp_sp, on the kernels' plain versions."""
    from repro_torch.core.topology import ParallelConfig
    out = {}
    for name, (dp, hp, no, wi) in PACKED_GRIDS.items():
        pc = ParallelConfig(dp=dp, hp=hp, cp_outer=no, cp_inner=wi)
        loss, grads, plan = _grad_shards(cfg, None, "dp_sp", init,
                                         packed=True, pc=pc)
        out[name] = {"loss": loss, "grads": _full(grads, init, plan),
                     "describe": plan.describe()}
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
               "gather": gather_case(cfg),
               "packed": packed_case(cfg, init),
               "compress": compress_case(rank)}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
