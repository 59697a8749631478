"""The rank program of ``tests/test_torch_attention2d.py``: eight gloo
ranks on the CPU, each running every case and writing its shards to
``<out>/rank<r>.pt``.  Imports torch and ``repro_torch`` only (no JAX):
the test process holds the shards against JAX single-device results.

Every case draws its global inputs from a numpy seed, lays them out as the
data pipeline does (zigzag over cp when the ring is causal), and keeps
this rank's shard: its rows over ``(pod, data)`` and its piece of the
sequence over ``(outer, inner, head)``.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8

#: name -> (dp, hp, outer, inner, placement): tests/_dist_checks.py's
#: 8-rank attention grids and the pure double ring.
GRIDS = {"1x2x2x2-head_first": (1, 2, 2, 2, "head_first"),
         "1x2x2x2-context_first": (1, 2, 2, 2, "context_first"),
         "1x8x1x1": (1, 8, 1, 1, "head_first"),
         "1x4x1x2": (1, 4, 1, 2, "head_first"),
         "2x2x2x1-context_first": (2, 2, 2, 1, "context_first"),
         "1x1x4x2": (1, 1, 4, 2, "head_first")}
#: The grid also run on ``impl="plain"`` (the kernel path).
PLAIN_GRID = "1x2x2x2-head_first"
GRID_SHAPE = (2, 64, 8, 4, 16)                 # B, S, Hq, Hkv, D

#: tests/_dist_checks.py::check_attention_modes's cases, each on 8 ranks
#: (dp 2 where the reference's grid has 4), plus a doc-start table.
MODES = {
    "window20": dict(causal=True, zigzag=True, window=20, softcap=0.0,
                     grid=(1, 2, 2, 2)),
    "softcap25": dict(causal=True, zigzag=True, window=None, softcap=25.0,
                      grid=(2, 2, 1, 2)),
    "noncausal": dict(causal=False, zigzag=False, window=None, softcap=0.0,
                      grid=(1, 2, 2, 2)),
    "contiguous": dict(causal=True, zigzag=False, window=None, softcap=0.0,
                       grid=(2, 1, 2, 2)),
    "contiguous-window12": dict(causal=True, zigzag=False, window=12,
                                softcap=0.0, grid=(2, 2, 1, 2)),
    "doc_start": dict(causal=True, zigzag=True, window=None, softcap=0.0,
                      grid=(1, 2, 2, 2), doc=True),
}
MODE_SHAPE = (2, 96, 4, 2, 8)

#: Reduced qwen3-1.7b's forward_loss on these (dp, hp, outer, inner).
MODEL_GRIDS = ((1, 2, 2, 2), (2, 2, 1, 2))
MODEL_B, MODEL_S = 2, 32

TRAIN = dict(seq=32, gb=4, steps=3, accum=2,
             opt=dict(lr=1e-2, warmup_steps=1, total_steps=3))
#: ``remat="auto"``'s workload and budget on the (1, 2, 2, 2) grid.
TRAIN_REMAT_AUTO = dict(seq_len=4096, global_batch=8, grad_accum=2,
                        memory_budget_gb=0.003)


def pc_of(grid, placement="head_first"):
    from repro_torch.core.topology import ParallelConfig
    dp, hp, no, wi = grid
    return ParallelConfig(dp=dp, hp=hp, cp_outer=no, cp_inner=wi,
                          placement=placement)


def grid_inputs():
    """check_attention_grid's q, k, v and the output weights."""
    b, s, h, hkv, d = GRID_SHAPE
    rng = np.random.default_rng(1)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                       (b, s, h, d))]


def mode_inputs():
    b, s, h, hkv, d = MODE_SHAPE
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                       (b, s, h, d))]
    return arrs


def doc_table() -> np.ndarray:
    """Per-token logical document starts: documents of 20, 31, 29 and 16
    tokens in row 0, 50 and 46 in row 1."""
    b, s = MODE_SHAPE[:2]
    rows = [np.repeat([0, 20, 51, 80], [20, 31, 29, 16]),
            np.repeat([0, 50], [50, 46])]
    return np.stack(rows).astype(np.int32)[:b, :s]


def model_batch(vocab: int):
    """tests/test_torch_train.py's batch: a padded tail of 3 labels."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, vocab, (MODEL_B, MODEL_S)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab,
                                   (MODEL_B, MODEL_S)).astype(np.int32),
            "labels": labels,
            "positions": np.broadcast_to(np.arange(MODEL_S, dtype=np.int32),
                                         (MODEL_B, MODEL_S)).copy()}


def _shard(x: np.ndarray, pc, coord, zz: bool):
    """This rank's shard of a global logical (B, S, ...) array."""
    from repro_torch.core.topology import batch_slice, seq_slice
    from repro_torch.core.zigzag import to_zigzag
    t = torch.from_numpy(np.ascontiguousarray(x))
    if zz:
        t = to_zigzag(t, pc.cp)
    rows = batch_slice(pc, coord, x.shape[0])
    piece = seq_slice(pc, coord, x.shape[1])
    return t[rows, piece].contiguous(), (rows.start, rows.stop,
                                         piece.start, piece.stop)


def attention_case(pc, arrays, *, impl, causal=True, zigzag=True,
                   window=None, softcap=0.0, doc=None):
    """out and dq / dk / dv of sum(out * w) on this rank's shard."""
    from repro_torch.core.attention2d import Attn2DConfig, attention_2d
    from repro_torch.core.runtime import world_runtime
    rt = world_runtime(pc, impl=impl, device="cpu")
    zz = zigzag and causal
    (q, where), (k, _), (v, _), (w, _) = (_shard(a, pc, rt.coord, zz)
                                          for a in arrays)
    d = None if doc is None else _shard(doc, pc, rt.coord, zz)[0]
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    cfg = Attn2DConfig(hp=pc.hp, n_out=pc.cp_outer, w=pc.cp_inner,
                       causal=causal, zigzag=zigzag, window=window,
                       softcap=softcap, impl=impl)
    out = attention_2d(q, k, v, cfg=cfg, doc_start=d, rt=rt)
    dq, dk, dv = torch.autograd.grad((out * w).sum(), (q, k, v))
    return {"where": where, "zz": zz, "cp": pc.cp, "out": out.detach(),
            "dq": dq, "dk": dk, "dv": dv}


def model_case(grid, params, cfg):
    """Reduced qwen3-1.7b's loss on this rank's shard and the grads summed
    over ranks (the train step's one all-reduce)."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.core.runtime import all_reduce_, world_runtime
    from repro_torch.models.model import forward_loss
    pc = pc_of(grid)
    rt = world_runtime(pc, impl="plain", device="cpu")
    batch = {key: _shard(a, pc, rt.coord, True)[0].long()
             for key, a in model_batch(cfg.vocab).items()}
    leaves, spec = tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    loss, metrics = forward_loss(tree_unflatten(leaves, spec), batch, rt,
                                 cfg)
    grads = [all_reduce_(g, rt) for g in torch.autograd.grad(loss, leaves)]
    return {"loss": loss.item(), "n_tokens": float(metrics["n_tokens"]),
            "grads": grads}


def trainer_case():
    """The launcher's path (build_plan + Trainer) on the (1, 2, 2, 2)
    grid: losses, final params, describe(), and what ``zero="sp"`` and
    ``remat="auto"`` plan there."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.configs import get_reduced
    from repro_torch.core.plan import build_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, pc = get_reduced("qwen3-1.7b"), pc_of((1, 2, 2, 2))
    planned = {
        "zero": build_plan(cfg, pc, device="cpu",
                           zero="sp").mem["zero_extent"],
        "remat": build_plan(cfg, pc, device="cpu", remat="auto",
                            **TRAIN_REMAT_AUTO).cfg.remat}
    plan = build_plan(cfg, pc, OptConfig(**TRAIN["opt"]), device="cpu",
                      impl="plain", grad_accum=TRAIN["accum"],
                      seq_len=TRAIN["seq"], global_batch=TRAIN["gb"])
    tr = Trainer(plan, plan.data_config(TRAIN["seq"], TRAIN["gb"]),
                 TrainerConfig(num_steps=TRAIN["steps"], log_every=1))
    losses = tr.run()
    return {"losses": losses, "params": tree_flatten(tr.params)[0],
            "describe": plan.describe(), "planned": planned}


def mesh_case():
    """``make_mesh`` and ``refine_mesh`` of a flat ``(data, model)`` mesh
    on the (1, 2, 2, 2) grid: their rank arrays and this rank's
    ``DeviceMesh`` coordinates, per placement."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.topology import make_mesh, refine_mesh
    base = DeviceMesh("cpu", torch.arange(WORLD).reshape(1, WORLD),
                      mesh_dim_names=("data", "model"))
    res = {}
    for placement in ("head_first", "context_first"):
        pc = pc_of((1, 2, 2, 2), placement)
        made, refined = make_mesh(pc), refine_mesh(base, pc)
        res[placement] = (made.mesh.tolist(), refined.mesh.tolist(),
                          tuple(made.get_coordinate()))
    return res


def main(rank: int, world: int, out: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.configs import get_reduced
        res = {"grid": {}, "mode": {}, "model": {}, "mesh": mesh_case()}
        arrays = grid_inputs()
        for name, (dp, hp, no, wi, placement) in GRIDS.items():
            res["grid"][name, "ref"] = attention_case(
                pc_of((dp, hp, no, wi), placement), arrays, impl="ref")
        dp, hp, no, wi, placement = GRIDS[PLAIN_GRID]
        res["grid"][PLAIN_GRID, "plain"] = attention_case(
            pc_of((dp, hp, no, wi), placement), arrays, impl="plain")
        arrays = mode_inputs()
        for name, c in MODES.items():
            res["mode"][name] = attention_case(
                pc_of(c["grid"]), arrays, impl="ref", causal=c["causal"],
                zigzag=c["zigzag"], window=c["window"],
                softcap=c["softcap"],
                doc=doc_table() if c.get("doc") else None)
        params = torch.load(os.path.join(out, "params.pt"))
        cfg = get_reduced("qwen3-1.7b")
        for grid in MODEL_GRIDS:
            res["model"][grid] = model_case(grid, params, cfg)
        res["trainer"] = trainer_case()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
