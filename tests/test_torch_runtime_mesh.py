"""The port's runtime package on four gloo ranks: sharded checkpoints with
an elastic restore, the FPDT chunk pipeline on a mesh, and preemption.

A module fixture spawns the four ranks once (``tests/_torch_runtime_
worker.py``, which imports no JAX).  The tests hold:

* the elastic restore: plan A (``dp=2``, ``inner=2``, ZeRO extent 2)
  saves at step K, plan B (``dp=4``, extent 4) restores there, and the
  stitched losses match an uninterrupted plan-B run within 1e-5 (as the
  reference's ``tests/_dist_checks.py::check_ckpt_elastic``), each rank
  having written only its own shards;
* one process (this one) restoring the four-rank checkpoint and going on
  with the same losses, and JAX's ``restore`` reading the same files bit
  for bit what the port restored;
* the chunk pipeline against the resident 2D-Attention on (hp, outer,
  inner) = (1, 2, 2) and (2, 1, 2), with and without a doc table across
  the chunk edges, within 1e-5 and without a stall (as
  ``check_offload_parity``), both put together from the ranks' pieces
  and held to one process;
* SIGTERM raised in one rank stopping all four at the same step, with
  one checkpoint;
* a shard write failing on one rank: every rank's flush raises and no
  step directory is left.
"""
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_runtime_worker as W
from repro.configs import get_reduced as j_get_reduced
from repro.core import plan as jplan_mod
from repro.runtime import checkpoint as jckpt
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core.attention2d import (Attn2DConfig, attention_2d,
                                          from_chunk_layout)
from repro_torch.core.plan import build_plan
from repro_torch.core.topology import ParallelConfig, rank_coords
from repro_torch.core.zigzag import from_zigzag
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
#: The fixture's limit: a rank that hangs fails the module, not the run.
SPAWN_SECONDS = 240


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("runtime")
    ctx = mp.start_processes(W.main, args=(W.WORLD, str(out)),
                             nprocs=W.WORLD, join=False,
                             start_method="spawn")
    try:
        deadline = time.monotonic() + SPAWN_SECONDS
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(W.WORLD)]


def _one_process(ckpt_dir):
    """The port's one-device trainer at the workers' shapes, resuming from
    ``ckpt_dir``."""
    plan = build_plan(get_reduced("qwen3-1.7b"), opt=OptConfig(**W.OPT),
                      device="cpu", impl="plain", seq_len=W.S,
                      global_batch=W.GB)
    return Trainer(plan, plan.data_config(W.S, W.GB),
                   TrainerConfig(num_steps=W.N, ckpt_dir=ckpt_dir,
                                 log_every=1000))


@pytest.mark.dist
def test_elastic_restore_across_extents(ranks):
    """Plan A saves at step K at extent 2, plan B restores at extent 4
    and continues: every rank's stitched losses match the uninterrupted
    plan-B run within 1e-5, and the manifest records plan A with shards
    over 1."""
    for r in ranks:
        e = r["elastic"]
        assert e["extents"] == (2, 4) and e["start"] == W.K
        got = e["part1"] + e["part2"]
        assert len(got) == W.N
        np.testing.assert_allclose(got, e["base"], **TOL)
        np.testing.assert_allclose(e["base"], ranks[0]["elastic"]["base"],
                                   rtol=0, atol=0)
    m = ranks[0]["elastic"]["manifest"]
    assert m["plan"]["dp"] == 2 and m["plan"]["cp_inner"] == 2
    assert m["plan"]["zero_extent"] == 2
    assert max(e["shards"] for e in m["leaves"]) > 1


@pytest.mark.dist
def test_each_rank_writes_only_its_shards(ranks):
    """Every shard file of the checkpoint was written by exactly one
    rank, rank 0 alone wrote the replicated leaves and ``opt.step``, the
    writers are the two ranks of the extent-2 ``data`` group whose
    ``inner`` coordinate is 0 (the other copy of each shard is not
    written), and each writer's bytes are at most its share of the
    state plus the replicated leaves: the gather to one rank never
    happens."""
    e0 = ranks[0]["elastic"]
    m, d = e0["manifest"], os.path.join(e0["dir"], f"step_{W.K:08d}")
    want = {f"leaf_{i}.s{j}.npy" for i, e in enumerate(m["leaves"])
            for j in range(e["shards"])}
    written = [r["elastic"]["written"] for r in ranks]
    flat = [n for w in written for n in w]
    assert sorted(flat) == sorted(want)
    whole = {f"leaf_{i}.s0.npy" for i, e in enumerate(m["leaves"])
             if e["shards"] == 1}
    assert whole <= set(written[0])
    sizes = [sum(os.path.getsize(os.path.join(d, n)) for n in w)
             for w in written]
    pc_a = W.pc_of(W.PLAN_A)
    assert [r for r, s in enumerate(sizes) if s > 0] == [
        r for r in range(W.WORLD) if rank_coords(pc_a, r).inner == 0]
    replicated = sum(os.path.getsize(os.path.join(d, n)) for n in whole)
    for r, s in enumerate(sizes):
        assert s <= m["bytes_per_host"] + (replicated if r == 0 else 0)


@pytest.mark.dist
def test_one_process_restores_sharded_checkpoint(ranks, tmp_path):
    """This process restores the four ranks' step-K checkpoint on one
    device and continues: its losses are the plan-B run's within 1e-5."""
    e = ranks[0]["elastic"]
    d = str(tmp_path / "c")
    shutil.copytree(os.path.join(e["dir"], f"step_{W.K:08d}"),
                    os.path.join(d, f"step_{W.K:08d}"))
    tr = _one_process(d)
    assert tr.start_step == W.K
    np.testing.assert_allclose(tr.run(), e["base"][W.K:], **TOL)


@pytest.mark.dist
def test_jax_restores_sharded_checkpoint_bitwise(ranks):
    """JAX's ``restore`` puts the four ranks' shards together into its
    trainer state, bit for bit what the port restores on one process."""
    e = ranks[0]["elastic"]
    jcfg = j_get_reduced("qwen3-1.7b")
    struct = jplan_mod._params_struct(jcfg)
    template = {"params": struct,
                "opt": {"m": struct, "v": struct,
                        "step": jax.ShapeDtypeStruct((), jnp.int32)}}
    got, step = jckpt.restore(template, e["dir"], step=W.K)
    assert step == W.K
    tr = _one_process(None)
    ckpt.CheckpointManager(e["dir"], plan=tr.plan).restore(
        {"params": tr.params, "opt": tr.opt_state}, step=W.K)
    cfg = tr.plan.cfg
    want = {"params": convert.to_jax_params(tr.params, cfg),
            "opt": {"m": convert.to_jax_params(tr.opt_state["m"], cfg),
                    "v": convert.to_jax_params(tr.opt_state["v"], cfg),
                    "step": np.asarray(tr.opt_state["step"], np.int32)}}
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w) == 40
    for a, b in zip(g, w):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def _inputs():
    """The workers' chunk inputs, drawn as they draw them."""
    rng = np.random.default_rng(11)
    q, w = (rng.standard_normal((W.CB, W.CS, W.CH, W.CD)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((W.CB, W.CS, W.CHKV, W.CD))
            .astype(np.float32) for _ in range(2))
    return q, k, v, w


@pytest.mark.dist
@pytest.mark.parametrize("grid", W.CHUNK_GRIDS)
def test_chunked_matches_resident_on_mesh(ranks, grid):
    """On (hp, outer, inner) = ``grid``: the chunk pipeline's out, dq, dk
    and dv, put together from the four ranks' pieces, equal the resident
    2D-Attention's (put together from its zigzag shards) and one
    process's within 1e-5, with and without a doc table across the chunk
    edges; no rank stalled."""
    pc = ParallelConfig(hp=grid[0], cp_outer=grid[1], cp_inner=grid[2])
    q, k, v, w = _inputs()
    for docs in (False, True):
        cases = [r["chunk"][grid, docs] for r in ranks]
        assert all(c["stats"]["stalls"] == 0 for c in cases)
        assert all(c["stats"]["device_bytes"] == 0 for c in cases)
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in
                      (q, k, v))
        doc = torch.from_numpy(W.CDOC) if docs else None
        one = attention_2d(tq, tk, tv, cfg=Attn2DConfig(impl="plain"),
                           doc_start=doc)
        (one * torch.from_numpy(w)).sum().backward()
        want = [one.detach(), tq.grad, tk.grad, tv.grad]
        for n, name in enumerate(("out", "dq", "dk", "dv")):
            chunked = from_chunk_layout(
                [(c["coord"], c["chunked"][n]) for c in cases], W.CC, pc)
            resident = torch.cat(
                [c["resident"][n] for c in sorted(
                    cases, key=lambda c: (c["coord"].outer, c["coord"].inner,
                                          c["coord"].head))], dim=1)
            resident = from_zigzag(resident, pc.cp)
            np.testing.assert_allclose(chunked.numpy(), resident.numpy(),
                                       err_msg=f"{name} docs={docs}", **TOL)
            np.testing.assert_allclose(chunked.numpy(), want[n].numpy(),
                                       err_msg=f"{name} docs={docs}", **TOL)


@pytest.mark.dist
def test_preemption_stops_every_rank_at_one_step(ranks):
    """SIGTERM in rank 2 alone, during step 1: all four ranks stop after
    that step with the same losses, and the one checkpoint is step 2."""
    got = [r["preempt"] for r in ranks]
    assert [g["requested"] for g in got] == [
        r == W.PREEMPT_RANK for r in range(W.WORLD)]
    for g in got:
        assert len(g["losses"]) == 2 and g["steps"] == [2]
        assert g["losses"] == got[0]["losses"]


@pytest.mark.dist
def test_failed_shard_write_leaves_no_step(ranks):
    """Rank 2's shard write fails: rank 2 raises its error, rank 0
    abandons the temp dir and the others learn it, so every rank's flush
    raises and no step directory, visible or temporary, is left."""
    got = [r["crash"] for r in ranks]
    assert [g["error"] for g in got] == [
        "RuntimeError", "RuntimeError", "OSError", "RuntimeError"]
    for g in got:
        assert g["steps"] == [] and g["dirs"] == []
