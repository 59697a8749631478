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
  step directory is left;
* expert parallelism: ``moe_apply`` on (1, 2, 1, 2) against JAX's on one
  device (capacity factor 8.0) and against JAX's on each rank's shard
  (0.5, with drops), reduced qwen3-moe-30b-a3b's ``dp_sp`` step on
  (2, 1, 1, 2) against the JAX one-device step, and reduced
  deepseek-v2-lite-16b's (MLA) on (1, 2, 1, 2) under each remat mode
  against the JAX one-device step;
* the context-parallel scan on (1, 2, 1, 2), four sequence ranks:
  ``gather_stack``'s grads against one process's, ``mamba1_apply`` and
  ``mamba2_apply`` against JAX's on one device, and reduced zamba2-7b's
  ``dp_sp`` step against the JAX one-device step;
* the encoder-decoder family: reduced whisper-small's ``dp_sp`` step on
  (1, 2, 1, 2) under each remat mode against the JAX one-device step.
"""
import dataclasses
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.utils._pytree import tree_flatten

import _torch_runtime_worker as W
from repro.configs import get_reduced as j_get_reduced
from repro.core import plan as jplan_mod
from repro.core.plan import build_plan as j_build_plan
from repro.data import pipeline as jpipe
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.model import forward_loss as j_forward_loss
from repro.runtime import checkpoint as jckpt
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core.attention2d import (Attn2DConfig, attention_2d,
                                          from_chunk_layout)
from repro_torch.core.plan import build_plan
from repro_torch.core.topology import ParallelConfig, rank_coords, seq_slice
from repro_torch.models.model import init_params
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


def _jax_moe_leaves(p):
    """The workers' MoE leaves in the reference's layout."""
    out = {k: jnp.asarray(p[k]) for k in ("router", "w1", "w3", "w2")}
    out["shared"] = {k: {"w": jnp.asarray(p["shared"][k]["w"].T)}
                     for k in ("w1", "w3", "w2")}
    return out


def _moe_grads_close(got, want, bound):
    for k in ("router", "w1", "w3", "w2"):
        assert float(np.abs(got[k].numpy() - np.asarray(want[k])).max()) \
            < bound, k
    for k in ("w1", "w3", "w2"):
        assert float(np.abs(got["shared"][k]["w"].numpy().T - np.asarray(
            want["shared"][k]["w"])).max()) < bound, k


@pytest.mark.dist
def test_moe_apply_on_mesh_matches_jax(ranks):
    """``moe_apply`` with EP = 4 (hierarchical all-to-all over head and
    inner): at capacity factor 8.0 every rank's y within 5e-6 of JAX's on
    one device at its tokens, and the grads of sum(y * w), summed over the
    ranks, within 1e-4 (the reference's ``check_moe``); at 0.5, where
    capacity is per rank and some assignments drop, each rank's y equals
    JAX's applied to its shard alone, the aux the mean of those shards'
    auxes, and the grads of sum(y * w) + 1000 aux the sum of theirs."""
    p, x, w = W.moe_inputs()
    jp = _jax_moe_leaves(p)
    rt = j_build_plan(j_get_reduced("qwen3-moe-30b-a3b"),
                      devices=jax.devices()[:1], impl="ref").rt
    pc = W.pc_of(W.MOE_GRID)
    for cf in W.MOE_CFS:
        m = jmoe.MoEDims(capacity_factor=cf, **W.MOE_DIMS)

        def f(p, x, w, scale):
            y, aux = jmoe.moe_apply(p, x, rt, m)
            return (y * w).sum() + scale * aux, (y, aux)

        f = jax.jit(jax.value_and_grad(f, has_aux=True))
        got = [r["moe"]["apply"][cf] for r in ranks]
        for g in got[1:]:                  # the sum is the same everywhere
            for a, b in zip(tree_flatten(g["grads"])[0],
                            tree_flatten(got[0]["grads"])[0]):
                assert torch.equal(a, b)
        assert all((g["dropped"] > 0) == (cf < 1) for g in got)
        slices = [slice(*r["moe"]["slice"]) for r in ranks]
        assert [slices[r] for r in range(W.WORLD)] == [
            seq_slice(pc, rank_coords(pc, r), W.MS) for r in range(W.WORLD)]
        if cf >= 1:
            (_, (y, _)), grads = f(jp, x, w, 0.0)
            for g, sl in zip(got, slices):
                assert float(np.abs(g["y"].numpy()
                                    - np.asarray(y)[:, sl]).max()) < 5e-6
            _moe_grads_close(got[0]["grads"], grads, 1e-4)
            continue
        total, auxes = None, []
        for g, sl in zip(got, slices):
            (_, (y, aux)), grads = f(jp, x[:, sl], w[:, sl],
                                     W.MOE_AUX_SCALE / W.WORLD)
            assert float(np.abs(g["y"].numpy() - np.asarray(y)).max()) < 5e-6
            auxes.append(float(aux))
            total = grads if total is None else jax.tree.map(
                jnp.add, total, grads)
        for g in got:
            assert abs(g["aux"] - np.mean(auxes)) <= 1e-6 * np.mean(auxes)
        _moe_grads_close(got[0]["grads"], total, 1e-4)


@pytest.mark.dist
def test_moe_dp_sp_step_matches_jax(ranks):
    """Reduced qwen3-moe-30b-a3b under ``dp_sp`` on (2, 1, 1, 2) from the
    same params: the plan lays the batches out zigzag (the MoE family is
    among the reference's zigzag families), the gathered grads of every
    rank (the experts reduced over the world from each rank's own block)
    and the loss within 1e-5 of JAX's one-device step without the aux;
    with the config's aux weight, the xent (which the aux does not touch)
    within 1e-5 of JAX's, and the loss the xent plus the aux.

    Reduced deepseek-v2-lite-16b (MLA: d_qk 24, V padded from 16, one
    shared rope key head; two of its four heads a rank by Ulysses over
    head, the zigzag ring over inner, the experts over head and inner)
    under ``dp_sp`` on (1, 2, 1, 2), the aux weight 0, under each remat
    mode: every rank's loss within 1e-5 relative and every gathered grad
    leaf within 1e-5 of JAX's one-device step on the same params and
    batch."""
    tcfg = W.moe_step_cfg(0.0)
    params = init_params(tcfg, torch.Generator().manual_seed(W.MOE_SEED))
    jtree = jax.tree.map(jnp.asarray, convert.to_jax_params(params, tcfg))
    data = jpipe.SyntheticLM(jpipe.DataConfig(
        vocab=tcfg.vocab, seq_len=W.MOE_S, global_batch=W.MOE_GB, cp=1,
        zigzag=False))
    batch = jax.tree.map(jnp.asarray, data.batch(0))
    jcfg = j_get_reduced("qwen3-moe-30b-a3b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, aux_weight=0.0))
    rt = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref").rt
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, rt, jcfg), has_aux=True))(
            jtree, batch)
    xent, grads = float(m["xent"]), tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, g), tcfg, device="cpu"))[0]
    assert float(loss) == xent
    for r in ranks:
        for aw, case in r["moe"]["step"].items():
            assert case["zigzag"] and case["extent"] == 4
            got = case["metrics"]
            assert abs(got["xent"] - xent) < 1e-5, (aw, got, xent)
            if aw:
                assert got["aux"] > 0 and abs(
                    got["loss"] - got["xent"] - got["aux"]) < 1e-6
                continue
            assert abs(got["loss"] - xent) < 1e-5
            for a, b in zip(case["grads"], grads):
                assert float((a - b).abs().max()) < 1e-5
    tcfg = W.mla_cfg()
    params = init_params(tcfg, torch.Generator().manual_seed(W.MLA_SEED))
    jtree = jax.tree.map(jnp.asarray, convert.to_jax_params(params, tcfg))
    data = jpipe.SyntheticLM(jpipe.DataConfig(
        vocab=tcfg.vocab, seq_len=W.MLA_S, global_batch=W.MLA_GB, cp=1,
        zigzag=False))
    batch = jax.tree.map(jnp.asarray, data.batch(0))
    jcfg = j_get_reduced("deepseek-v2-lite-16b")
    jcfg = dataclasses.replace(jcfg, remat="full", moe=dataclasses.replace(
        jcfg.moe, aux_weight=0.0))
    rt = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref").rt
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, rt, jcfg), has_aux=True))(
            jtree, batch)
    loss, grads = float(loss), tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, g), tcfg, device="cpu"))[0]
    for r in ranks:
        case = r["mla"]
        assert case["zigzag"] and case["extent"] == 4
        for remat in ("none", "full", "scpp"):
            got = case[remat]
            assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), remat
            assert len(got["grads"]) == len(grads)
            for a, b in zip(got["grads"], grads):
                assert float((a - b).abs().max()) < 1e-5, remat


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_layer(p):
    """The workers' mixer leaves (port layout) in the reference's."""
    return {k: ({n: jnp.asarray(x.T if n == "w" and x.ndim == 2 else x)
                 for n, x in v.items()} if isinstance(v, dict)
                else jnp.asarray(v)) for k, v in p.items()}


@pytest.mark.dist
def test_ssm_layers_on_mesh_match_jax(ranks):
    """On four sequence ranks (head among them): ``gather_stack`` stacks
    the ranks' tensors in sequence order and its grads equal one process's
    (the sum over the ranks of their cotangents' slice); each rank's y of
    ``mamba1_apply`` / ``mamba2_apply`` and its x grad equal JAX's on one
    device at its tokens and the prefill state (``h`` after the whole
    sequence, ``conv`` the last piece's inputs) is JAX's on every rank,
    within the reference suite's 1e-5 (Mamba2 5e-5,
    ``tests/_dist_checks.py::check_ssm``), and the leaves' grads summed
    over the ranks equal JAX's within the same bounds, norm-relative."""
    n = W.WORLD
    stacked = torch.arange(1, n + 1, dtype=torch.float32)[:, None].expand(
        n, 3)
    for r in ranks:
        g = r["ssm"]["gather"]
        assert torch.equal(g["stacked"], stacked)
        want = sum(torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
                   [g["index"]] * (q["ssm"]["gather"]["index"] + 1)
                   for q in ranks)
        assert torch.equal(g["grad"], want)
    rt = j_build_plan(j_get_reduced("zamba2-7b"), devices=jax.devices()[:1],
                      impl="ref").rt
    for kind, tol in (("mamba1", 1e-5), ("mamba2", 5e-5)):
        m, p, x, w = W.ssm_inputs(kind)
        jm = (jssm.Mamba1Dims if kind == "mamba1" else jssm.Mamba2Dims)(
            **W.SSM_DIMS[kind])
        apply = jssm.mamba1_apply if kind == "mamba1" else jssm.mamba2_apply

        def f(p, x):
            y, st = apply(p, x, rt, jm, return_state=True)
            return (y * w).sum(), (y, st)

        (_, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(_jax_layer(p), x)
        gp = jax.tree.map(np.asarray, gp)
        for r in ranks:
            got, sl = r["ssm"]["layers"][kind], slice(*r["ssm"]["slice"])
            assert float(np.abs(got["y"].numpy() - np.asarray(y)[:, sl])
                         .max()) < tol, kind
            assert float(np.abs(got["dx"].numpy() - np.asarray(gx)[:, sl])
                         .max()) < tol, kind
            for k in ("h", "conv"):
                assert float(np.abs(got["state"][k].numpy()
                                    - np.asarray(st[k])).max()) < tol, k
            for k, v in got["grads"].items():
                if isinstance(v, dict):
                    for name, t in v.items():
                        ww = gp[k][name]
                        assert _norm_rel(t, ww.T if t.ndim == 2 else ww) \
                            < tol, (kind, k, name)
                else:
                    assert _norm_rel(v, gp[k]) < tol, (kind, k)


@pytest.mark.dist
def test_zamba2_dp_sp_step_matches_jax(ranks):
    """Reduced zamba2-7b under ``dp_sp`` on (1, 2, 1, 2) from the same
    params: the plan lays the batches out contiguously, the shared block's
    attention runs Ulysses over head and the contiguous ring over inner,
    the Mamba2 layers scan across the four pieces, and every rank's loss
    and gathered grads (the shared block's summed over its two
    applications) lie within 1e-5 of JAX's one-device step."""
    tcfg = get_reduced("zamba2-7b")
    params = init_params(tcfg, torch.Generator().manual_seed(W.SSM_SEED))
    jtree = jax.tree.map(jnp.asarray, convert.to_jax_params(params, tcfg))
    data = jpipe.SyntheticLM(jpipe.DataConfig(
        vocab=tcfg.vocab, seq_len=W.SSM_S, global_batch=W.SSM_GB, cp=1,
        zigzag=False))
    batch = jax.tree.map(jnp.asarray, data.batch(0))
    jcfg = dataclasses.replace(j_get_reduced("zamba2-7b"), remat="full")
    rt = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref").rt
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, rt, jcfg), has_aux=True))(
            jtree, batch)
    grads = tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, g), tcfg, device="cpu"))[0]
    for r in ranks:
        case = r["ssm"]["step"]
        assert not case["zigzag"] and case["extent"] == 4
        assert abs(case["metrics"]["loss"] - float(loss)) < 1e-5
        for a, b in zip(case["grads"], grads):
            assert float((a - b).abs().max()) < 1e-5


@pytest.mark.dist
def test_whisper_dp_sp_step_matches_jax(ranks):
    """Reduced whisper-small under ``dp_sp`` on (1, 2, 1, 2) from the same
    params, under each remat mode: zigzag tokens and a contiguous piece
    of the frames a rank (8 of 32), the encoder's non-causal ring over
    inner on the contiguous layout, the decoder's zigzag ring, the cross
    K/V gathered over the four sequence ranks and cut to the rank's
    heads; every rank's loss within 1e-5 of JAX's one-device step and
    every gathered grad leaf within 1e-4 norm-relative (a self-attention
    key bias, whose true grad is zero, against its layer's key
    weight)."""
    tcfg = get_reduced("whisper-small")
    params = init_params(tcfg, torch.Generator().manual_seed(W.ENC_SEED))
    jtree = jax.tree.map(jnp.asarray, convert.to_jax_params(params, tcfg))
    jcfg = dataclasses.replace(j_get_reduced("whisper-small"), remat="full")
    data = jpipe.SyntheticLM(jpipe.DataConfig(
        vocab=tcfg.vocab, seq_len=W.ENC_S, global_batch=W.ENC_GB, cp=1,
        zigzag=False), jcfg)
    batch = jax.tree.map(jnp.asarray, data.batch(0))
    rt = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref").rt
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, rt, jcfg), has_aux=True))(
            jtree, batch)
    grads = tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, g), tcfg, device="cpu"))[0]
    paths = convert.tree_paths(params)
    index = {p: i for i, p in enumerate(paths)}
    scale = [grads[index[p[:-1] + ("w",)]] if p[-3:] == ("attn", "wk", "b")
             else grads[i] for i, p in enumerate(paths)]
    for r in ranks:
        case = r["encdec"]
        assert case["zigzag"] and case["extent"] == 4
        for remat in ("none", "full", "scpp"):
            got = case[remat]
            assert got["frames"] == (W.ENC_GB, tcfg.enc_frames // 4,
                                     tcfg.d_model)
            assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
            for a, b, s, path in zip(got["grads"], grads, scale, paths):
                assert float((a - b).norm() / s.norm()) < 1e-4, (remat, path)
