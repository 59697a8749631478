"""The port's hybrid ZeRO (``repro_torch.core.zero``), memory model
(``core/plan.py``) and AdamW on shards with int8 compression
(``train/optimizer.py``) against the JAX package on the CPU.

Without a process group: every leaf's spec and extent (the reference's
tree for qwen3-1.7b, olmo-1b, gemma2-2b and qwen3-moe-30b-a3b, full and
reduced, on the grids of ``tests/test_plan.py``, each ZeRO mode's group
order, and its three fallback cases), ``plan_memory``'s whole dict across
budgets, modes and remat, ``quantize_int8`` bit for bit, and AdamW's
weight decay on the reference's stacked norm weights.

With one: a module fixture spawns four gloo ranks once
(``tests/_torch_zero_worker.py``, which imports no JAX) and runs the JAX
one-device trainer meanwhile, from initial params drawn with numpy (every
leaf nonzero; the JAX initializer alone would compile for seconds).  The
tests hold each rank's shards, grad reduction and norm to the JAX
``NamedSharding`` of its mesh position, hybrid-ZeRO training to the JAX
trainer, the collectives of a step to their count at another
``grad_accum``, the per-layer step's gathers at use and bf16 reductions,
its grads to ``replica``'s, packed documents on the reference's three
packed grids to JAX's one-device packed result, and ``compressed_psum``
to the JAX quantizer.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.utils._pytree import tree_flatten

import _torch_zero_worker as W
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import plan as jplan_mod
from repro.core import zero as jzero
from repro.core.plan import build_plan as j_build_plan
from repro.core.topology import ParallelConfig as JParallelConfig
from repro.data import pipeline as jpipe
from repro.models.model import forward_loss as j_forward_loss
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import plan as tplan
from repro_torch.core import zero as tzero
from repro_torch.core.topology import (AXIS_DATA, AXIS_HP, AXIS_INNER,
                                       AXIS_OUTER, ParallelConfig)
from repro_torch.train import optimizer as topt

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
#: The fixture's limit: a rank that hangs fails the module, not the run.
SPAWN_SECONDS = 240
ARCHS = ("qwen3-1.7b", "olmo-1b", "gemma2-2b")
#: The trees the specs and the memory model are held on: the dense archs
#: and the MoE family's.
TREE_ARCHS = ARCHS + ("qwen3-moe-30b-a3b",)
#: tests/test_plan.py's grids as (dp, hp, outer, inner).
GRIDS = ((16, 8, 1, 2), (4, 2, 1, 1), (2, 1, 1, 2), (1, 2, 2, 2))


def _grid_pcs():
    """Every grid under both placements, and on two pods."""
    for dp, hp, no, wi in GRIDS:
        for kw in (dict(placement="head_first"),
                   dict(placement="context_first"), dict(pods=2)):
            yield dict(dp=dp, hp=hp, cp_outer=no, cp_inner=wi, **kw)


def _configs():
    for arch in TREE_ARCHS:
        yield j_get_config(arch), get_config(arch)
        yield j_get_reduced(arch), get_reduced(arch)


def _jpath(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _jspec(spec) -> tzero.LeafSpec:
    """A JAX ``PartitionSpec`` as the port's ``LeafSpec``."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            return tzero.LeafSpec(dim, entry if isinstance(entry, tuple)
                                  else (entry,))
    return tzero.REPLICATE


# ---------------------------------------------------------------------------
# Without a process group
# ---------------------------------------------------------------------------

def test_leaf_specs_match_jax():
    """The reference's tree (paths, shapes and count) from the port's
    config alone; then every leaf's spec and extent under every ZeRO
    mode's group order, the default order and ``include_pod``, on every
    grid; and ``tests/test_plan.py``'s sub-group fallback cases."""
    pod_first = ((("pod",) + jzero._DEFAULT_GROUPS[0]),) \
        + jzero._DEFAULT_GROUPS
    checked = {}            # (shape, mesh shape, groups) -> spec
    for jcfg, tcfg in _configs():
        struct = jplan_mod._params_struct(jcfg)
        jleaves = {_jpath(p): tuple(x.shape) for p, x in
                   jax.tree_util.tree_flatten_with_path(struct)[0]}
        assert convert.ref_param_shapes(tcfg) == jleaves, tcfg.name
        assert list(convert.ref_param_shapes(tcfg)) == list(jleaves)
        assert convert.param_count(tcfg) == jplan_mod._param_count(jcfg)
        for kw in _grid_pcs():
            jmesh = jplan_mod._ShapeOnlyMesh(JParallelConfig(**kw))
            tmesh = tplan._ShapeOnlyMesh(ParallelConfig(**kw))
            orders = [jplan_mod.plan_memory(jcfg, JParallelConfig(**kw),
                                            zero=m)[2]
                      for m, _ in jplan_mod.ZERO_MODES]
            for groups in orders + [jzero._DEFAULT_GROUPS, pod_first]:
                for shape in set(jleaves.values()):
                    key = shape, tuple(jmesh.shape.values()), groups
                    if key in checked:
                        continue
                    want = _jspec(jzero.leaf_spec(shape, jmesh, groups))
                    assert tzero.leaf_spec(shape, tmesh, groups) == want, \
                        (tcfg.name, kw, groups, shape)
                    assert tzero.leaf_extent(shape, tmesh, groups) == \
                        jzero.leaf_extent(shape, jmesh, groups)
                    checked[key] = want
            assert tzero.zero_shardings(jleaves, tmesh, pod_first) == {
                p: checked[s, tuple(jmesh.shape.values()), pod_first]
                for p, s in jleaves.items()}
    mesh = tplan._ShapeOnlyMesh(ParallelConfig(dp=4, hp=2))
    group = (AXIS_DATA, AXIS_HP, AXIS_OUTER, AXIS_INNER)
    assert tzero.leaf_extent((16, 8), mesh, (group,), min_elems=1) == \
        (8, group)
    assert tzero.leaf_extent((12, 4), mesh, (group,), min_elems=1) == \
        (4, (AXIS_DATA,))
    assert tzero.leaf_spec((12, 4), mesh, (group,), min_elems=1) == \
        tzero.LeafSpec(0, (AXIS_DATA,))
    assert tzero.leaf_extent((7, 5), mesh, (group,), min_elems=1) == (1, ())


def _flat_paths(tree):
    return [(_jpath(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]]


def test_plan_memory_matches_jax(monkeypatch):
    """Every key of ``plan_memory``'s dict, its policy, mode and groups,
    against the reference's at equal budgets, with the port's two rate
    constants set to the reference's; and ``tests/test_plan.py``'s three
    cases of ``choose_zero_mode``."""
    for name in ("CKPT_D2H_BYTES_PER_S", "OFFLOAD_WIRE_BYTES_PER_S"):
        monkeypatch.setattr(tplan, name, getattr(jplan_mod, name))
    n = 0
    for jcfg, tcfg in _configs():
        for kw in _grid_pcs():
            jpc, tpc = JParallelConfig(**kw), ParallelConfig(**kw)
            for zero in ["auto"] + [m for m, _ in jplan_mod.ZERO_MODES]:
                for remat in (None, "auto"):
                    for gb in (1, 16, 80):
                        for chunks in (1, 4):
                            args = dict(grad_accum=2, remat=remat,
                                        zero=zero, memory_budget_gb=gb,
                                        seq_len=4096, global_batch=32,
                                        offload_chunks=chunks)
                            want = jplan_mod.plan_memory(jcfg, jpc, **args)
                            got = tplan.plan_memory(tcfg, tpc, **args)
                            assert got == want, (tcfg.name, kw, args)
                            n += 1
    assert n == 2 * len(TREE_ARCHS) * 12 * 6 * 2 * 3 * 2
    mesh = tplan._ShapeOnlyMesh(ParallelConfig(dp=16, hp=8, cp_inner=2))
    assert tplan.choose_zero_mode(int(1e6), mesh, 16e9)[0] == "replica"
    assert tplan.choose_zero_mode(int(2e9), mesh, 16e9)[0] == "dp"
    assert tplan.choose_zero_mode(int(100e9), mesh, 16e9)[0] == "dp_sp"


def test_quantize_int8_bitwise_jax():
    """``quantize_int8`` / ``dequantize_int8`` bit for bit: random values
    with an error carry, and exact .5 ties (scale 1: half to even).  The
    JAX side runs op by op: under ``jit`` XLA fuses ``xf - q * scale``
    into one fused multiply-add, which rounds the error carry once."""
    rng = np.random.default_rng(7)
    ties = np.zeros(64, np.float32)
    ties[:10] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.0]
    cases = [(ties, np.zeros_like(ties))]
    for _ in range(2):
        cases.append((rng.standard_normal(64).astype(np.float32),
                      (1e-3 * rng.standard_normal(64)).astype(np.float32)))
    for x, e in cases:
        q, s, ne = jopt.quantize_int8(jnp.asarray(x), jnp.asarray(e))
        tq, ts, tne = topt.quantize_int8(torch.from_numpy(x),
                                         torch.from_numpy(e))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        assert float(ts) == float(s)
        np.testing.assert_array_equal(tne.numpy(), np.asarray(ne))
        np.testing.assert_array_equal(
            topt.dequantize_int8(tq, ts).numpy(),
            np.asarray(jopt.dequantize_int8(q, s)))
    assert topt.quantize_int8(torch.from_numpy(ties), torch.zeros(64))[0][
        1:7].tolist() == [0, 2, 2, 0, -2, -2]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b"])
def test_adamw_decays_stacked_norms_like_jax(arch):
    """Every leaf nonzero, three updates with clipping and decay active:
    the port's per-layer norm weights decay as the reference's stacked
    ``(G, d)`` leaves do (``convert.decay_mask``), every leaf within 1e-6
    of JAX ``adamw_update``."""
    jcfg, tcfg = j_get_reduced(arch), get_reduced(arch)
    rng = np.random.default_rng(9)
    struct = jplan_mod._params_struct(jcfg)
    draw = lambda s: jax.tree.map(                        # noqa: E731
        lambda x: (s * rng.standard_normal(x.shape)).astype(np.float32),
        struct)
    params, grads = draw(1.0), [draw(2.0) for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=4)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp)
    tp = convert.from_jax_params(params, tcfg, device="cpu")
    ts = topt.init_opt_state(tp)
    j_update = jax.jit(jopt.adamw_update, static_argnums=3)
    for g in grads:
        jp, js, jm = j_update(jp, jax.tree.map(jnp.asarray, g), js,
                              jopt.OptConfig(**cfg))
        tp, ts, tm = topt.adamw_update(
            tp, convert.from_jax_params(g, tcfg, device="cpu"), ts,
            topt.OptConfig(**cfg), decay=convert.decay_mask(tcfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        want = convert.from_jax_params(jax.tree.map(np.asarray, tree_j),
                                       tcfg, device="cpu")
        for t, w in zip(tree_flatten(tree_t)[0], tree_flatten(want)[0]):
            np.testing.assert_allclose(t.numpy(), w.numpy(), atol=1e-6,
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------

def _jax_trainer(init):
    """The JAX one-device trainer of ``W.TRAIN`` (not yet run), starting
    from ``init``."""
    t, jcfg = W.TRAIN, j_get_reduced("qwen3-1.7b")
    plan = j_build_plan(jcfg, JParallelConfig(),
                        jopt.OptConfig(**t["opt"]),
                        devices=jax.devices()[:1], impl="ref",
                        grad_accum=t["accum"], seq_len=t["seq"],
                        global_batch=t["gb"])
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jtrainer, "init_params",
                    lambda cfg, key: jax.tree.map(jnp.asarray, init))
        return jtrainer.Trainer(plan, plan.data_config(t["seq"], t["gb"]),
                                jtrainer.TrainerConfig(num_steps=t["steps"],
                                                       log_every=1))


def _random_tree(jcfg, seed: int):
    """numpy leaves of the reference's tree for ``jcfg``, drawn from a
    seed: linear weights N(0, d_in^-0.5), the rest N(0, 0.02), so the
    norm weights are nonzero too."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        std = x.shape[-2] ** -0.5 if path[-1].key == "w" and \
            len(x.shape) == 3 else 0.02
        return (std * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jplan_mod._params_struct(jcfg))


def _jax_packed(jcfg, tcfg, init):
    """JAX's one-device loss and grads (in the port's leaves) of the
    packed batch of ``W.PACKED``, in logical order."""
    p = W.PACKED
    data = jpipe.PackedLM(jpipe.DataConfig(
        vocab=jcfg.vocab, seq_len=p["seq"], global_batch=p["gb"],
        doc_len_range=p["doc_len_range"]))
    plan = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref")
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda q, b: j_forward_loss(q, b, plan.rt, jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, init),
            jax.tree.map(jnp.asarray, data.batch(0)))
    return float(loss), tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, grads), tcfg, device="cpu"))[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks once and run the JAX trainer meanwhile.
    Returns each rank's results and the JAX side."""
    out = tmp_path_factory.mktemp("zero")
    jcfg, tcfg = j_get_reduced("qwen3-1.7b"), get_reduced("qwen3-1.7b")
    layout = {}
    for layers in sorted({r[2] for r in W.SHARD_RUNS}):
        layout[layers] = _random_tree(W.layout_cfg(jcfg, layers), layers)
        torch.save(convert.from_jax_params(
            layout[layers], W.layout_cfg(tcfg, layers), device="cpu"),
            out / f"layout{layers}.pt")
    init = _random_tree(jcfg, 0)
    torch.save(convert.from_jax_params(init, tcfg, device="cpu"),
               out / "init.pt")
    ctx = mp.start_processes(W.main, args=(W.WORLD, str(out)),
                             nprocs=W.WORLD, join=False,
                             start_method="spawn")
    try:
        jtr = _jax_trainer(init)
        try:
            step_fn, gnorms = jtr.step_fn, []

            def recorded(p, o, b):
                res = step_fn(p, o, b)
                gnorms.append(float(res[2]["grad_norm"]))
                return res

            jtr.step_fn = recorded
            jlosses = jtr.run()
            jfinal = jax.tree.map(np.array, jtr.params)
        finally:
            jtr.guard.uninstall()
        jpacked = _jax_packed(jcfg, tcfg, init)
        deadline = time.monotonic() + SPAWN_SECONDS
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(W.WORLD)]
    return {"res": res, "layout": layout, "init": init, "jlosses": jlosses,
            "jgnorms": gnorms, "jfinal": jfinal, "jcfg": jcfg,
            "tcfg": tcfg, "jpacked": jpacked}


class _Dev:
    def __init__(self, i):
        self.id = i


def _shard_cases(ranks):
    """``(name, reference config, full tree, JAX plan kwargs, per-rank
    results)`` of every case with shards: the shard runs on their layout,
    then the trainer runs' initial shards."""
    for grid, mode, layers in W.SHARD_RUNS:
        yield ((grid, mode, layers), W.layout_cfg(ranks["jcfg"], layers),
               W.layout_cfg(ranks["tcfg"], layers), ranks["layout"][layers],
               grid, mode, [r["shard"][grid, mode, layers]
                            for r in ranks["res"]])
    for grid, mode in W.TRAIN_RUNS:
        yield ((grid, mode), ranks["jcfg"], ranks["tcfg"], ranks["init"],
               grid, mode, [r["trainer"][grid, mode] for r in ranks["res"]])


@pytest.mark.dist
def test_shards_match_jax_mesh_positions(ranks):
    """Each rank's shard of each port leaf equals the JAX
    ``NamedSharding`` shard at its mesh position (a layer whole or empty
    where the group axis is sharded; the embedding on a 2-way sub-group),
    and the plan's specs are the JAX plan's; on the shard runs,
    ``gather_params`` gives the tree back bit for bit, the grad reduction
    (reduce-scatter, then the complement all-reduce) leaves each rank its
    shard of the sum over the world exactly, and the norm over the shards
    counts every element once."""
    devs = [_Dev(i) for i in range(W.WORLD)]
    seen = set()
    for name, jcfg, tcfg, tree, grid, mode, cases in _shard_cases(ranks):
        refs = convert.ref_leaf_map(tcfg)
        dp, hp, no, wi, placement = W.GRIDS[grid]
        jplan = j_build_plan(jcfg, JParallelConfig(
            dp=dp, hp=hp, cp_outer=no, cp_inner=wi, placement=placement),
            devices=devs, zero=mode, memory_budget_gb=W.BUDGET_GB)
        shardings = dict(_flat_paths(jplan.param_shardings(tree)))
        for rank, case in enumerate(cases):
            assert case["specs"] == {p: _jspec(s.spec)
                                     for p, s in shardings.items()}, name
            if "gathered_equal" in case:
                assert case["gathered_equal"], (name, rank)
                assert case["reduced_equal"], (name, rank)
                np.testing.assert_allclose(*case["norm"], rtol=1e-6)
            for ref, got in zip(refs, case["shards"]):
                leaf = np.asarray(_at(tree, ref.path))
                idx = shardings[ref.path].devices_indices_map(
                    leaf.shape)[devs[rank]]
                want = leaf[idx]
                if ref.g is not None:
                    rows = range(leaf.shape[0])[idx[0]]
                    if ref.g not in rows:
                        assert got.numel() == 0, (name, ref)
                        seen.add("empty")
                        continue
                    want = want[rows.index(ref.g)]
                want = want.T if ref.transposed else want
                np.testing.assert_array_equal(got.numpy(), want)
                whole = leaf.size // (leaf.shape[0] if ref.g is not None
                                      else 1)
                seen.add("whole" if want.size == whole else "part")
    assert seen == {"whole", "part", "empty"}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.dist
@pytest.mark.parametrize("run", W.TRAIN_RUNS, ids=lambda r: "-".join(r))
def test_zero_trainer_matches_jax_trainer(ranks, run):
    """Three steps of reduced qwen3-1.7b in fp32 (grad_accum 2, lr 1e-2)
    under hybrid ZeRO on four ranks: losses and grad norms within 1e-5 of
    the JAX one-device trainer's, the same on every rank; the gathered
    params as ``test_torch_trainer.py`` holds them (1e-5 on at least 99.9%
    of each leaf, 2e-3 on all); each rank holds exactly ``1/extent`` of
    every sharded leaf's masters, m and v; ``describe()`` shows the mode,
    the leaf extents and the memory line."""
    tcfg = ranks["tcfg"]
    runs = [r["trainer"][run] for r in ranks["res"]]
    want = tree_flatten(convert.from_jax_params(ranks["jfinal"], tcfg,
                                                device="cpu"))[0]
    full = [w.numel() for w in want]
    for rank_run in runs:
        assert rank_run["losses"] == runs[0]["losses"]
        assert rank_run["gnorms"] == runs[0]["gnorms"]
        np.testing.assert_allclose(rank_run["losses"], ranks["jlosses"],
                                   **TOL)
        np.testing.assert_allclose(rank_run["gnorms"], ranks["jgnorms"],
                                   **TOL)
        for numel in rank_run["numel"]:
            assert numel == [n // e for n, e in zip(full,
                                                    rank_run["extent"])]
        assert f"zero        mode={run[1]}" in rank_run["describe"]
        assert "leaf extents: blocks=" in rank_run["describe"]
        assert "memory/dev" in rank_run["describe"]
    assert max(runs[0]["extent"]) == (4 if run[1] == "dp_sp" else 2)
    for a, b in zip(runs[0]["params"], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3, rtol=0)
        assert float(((a - b).abs() > 1e-5).float().mean()) <= 1e-3


@pytest.mark.dist
def test_zero_collectives_independent_of_accum(ranks):
    """The reduce-scatters of one step do not depend on ``grad_accum`` (1
    against 4): one reduction point a step, after the microbatch loop (the
    reference's ``check_accum_collectives`` (a)).  The gathers are made at
    use, so each microbatch makes the same ones: a forward's gathers times
    the microbatches."""
    for r in ranks["res"]:
        counts = r["accum"]
        assert counts[1]["reduce_scatter_"] == counts[4]["reduce_scatter_"]
        assert counts[1]["reduce_scatter_"] > 0
        assert counts[4]["gather_shards"] == 4 * counts[1]["gather_shards"]
        assert counts[1]["gather_shards"] >= counts[1]["reduce_scatter_"]


@pytest.mark.dist
def test_per_layer_gathers_and_bf16_reductions(ranks):
    """The per-layer step at depth 4 on (2, 1, 1, 2) under dp_sp.  Under
    remat none, scpp and full the leaves are gathered at use (more
    gathers than leaves), and at most two layers' gathered leaves, plus
    the tied table, are alive at once.  In a bf16 step every grad and
    every collective that reduces one moves bf16 (``final_norm``'s fp32,
    a leaf the reference keeps fp32 too), one reduction a leaf, the same
    at grad_accum 1 and 4."""
    for r in ranks["res"]:
        g = r["gather"]
        for remat, case in g["remat"].items():
            assert 1 <= case["layers"] <= 2, (remat, case["layers"])
            assert case["other"] == {"embed"}, (remat, case["other"])
            assert case["gathers"] > g["n_leaves"], remat
        one, four = g["bf16"][1], g["bf16"][4]
        assert sorted(one, key=str) == sorted(four, key=str)
        assert sum(name == "grad" for name, _, _ in one) == g["n_leaves"]
        assert {name for name, _, _ in one} >= {"grad", "reduce_scatter_",
                                                "all_reduce_"}
        # final_norm stays fp32, as in the reference (a 1-D leaf there)
        assert {(key == "final_norm", dt) for _, key, dt in one} == {
            (False, torch.bfloat16), (True, torch.float32)}


@pytest.mark.dist
def test_per_layer_step_matches_replica(ranks):
    """fp32 at depth 4 on (2, 1, 1, 2): the loss and every grad leaf of
    the per-layer dp_sp step under each remat within 1e-6 relative of
    ``replica``'s on the same grid (the grads summed in another order),
    on every rank."""
    for r in ranks["res"]:
        want_loss, want = r["gather"]["replica"]
        for remat, case in r["gather"]["remat"].items():
            assert abs(case["loss"] - want_loss) <= 1e-6 * abs(want_loss)
            for a, b in zip(case["grads"], want):
                scale = float(b.abs().max())
                assert float((a - b).abs().max()) <= 1e-6 * scale, remat


@pytest.mark.dist
def test_packed_grids_match_jax(ranks):
    """The reference's ``check_packed_parity`` batch on its three grids
    (the zigzag ring over (outer, inner) = (2, 2), Ulysses over hp = 2 on
    two data ranks, and both), through the per-layer step under dp_sp on
    the kernels' plain versions: every rank's packed loss and summed grads
    within 1e-5 of JAX's one-device packed result, and ``describe()``
    shows packing on."""
    jloss, jgrads = ranks["jpacked"]
    for r in ranks["res"]:
        assert r["packed"].keys() == W.PACKED_GRIDS.keys()
        for grid, case in r["packed"].items():
            assert abs(case["loss"] - jloss) < 1e-5, (grid, case["loss"],
                                                      jloss)
            for a, b in zip(case["grads"], jgrads):
                assert float((a - b).abs().max()) < 1e-5, grid
            assert "  packing     on" in case["describe"]


@pytest.mark.dist
def test_compressed_psum_matches_jax(ranks):
    """``compressed_psum`` over four ranks: each step's sum within 1e-6 of
    the sum of the JAX per-rank quantize / dequantize (error feedback
    carried per rank), and the running sum over 20 steps within 5% of the
    exact one (the reference's ``check_grad_compression``)."""
    err = [jnp.zeros(W.COMPRESS["width"]) for _ in range(W.WORLD)]
    exact = comp = 0.0
    sums = [r["compress"] for r in ranks["res"]]
    for s in sums[1:]:
        torch.testing.assert_close(s, sums[0], rtol=0, atol=0)
    for step in range(W.COMPRESS["steps"]):
        g = W.compress_grads(step)
        want = 0.0
        for r in range(W.WORLD):
            # op by op, as in test_quantize_int8_bitwise_jax: under jit the
            # error carry takes a fused multiply-add
            q, scale, err[r] = jopt.quantize_int8(jnp.asarray(g[r]),
                                                  err[r])
            want = want + np.asarray(jopt.dequantize_int8(q, scale))
        np.testing.assert_allclose(sums[0][step].numpy(), want, atol=1e-6,
                                   rtol=0)
        exact = exact + g.sum(0)
        comp = comp + sums[0][step].numpy()
    drift = np.abs(comp - exact).max() / np.abs(exact).max()
    assert drift < 0.05, drift
