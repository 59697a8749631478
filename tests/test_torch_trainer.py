"""The port's training loop (``repro_torch``) against the JAX package on
the CPU: ``SyntheticLM`` batches (bit-identical), AdamW (1e-6), a 3-step
trainer run from the same initial params (losses 1e-5), the launcher and
the one-device ``build_plan``.  The model's loss and grads are in
``test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.configs import get_reduced as j_get_reduced
from repro.core.plan import build_plan as j_build_plan
from repro.core.topology import ParallelConfig as JParallelConfig
from repro.data import pipeline as jpipe
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core.plan import build_plan
from repro_torch.core.topology import ParallelConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cp,accum", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_synthetic_batches_bit_identical(cp, accum):
    """``SyntheticLM`` batches equal the reference's bit for bit, zigzag
    layout and microbatch split included."""
    kw = dict(vocab=97, seq_len=16, global_batch=4, cp=cp, grad_accum=accum,
              seed=3, pad_frac=0.25)
    jsrc = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    tsrc = tpipe.SyntheticLM(tpipe.DataConfig(**kw))
    for (js, jb), (ts, tb) in zip(jsrc.iter_batches(5, 2),
                                  tsrc.iter_batches(5, 2)):
        assert js == ts and jb.keys() == tb.keys()
        for key in jb:
            assert jb[key].dtype == tb[key].dtype
            np.testing.assert_array_equal(jb[key], tb[key])


def test_adamw_matches_jax():
    """Three AdamW updates (clipping active, warmup then cosine, decay on
    matrices only) against the reference's, within 1e-6."""
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "b": (5,), "blk": {"k": (3, 4, 2), "n": (7,)}}

    def draw(sh, scale):
        if isinstance(sh, dict):
            return {k: draw(v, scale) for k, v in sh.items()}
        return (scale * rng.standard_normal(sh)).astype(np.float32)

    params = draw(shapes, 1.0)
    grads = [draw(shapes, 2.0) for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=4)
    # torch updates its params in place, and jnp.asarray may alias a numpy
    # buffer on the CPU: each side gets its own copy.
    jp, tp = jax.tree.map(jnp.asarray, params), \
        torch.utils._pytree.tree_map(lambda x: torch.from_numpy(x.copy()),
                                     params)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    j_update = jax.jit(jopt.adamw_update, static_argnums=3)
    for g in grads:
        jp, js, jm = j_update(jp, jax.tree.map(jnp.asarray, g), js,
                              jopt.OptConfig(**kw))
        tp, ts, tm = topt.adamw_update(
            tp, torch.utils._pytree.tree_map(torch.from_numpy, g), ts,
            topt.OptConfig(**kw))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert ts["step"] == int(js["step"]) == 3
    for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for t, j in zip(jax.tree.leaves(tree_t), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                       rtol=1e-6)


def test_adamw_groups_split_large_leaves(monkeypatch):
    """Groups of at most ``GROUP_NUMEL`` elements, a larger leaf split
    into ranges of its own, update exactly as one group a leaf does."""
    assert list(topt._groups([3, 9, 2, 4], 4)) == [
        [(0, 0, 3)], [(1, 0, 4)], [(1, 4, 8)], [(1, 8, 9), (2, 0, 2)],
        [(3, 0, 4)]]
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((6, 5)), "b": rng.standard_normal(7),
              "e": rng.standard_normal((3, 4))}
    grads = [{k: rng.standard_normal(v.shape) for k, v in params.items()}
             for _ in range(2)]
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    out = []
    for numel in (1 << 26, 4):
        monkeypatch.setattr(topt, "GROUP_NUMEL", numel)
        tp = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in params.items()}
        ts = topt.init_opt_state(tp)
        for g in grads:
            topt.adamw_update(tp, {k: torch.tensor(v, dtype=torch.float32)
                                   for k, v in g.items()}, ts, cfg)
        out.append((tp, ts))
    for tree in ("p", "m", "v"):
        a, b = ((tp if tree == "p" else ts[tree]) for tp, ts in out)
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def test_trainer_matches_jax_trainer():
    """Three steps of the port's ``Trainer`` (grad_accum 2: token-weighted
    accumulation) from the JAX trainer's initial params give the JAX
    ``Trainer``'s losses within 1e-5.  The params after the last update
    agree within 1e-5 on at least 99.9% of the elements of every leaf and
    within 2e-3, a fifth of one step at lr 1e-2, on all: where a grad is
    near zero, Adam's m / sqrt(v) turns a last-bit difference into a step
    of either sign."""
    jcfg, tcfg = j_get_reduced("qwen3-1.7b"), get_reduced("qwen3-1.7b")
    seq, gb, steps = 32, 4, 3
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=steps)
    jplan = j_build_plan(jcfg, JParallelConfig(), jopt.OptConfig(**kw),
                         devices=jax.devices()[:1], impl="ref", grad_accum=2,
                         seq_len=seq, global_batch=gb)
    jtr = jtrainer.Trainer(jplan, jplan.data_config(seq, gb),
                           jtrainer.TrainerConfig(num_steps=steps,
                                                  log_every=1))
    try:
        init = jax.tree.map(np.array, jtr.params)
        jlosses = jtr.run()
        jfinal = jax.tree.map(np.array, jtr.params)
    finally:
        jtr.guard.uninstall()
    plan = build_plan(tcfg, opt=topt.OptConfig(**kw), device="cpu",
                      impl="plain", grad_accum=2, seq_len=seq,
                      global_batch=gb)
    tr = Trainer(plan, plan.data_config(seq, gb),
                 TrainerConfig(num_steps=steps, log_every=1))
    tr.params = convert.from_jax_params(init, tcfg, device="cpu")
    tr.opt_state = topt.init_opt_state(tr.params)
    losses = tr.run()
    assert len(losses) == steps and losses[0] != losses[-1]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    want = tree_flatten(convert.from_jax_params(jfinal, tcfg,
                                                device="cpu"))[0]
    for t, w in zip(tree_flatten(tr.params)[0], want):
        np.testing.assert_allclose(t.numpy(), w.numpy(), atol=2e-3, rtol=0)
        assert float(((t - w).abs() > 1e-5).float().mean()) <= 1e-3
    assert len(tr.monitor.times) == steps


def test_train_launcher_refuses_cpu_unless_asked(monkeypatch, tmp_path):
    """The entry point runs on the card unless ``--device cpu`` is given,
    and the flags of later slices exit naming their ROADMAP item, while
    ``--offload-chunks`` and ``--ckpt-dir`` run.  The mesh flags run: ``--placement`` alone on one rank trains; ``--hp`` and
    ``--inner`` must fit the world; a world larger than the card count is
    refused on NCCL, naming the one-card gloo route."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--smoke", "--steps", "1"])
    for flag in (["--plan-file", "p.json"], ["--tune"]):
        with pytest.raises(SystemExit, match="ROADMAP"):
            tlaunch.main(["--smoke", "--device", "cpu", *flag])
    for flag in (["--offload-chunks", "2"],
                 ["--ckpt-dir", str(tmp_path / "c")]):
        losses = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "1",
                               "--seq-len", "16", "--global-batch", "2",
                               *flag])
        assert len(losses) == 1 and np.isfinite(losses[0])
    for flag in (["--hp", "2"], ["--inner", "2"]):
        with pytest.raises(ValueError, match="divide"):
            tlaunch.main(["--smoke", "--device", "cpu", *flag])
    losses = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "2",
                           "--seq-len", "16", "--global-batch", "2",
                           "--grad-accum", "2", "--placement",
                           "context_first"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(RuntimeError, match="chip_smoke.py"):
        tlaunch.main(["--smoke", "--hp", "2", "--inner", "2"])


def test_build_plan_covers_one_device_only():
    """One device plans without a process group; a ``pc`` whose device
    count differs from the world raises; every ZeRO mode plans, each at
    extent 1 (``zero`` None is ``"auto"``, which picks ``"replica"``
    here), ``describe()`` prints the zero, leaf-extents and memory lines,
    ``remat="auto"`` chooses the JAX ``build_plan``'s policy at the same
    budget, packed plans build, ``offload_chunks`` plans (the memory
    model's chunks, printed by ``describe()``), and tuned plans raise
    naming their item.  (Worlds of several
    ranks: ``test_torch_attention2d.py`` and ``test_torch_zero.py``.)"""
    cfg = get_reduced("olmo-1b")
    plan = build_plan(cfg, device="cpu", remat="full", grad_accum=2,
                      seq_len=16, global_batch=4)
    assert plan.cfg.remat == "full" and cfg.remat == "scpp"
    assert plan.data_config(16, 4).grad_accum == 2
    for frag in ("grad_accum=2", "zero        mode=replica extent=1",
                 "leaf extents", "memory/dev"):
        assert frag in plan.describe(), frag
    for zero in (None, "auto", "replica", "dp", "sp", "dp_sp", "pod_dp_sp"):
        p = build_plan(cfg, device="cpu", zero=zero)
        assert p.rt.mesh is None and p.mem["zero_extent"] == 1
        assert p.zero_mode == (zero if zero not in (None, "auto")
                               else "replica")
        assert all(not pl.axes for pl in p.zero.places)
    with pytest.raises(RuntimeError, match="not initialised"):
        build_plan(cfg, ParallelConfig(dp=2), device="cpu")
    policies = set()
    for gb in (0.0175, 0.02, 0.021, 0.05):
        kw = dict(remat="auto", grad_accum=2, seq_len=4096, global_batch=4,
                  memory_budget_gb=gb)
        want = j_build_plan(j_get_reduced("olmo-1b"),
                            devices=jax.devices()[:1], **kw).cfg.remat
        assert build_plan(cfg, device="cpu", **kw).cfg.remat == want, gb
        policies.add(want)
    assert policies == {"none", "scpp", "full"}
    assert build_plan(cfg, device="cpu", packed=True).packed
    p = build_plan(cfg, device="cpu", offload_chunks=2)
    assert p.offload_chunks == p.mem["offload_chunks"] == 2
    assert "offload     chunks=2 resident=1.00" in p.describe()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_plan(cfg, device="cpu", tuned=object())
    for kw in (dict(remat="some"), dict(zero="some")):
        with pytest.raises(ValueError):
            build_plan(cfg, device="cpu", **kw)
