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


def test_train_launcher_refuses_cpu_unless_asked():
    """The entry point runs on the card unless ``--device cpu`` is given,
    and the flags of later slices exit naming their ROADMAP item."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--smoke", "--steps", "1"])
    for flag in (["--hp", "2"], ["--pack"], ["--offload-chunks", "2"],
                 ["--plan-file", "p.json"], ["--tune"], ["--ckpt-dir", "c"],
                 ["--inner", "2"], ["--placement", "context_first"]):
        with pytest.raises(SystemExit, match="ROADMAP"):
            tlaunch.main(["--smoke", "--device", "cpu", *flag])
    losses = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "2",
                           "--seq-len", "16", "--global-batch", "2",
                           "--grad-accum", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_build_plan_covers_one_device_only():
    cfg = get_reduced("olmo-1b")
    plan = build_plan(cfg, device="cpu", remat="full", grad_accum=2,
                      seq_len=16, global_batch=4)
    assert plan.cfg.remat == "full" and cfg.remat == "scpp"
    assert plan.data_config(16, 4).grad_accum == 2
    assert "grad_accum=2" in plan.describe()
    for kw in (dict(pc=ParallelConfig(dp=2)), dict(zero="dp"),
               dict(remat="auto"), dict(packed=True),
               dict(offload_chunks=2), dict(tuned=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_plan(cfg, device="cpu", **kw)
    with pytest.raises(ValueError):
        build_plan(cfg, device="cpu", remat="some")
