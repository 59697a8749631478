"""Packed documents in the port (``PackedLM``, the packed plan, the model's
``doc_start`` path, the packed trainer and ``--pack``) against the JAX
package on the CPU.

``PackedLM``'s views are bit-equal to the reference's; a rank's shard is
its slice of the whole batch; the packed plan reads as the reference's;
reduced qwen3-1.7b's packed loss and grads match JAX ``forward_loss``
(1e-5) on the kernel path (``impl="plain"``: the fold, ``_FlashFolded``
and the kernels' plain versions with the doc table) and on the dense
oracle (``"auto"``), and equal K independent unpacked runs of the
documents, token-weighted, as ``tests/_dist_checks.py::
check_packed_parity`` defines them; three packed trainer steps match the
JAX packed ``Trainer`` by ``ROADMAP.md``'s rule for trainer params.  The
four-rank grids are in ``test_torch_zero.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro.configs import get_reduced as j_get_reduced
from repro.core.plan import build_plan as j_build_plan
from repro.core.topology import ParallelConfig as JParallelConfig
from repro.data import pipeline as jpipe
from repro.models.model import forward_loss as j_forward_loss
from repro.models.model import init_params as j_init_params
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core.plan import build_plan
from repro_torch.core.runtime import Runtime
from repro_torch.core.topology import ParallelConfig, rank_coords
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import forward_loss
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "qwen3-1.7b"
#: The model checks' packed batch: two sequences of 64 tokens, documents
#: of 10 to 38 tokens (the reference's check_packed_parity).
S, B, DOCS = 64, 2, (10, 38)


@pytest.mark.parametrize("kw", [
    dict(seq_len=64, global_batch=2),
    dict(seq_len=64, global_batch=4, grad_accum=2, cp=2,
         doc_len_range=DOCS),
    dict(seq_len=48, global_batch=3, cp=4, zigzag=False,
         doc_len_range=(2, 48)),
    dict(seq_len=96, global_batch=2, grad_accum=2, cp=4,
         doc_len_range=(8, 16), seed=5)], ids=lambda kw: str(kw["seq_len"]))
def test_packed_views_bit_identical(kw):
    """Batches (zigzag layout and microbatch split included), documents,
    boundaries and segments equal the reference's, over two steps and
    back (the one-entry caches)."""
    jsrc = jpipe.PackedLM(jpipe.DataConfig(vocab=97, **kw))
    tsrc = tpipe.PackedLM(tpipe.DataConfig(vocab=97, **kw))
    for step in (0, 1, 0):
        jb, tb = jsrc.batch(step), tsrc.batch(step)
        assert jb.keys() == tb.keys() and "doc_start" in tb
        for key in jb:
            assert jb[key].dtype == tb[key].dtype
            np.testing.assert_array_equal(jb[key], tb[key])
        assert tsrc.boundaries(step) == jsrc.boundaries(step)
        np.testing.assert_array_equal(tsrc.segments(step),
                                      jsrc.segments(step))
        for jd, td in zip(jsrc.documents(step), tsrc.documents(step)):
            assert len(jd) == len(td)
            for a, b in zip(jd, td):
                assert a.keys() == b.keys() and a["start"] == b["start"]
                for key in ("tokens", "labels", "positions"):
                    np.testing.assert_array_equal(a[key], b[key])


def test_sharded_packed_is_a_slice_of_the_batch():
    """On (dp, hp, outer, inner) = (2, 2, 1, 2), each rank's
    ``PackedLM`` batch is its ``rank_slices`` slice of the whole one, and
    the eight slices tile it: rows over data, the sequence over (outer,
    inner, head)."""
    pc = ParallelConfig(dp=2, hp=2, cp_outer=1, cp_inner=2)
    cfg = tpipe.DataConfig(vocab=97, seq_len=32, global_batch=4,
                           grad_accum=2, cp=pc.cp, doc_len_range=(4, 12))
    whole = tpipe.PackedLM(cfg).batch(1)
    cover = {k: np.zeros(v.shape, np.int64) for k, v in whole.items()}
    for r in range(pc.num_devices):
        shard = tpipe.rank_slices(cfg, pc, rank_coords(pc, r))
        got = tpipe.PackedLM(cfg, shard=shard).batch(1)
        rows, piece = shard
        for k, v in whole.items():
            np.testing.assert_array_equal(got[k], v[..., rows, piece])
            cover[k][..., rows, piece] += 1
    for v in cover.values():
        assert (v == 1).all()


def test_packed_plan_matches_jax():
    """``packing_frac``, ``data_config().doc_len_range`` (around
    ``mean_doc_len``, clamped to the sequence) and the packing line of
    ``describe()`` equal the JAX plan's; the data source is
    ``PackedLM``."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    for seq, mean in ((128, 32), (64, 200), (256, None)):
        kw = dict(seq_len=seq, global_batch=4, packed=True,
                  mean_doc_len=mean)
        jp = j_build_plan(jcfg, JParallelConfig(), devices=jax.devices()[:1],
                          impl="ref", **kw)
        tp = build_plan(tcfg, device="cpu", **kw)
        assert tp.packing_frac == jp.packing_frac
        assert tp.data_config(seq, 4).doc_len_range == \
            jp.data_config(seq, 4).doc_len_range
        line = [x for x in jp.describe().splitlines() if "packing" in x]
        assert line and line[0] in tp.describe().splitlines()
        assert isinstance(tp.data_source(seq, 4), tpipe.PackedLM)
    off = build_plan(tcfg, device="cpu", seq_len=64, global_batch=2)
    assert off.packing_frac == 1.0 and "  packing     off" in off.describe()
    assert isinstance(off.data_source(64, 2), tpipe.SyntheticLM)


@pytest.fixture(scope="module")
def packed_model():
    """Reduced qwen3-1.7b's JAX params, the port's copy, one packed batch
    and JAX's loss and grads on it (``impl="ref"``)."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    data = tpipe.PackedLM(tpipe.DataConfig(vocab=tcfg.vocab, seq_len=S,
                                           global_batch=B,
                                           doc_len_range=DOCS))
    batch = data.batch(0)
    plan = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, plan.rt, jcfg), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, batch))
    want = tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu"))[0]
    return tcfg, tparams, data, batch, float(jl), want


def _loss_grads(params, batch, cfg, impl):
    leaves, spec = tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, _ = forward_loss(tree_unflatten(leaves, spec), tb,
                           Runtime(impl=impl, device="cpu"), cfg)
    return loss.item(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("impl", ["plain", "auto"])
def test_packed_loss_and_grads_match_jax(packed_model, impl):
    """The packed batch's loss and every grad leaf against
    ``jax.value_and_grad(forward_loss)`` on the same batch, fp32, 1e-5:
    the kernel path with the doc table (``plain``) and the dense oracle
    (``auto`` on the CPU)."""
    cfg, params, _, batch, jl, want = packed_model
    loss, grads = _loss_grads(params, batch, cfg, impl)
    np.testing.assert_allclose(loss, jl, **TOL)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_packed_equals_independent_documents(packed_model):
    """One packed batch of K documents gives the loss and grads of K
    unpacked runs, one a document, weighted by its valid tokens (the
    reference's ``check_packed_parity``), fp32, 1e-5, on the kernel
    path, with more documents than sequences."""
    cfg, params, data, batch, _, _ = packed_model
    loss_p, grads_p = _loss_grads(params, batch, cfg, "plain")
    docs = [d for seq in data.documents(0) for d in seq]
    assert len(docs) > B
    total, loss_acc, grad_acc = 0.0, 0.0, None
    for d in docs:
        db = {k: d[k][None] for k in ("tokens", "labels", "positions")}
        loss_d, grads_d = _loss_grads(params, db, cfg, "plain")
        n = float((d["labels"] >= 0).sum())
        total += n
        loss_acc += n * loss_d
        grads_d = [n * g.double() for g in grads_d]
        grad_acc = grads_d if grad_acc is None else [
            a + g for a, g in zip(grad_acc, grads_d)]
    assert abs(loss_p - loss_acc / total) < 1e-5
    for a, b in zip(grads_p, grad_acc):
        b = (b / total).float()
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        assert err < 1e-5, err


def test_packed_trainer_matches_jax_trainer():
    """Three packed steps (grad_accum 2, token-weighted over bins of
    unequal padding, lr 1e-2) from the JAX trainer's initial params: the
    JAX packed ``Trainer``'s losses within 1e-5, its params within 1e-5 on
    at least 99.9% of each leaf and within 2e-3 on all."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    seq, gb, steps = 32, 4, 3
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=steps)
    pk = dict(grad_accum=2, seq_len=seq, global_batch=gb, packed=True,
              mean_doc_len=8)
    jplan = j_build_plan(jcfg, JParallelConfig(), jopt.OptConfig(**kw),
                         devices=jax.devices()[:1], impl="ref", **pk)
    jtr = jtrainer.Trainer(jplan, jplan.data_config(seq, gb),
                           jtrainer.TrainerConfig(num_steps=steps,
                                                  log_every=1))
    try:
        assert isinstance(jtr.data, jpipe.PackedLM)
        init = jax.tree.map(np.array, jtr.params)
        jlosses = jtr.run()
        jfinal = jax.tree.map(np.array, jtr.params)
    finally:
        jtr.guard.uninstall()
    plan = build_plan(tcfg, opt=topt.OptConfig(**kw), device="cpu",
                      impl="plain", **pk)
    tr = Trainer(plan, plan.data_config(seq, gb),
                 TrainerConfig(num_steps=steps, log_every=1))
    assert isinstance(tr.data, tpipe.PackedLM)
    tr.params = convert.from_jax_params(init, tcfg, device="cpu")
    tr.opt_state = topt.init_opt_state(tr.params)
    losses = tr.run()
    np.testing.assert_allclose(losses, jlosses, **TOL)
    want = tree_flatten(convert.from_jax_params(jfinal, tcfg,
                                                device="cpu"))[0]
    for t, w in zip(tree_flatten(tr.params)[0], want):
        np.testing.assert_allclose(t.numpy(), w.numpy(), atol=2e-3, rtol=0)
        assert float(((t - w).abs() > 1e-5).float().mean()) <= 1e-3


def test_pack_launcher_trains(capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu --pack
    --steps 2`` (its ``main``): a packed plan, finite losses; an explicit
    ``--mean-doc-len`` reaches the plan."""
    losses = tlaunch.main(["--smoke", "--device", "cpu", "--pack",
                           "--steps", "2"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "packing     on mean_doc=32 frac=0.250" in out
    plan, tr = tlaunch.make_trainer(tlaunch.parse_args(
        ["--smoke", "--device", "cpu", "--pack", "--mean-doc-len", "16",
         "--steps", "1"]))
    assert plan.packed and plan.mean_doc_len == 16
    assert tr.data.cfg.doc_len_range == (8, 32)
    assert dataclasses.replace(tr.data.cfg, doc_len_range=None) == \
        dataclasses.replace(plan.data_config(128, 2), doc_len_range=None)
