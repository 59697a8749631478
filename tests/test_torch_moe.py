"""The port's MoE family (``repro_torch.models.moe`` and reduced
qwen3-moe-30b-a3b) against the JAX package on the CPU, one process.

* ``moe_apply`` on one device: capacity factor 8.0 (no drops) and 0.5
  (drops), with and without a shared expert, with and without
  ``norm_topk``: y, the aux and the router / expert / shared grads within
  1e-5 norm-relative.  The inputs leave a margin between each token's
  k-th and (k+1)-th probability, so a mismatch is a fault and not a tie.
* reduced qwen3-moe-30b-a3b: ``forward_loss`` and its grads in fp32 under
  each remat mode (loss 1e-5 relative, each leaf 1e-4 norm-relative), the
  bf16 cast's dtype of every leaf, three trainer steps (by
  ``test_torch_trainer.py``'s rule), prefill and greedy decode, a
  checkpoint byte for byte against JAX's files, the ``convert`` round
  trip and ``decay_mask`` on the full config's tree (``jax.eval_shape``),
  and both launchers.  ``ref_param_shapes``, ``param_count``, the ZeRO
  specs and ``plan_memory`` at full size are in ``test_torch_zero.py``;
  the four-rank cases in ``test_torch_runtime_mesh.py``.

Both sides start from the same weights (the reference's tree drawn with
numpy, through ``convert.from_jax_params``); the port runs its attention
through the kernels' plain versions (``impl="plain"``).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import plan as jplan_mod
from repro.core.plan import build_plan as j_build_plan
from repro.core.topology import ParallelConfig as JParallelConfig
from repro.launch import serve as jserve
from repro.models import decode as jdecode
from repro.models import moe as jmoe
from repro.models.model import cast_params_once as j_cast_params_once
from repro.models.model import forward_loss as j_forward_loss
from repro.train import optimizer as jopt
from repro.runtime import checkpoint as jckpt
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.plan import build_plan
from repro_torch.core.runtime import Runtime
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import decode as tdecode
from repro_torch.models import moe as tmoe
from repro_torch.models.model import (REMAT, cast_params_once, forward_loss,
                                      init_params, require_ported)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_grad_fn
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

ARCH = "qwen3-moe-30b-a3b"
B, S = 2, 32
GEN = 5
SEQ, GB, STEPS = 32, 4, 3
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=STEPS)
CPU = Runtime(impl="plain", device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _random_tree(jcfg, seed: int):
    """numpy leaves of the reference's tree for ``jcfg``, drawn from a
    seed (the JAX initializer alone would compile for seconds): linear
    weights, the router and the experts N(0, d_in^-0.5) (``d_in`` the
    next-to-last dim of the stacked leaf), the rest N(0, 0.02), so the
    norm weights are nonzero too."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = path[-1].key
        std = x.shape[-2] ** -0.5 if (key == "w" and len(x.shape) == 3) \
            or key in ("router", "w1", "w2", "w3") else 0.02
        return (std * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jplan_mod._params_struct(jcfg))


@pytest.fixture(scope="module")
def pair():
    """The reduced config on both sides, the initial params (numpy, the
    reference's tree) and the port's copy, the JAX one-device runtime and
    its jitted ``value_and_grad`` of ``forward_loss``."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jparams = _random_tree(jcfg, 0)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    plan = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref")
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, plan.rt, jcfg), has_aux=True))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jrt=plan.rt, jgrad=jgrad)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _moe_inputs(m, seed: int = 3):
    """The reference's init (numpy leaves) and x ``(B, S, D)``."""
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), m))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, m.d_model)).astype(np.float32)
    return p, x


def _port_moe(p, m):
    """The reference's MoE leaves in the port's layout (the shared GLU's
    linear weights transposed), each requiring grad."""
    t = {k: torch.from_numpy(np.array(p[k])).requires_grad_()
         for k in ("router", "w1", "w3", "w2")}
    if m.n_shared:
        t["shared"] = {k: {"w": torch.from_numpy(np.array(
            p["shared"][k]["w"]).T.copy()).requires_grad_()}
            for k in ("w1", "w3", "w2")}
    return t


@pytest.mark.parametrize("cf,n_shared", [(8.0, 0), (8.0, 1), (0.5, 0),
                                         (0.5, 1)])
def test_moe_apply_matches_jax(pair, cf, n_shared):
    """y, the aux and every grad of ``sum(y * w) + aux`` within 1e-5
    norm-relative of the reference's, with ``norm_topk`` on and off; at
    capacity factor 0.5 some assignments are dropped, at 8.0 none."""
    for norm_topk in (True, False):
        kw = dict(d_model=64, n_experts=8, top_k=2, d_ff=64,
                  capacity_factor=cf, n_shared=n_shared, norm_topk=norm_topk)
        jm, tm = jmoe.MoEDims(**kw), tmoe.MoEDims(**kw)
        p, x = _moe_inputs(jm)
        w = np.random.default_rng(4).standard_normal(x.shape).astype(
            np.float32)
        probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, 64))
                               @ jnp.asarray(p["router"]), axis=-1)
        top = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
        assert (top[:, 1] - top[:, 2]).min() > 1e-4   # no near-tie at k

        def jf(p, x):
            y, aux = jmoe.moe_apply(p, x, pair["jrt"], jm)
            return (y * w).sum() + aux, (y, aux)

        (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        tp = _port_moe(p, tm)
        tmoe.DROPS = []
        try:
            y, aux = tmoe.moe_apply(tp, torch.from_numpy(x), CPU, tm)
            ((y * torch.from_numpy(w)).sum() + aux).backward()
            dropped = int(tmoe.DROPS[0][0])
        finally:
            tmoe.DROPS = None
        assert tmoe.capacity(B * S, tm) == max(4, int(np.ceil(
            B * S * 2 * cf / 8)))
        assert (dropped > 0) == (cf < 1), dropped
        assert _rel(y.detach(), jy) < 1e-5
        assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
        for k in ("router", "w1", "w3", "w2"):
            assert _rel(tp[k].grad, jg[k]) < 1e-5, (k, norm_topk)
        if n_shared:
            for k in ("w1", "w3", "w2"):
                assert _rel(tp["shared"][k]["w"].grad.T,
                            jg["shared"][k]["w"]) < 1e-5, k


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

def _batch(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": labels,
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy()}


@pytest.fixture(scope="module")
def jax_loss(pair):
    batch = _batch(pair["tcfg"].vocab)
    (loss, m), g = pair["jgrad"](pair["jparams"],
                                 jax.tree.map(jnp.asarray, batch))
    want = tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, g), pair["tcfg"], device="cpu"))[0]
    return batch, float(loss), float(m["aux"]), want


@pytest.mark.parametrize("remat", REMAT)
def test_reduced_model_matches_jax(pair, jax_loss, remat):
    """``forward_loss`` (aux included) within 1e-5 relative and every grad
    leaf within 1e-4 norm-relative of ``jax.value_and_grad``, under each
    remat mode."""
    batch, jl, jaux, want = jax_loss
    cfg = dataclasses.replace(pair["tcfg"], remat=remat)
    leaves, spec = tree_flatten(pair["tparams"])
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    loss, metrics = forward_loss(
        torch.utils._pytree.tree_unflatten(leaves, spec),
        {k: torch.from_numpy(v).long() for k, v in batch.items()}, CPU, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - jl) <= 1e-5 * abs(jl)
    assert float(metrics["aux"]) > 0
    assert abs(float(metrics["aux"]) - jaux) <= 1e-5 * jaux
    assert len(grads) == len(want)
    for g, w, path in zip(grads, want, convert.tree_paths(pair["tparams"])):
        assert g.shape == w.shape, path
        assert _rel(g, w) < 1e-4, path


def test_bf16_cast_matches_jax(pair):
    """In bf16 every leaf's dtype is the reference's ``cast_params_once``'s:
    the router and the experts (two dims or more) and the stacked norm
    weights cast, ``final_norm`` kept fp32; ``init_params(cast=True)``
    gives the same tree bit for bit."""
    jcfg = dataclasses.replace(pair["jcfg"], dtype="bfloat16")
    tcfg = dataclasses.replace(pair["tcfg"], dtype="bfloat16")
    jcast = j_cast_params_once(pair["jparams"], jcfg)
    tcast = cast_params_once(pair["tparams"], tcfg)
    seen = set()
    for ref, x in zip(convert.ref_leaf_map(tcfg), tree_flatten(tcast)[0]):
        leaf = jcast
        for k in ref.path:
            leaf = leaf[k]
        want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 else torch.float32
        assert x.dtype == want, ref.path
        seen.add((ref.path[-1], x.dtype))
    assert {("router", torch.bfloat16), ("w1", torch.bfloat16),
            ("w", torch.float32)} <= seen
    # the serving init casts each layer as it is drawn: the same tree
    lazy = init_params(tcfg, torch.Generator().manual_seed(3), cast=True)
    eager = cast_params_once(init_params(
        tcfg, torch.Generator().manual_seed(3)), tcfg)
    for a, b in zip(tree_flatten(lazy)[0], tree_flatten(eager)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Trainer and checkpoint
# ---------------------------------------------------------------------------

def _plan():
    return build_plan(get_reduced(ARCH), opt=topt.OptConfig(**OPT),
                      device="cpu", impl="plain", grad_accum=2, seq_len=SEQ,
                      global_batch=GB)


def _as_jax(params, opt_state, cfg) -> dict:
    """A port trainer state as the reference's tree of numpy leaves."""
    return jax.tree.map(np.array, {
        "params": convert.to_jax_params(params, cfg),
        "opt": {"m": convert.to_jax_params(opt_state["m"], cfg),
                "v": convert.to_jax_params(opt_state["v"], cfg),
                "step": np.asarray(opt_state["step"], np.int32)}})


@pytest.fixture(scope="module")
def port_run(pair):
    """Three steps of the port's ``Trainer`` (grad_accum 2, lr 1e-2) from
    the JAX initial params, each step's state before it and batch
    recorded, and the state after the last."""
    tcfg = pair["tcfg"]
    plan = _plan()
    tr = Trainer(plan, plan.data_config(SEQ, GB),
                 TrainerConfig(num_steps=STEPS, log_every=1))
    tr.params = convert.from_jax_params(
        jax.tree.map(np.asarray, pair["jparams"]), tcfg, device="cpu")
    tr.opt_state = topt.init_opt_state(tr.params)
    seen, step_fn = [], tr.step_fn

    def recorded(params, opt_state, batch):
        seen.append((_as_jax(params, opt_state, tcfg),
                     {k: v.numpy() for k, v in batch.items()}))
        return step_fn(params, opt_state, batch)

    tr.step_fn = recorded
    losses = tr.run()
    return dict(plan=plan, seen=seen, losses=losses, tr=tr,
                final=_as_jax(tr.params, tr.opt_state, tcfg))


def _jax_step(grad_of, params, batch):
    """The reference step's loss and grads: ``grad_of`` (``value_and_grad``
    of its loss) on each microbatch, each weighted by its valid-token
    count, summed and divided by the total
    (``src/repro/train/train_step.py``), at ``params`` (the reference's
    tree)."""
    total, loss, acc = 0.0, 0.0, None
    for i in range(batch["tokens"].shape[0]):
        (li, m), g = grad_of(params, {k: jnp.asarray(v[i])
                                      for k, v in batch.items()})
        n = float(m["n_tokens"])
        acc = jax.tree.map(lambda x: np.asarray(x) * n, g) if acc is None \
            else jax.tree.map(lambda a, x: a + np.asarray(x) * n, acc, g)
        total, loss = total + n, loss + float(li) * n
    return loss / total, jax.tree.map(lambda x: x / total, acc)


def test_trainer_matches_jax_step(pair, port_run):
    """Three steps of the port's ``Trainer`` against the reference's step
    at the same params and batch: each step's loss (the aux included)
    within 1e-5, every grad leaf within 1e-4 norm-relative of the token-
    weighted grads, and the update the reference's ``adamw_update`` makes
    of the port's grads within 1e-6 of the port's update.

    The step is held to the reference one step at a time because Adam
    turns last-bit grad differences on elements whose grad is near zero
    (a token first seen at step 1) into steps of either sign: after three
    steps one embedding element ends 3.3e-3 from the JAX trainer's, past
    ``test_torch_trainer.py``'s 2e-3, while the grads of its row agree to
    1.5e-6 (ROADMAP.md section 3)."""
    tcfg, seen = pair["tcfg"], port_run["seen"]
    assert len(seen) == STEPS
    losses = port_run["losses"]
    assert losses[0] != losses[-1]
    grads_of = make_grad_fn(port_run["plan"])
    j_update = jax.jit(jopt.adamw_update, static_argnums=3)
    spec = tree_flatten(port_run["tr"].params)[1]
    for i, (before, batch) in enumerate(seen):
        loss, want = _jax_step(pair["jgrad"], before["params"], batch)
        assert abs(losses[i] - loss) <= 1e-5 * abs(loss), i
        _, grads = grads_of(
            convert.from_jax_params(before["params"], tcfg, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        for g, w, path in zip(grads, tree_flatten(convert.from_jax_params(
                want, tcfg, device="cpu"))[0], convert.tree_paths(
                    port_run["tr"].params)):
            assert _rel(g, w) < 1e-4, path
        after = seen[i + 1][0] if i + 1 < STEPS else port_run["final"]
        grads = convert.to_jax_params(
            torch.utils._pytree.tree_unflatten(grads, spec), tcfg)
        jp, js, _ = j_update(before["params"], grads,
                             dict(before["opt"],
                                  step=jnp.int32(before["opt"]["step"])),
                             jopt.OptConfig(**OPT))
        got = [after["params"], after["opt"]["m"], after["opt"]["v"]]
        for a, b in zip(jax.tree.leaves(got),
                        jax.tree.leaves([jp, js["m"], js["v"]])):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6,
                                       rtol=1e-6)


def test_checkpoint_files_match_jax(port_run, tmp_path):
    """JAX's ``save`` writes the port trainer's final state under the
    reference's one-device plan; the port restores it and saves it
    again: the manifest field for field and every ``.npy`` file (the
    stacked router and experts included) byte for byte."""
    jplan = j_build_plan(j_get_reduced(ARCH), JParallelConfig(),
                         jopt.OptConfig(**OPT), devices=jax.devices()[:1],
                         impl="ref", grad_accum=2, seq_len=SEQ,
                         global_batch=GB)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(port_run["final"], STEPS, jdir, plan=jplan)
    plan = port_run["plan"]
    tr = Trainer(plan, plan.data_config(SEQ, GB),
                 TrainerConfig(num_steps=STEPS))
    state, step = ckpt.CheckpointManager(jdir, plan=plan).restore(
        {"params": tr.params, "opt": tr.opt_state}, step=STEPS)
    assert step == STEPS
    ckpt.CheckpointManager(tdir, plan=plan).save(state, STEPS)
    assert ckpt.read_manifest(tdir) == jckpt.read_manifest(jdir)
    paths = [e["path"] for e in ckpt.read_manifest(tdir)["leaves"]]
    assert "['params']['blocks'][0]['moe']['w2']" in paths
    name = f"step_{STEPS:08d}"
    want = sorted(os.listdir(os.path.join(jdir, name)))
    assert sorted(os.listdir(os.path.join(tdir, name))) == want
    for n in want:
        with open(os.path.join(jdir, name, n), "rb") as a, \
                open(os.path.join(tdir, name, n), "rb") as b:
            assert a.read() == b.read(), n


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def test_prefill_and_greedy_decode_match_jax(pair):
    """Prefill's last-token logits and caches, one decode step
    (``seq_sharded=False``) within 1e-5, and greedy generation token for
    token, against the reference's fixed-batch path."""
    jcfg, tcfg = pair["jcfg"], pair["tcfg"]
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab, (B, 24))
    jpf, jstep, _ = jserve.make_generate_fns(jcfg, pair["jrt"])
    jl, jc = jpf(pair["jparams"], {"tokens": jnp.asarray(tokens, jnp.int32)})
    rt = Runtime(impl="auto", device="cpu")
    with torch.inference_mode():
        tl, tc = tdecode.prefill(pair["tparams"],
                                 {"tokens": torch.from_numpy(tokens)}, rt,
                                 tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(jax.tree.leaves(convert.caches_to_numpy(tc)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
    jl2, _ = jstep(pair["jparams"], jdecode.grow_caches(jcfg, jc, GEN),
                   jnp.asarray(tok, jnp.int32), jnp.int32(24))
    with torch.inference_mode():
        tl2, _ = tdecode.decode_step(pair["tparams"],
                                     tdecode.grow_caches(tcfg, tc, GEN),
                                     torch.from_numpy(tok), 24, rt, tcfg)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-5,
                               rtol=1e-5)
    jt = jserve.generate(pair["jparams"], jcfg, pair["jrt"],
                         jnp.asarray(tokens, jnp.int32), gen=GEN,
                         fns=(jpf, jstep, {"prefill": 0, "decode": 0}))
    tt = tserve.generate(pair["tparams"], tcfg, rt, torch.from_numpy(tokens),
                         gen=GEN)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ---------------------------------------------------------------------------
# Parameter bookkeeping, the registry and the launchers
# ---------------------------------------------------------------------------

def test_convert_round_trip_and_decay_mask(pair):
    """``to_jax_params`` inverts ``from_jax_params`` bit for bit (reduced
    qwen3-moe, and a variant with a shared expert, whose GLU weights are
    transposed and the experts not); on the full config's tree (shapes
    from ``jax.eval_shape``, nothing allocated) ``decay_mask`` decays
    exactly the reference's leaves of two dims or more, and the full
    config equals the reference's field for field."""
    shared = dataclasses.replace(
        pair["jcfg"], moe=dataclasses.replace(pair["jcfg"].moe, n_shared=1))
    tshared = dataclasses.replace(
        pair["tcfg"], moe=tmoe.MoEDims(**dataclasses.asdict(shared.moe)))
    for jcfg, tcfg, tree in (
            (pair["jcfg"], pair["tcfg"], pair["jparams"]),
            (shared, tshared, _random_tree(shared, 1))):
        tree = jax.tree.map(np.asarray, tree)
        back = convert.to_jax_params(
            convert.from_jax_params(tree, tcfg, device="cpu"), tcfg)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    refs = dict(zip((path for path, _ in convert.port_leaves(tshared)),
                    convert.ref_leaf_map(tshared)))
    assert refs["layers", 0, "moe", "shared", "w1", "w"].transposed
    assert not refs["layers", 0, "moe", "w1"].transposed
    jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        if f.name == "moe":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    struct = {tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in p): x.ndim
              for p, x in jax.tree_util.tree_flatten_with_path(
                  jplan_mod._params_struct(jcfg))[0]}
    mask = convert.decay_mask(tcfg)
    assert mask == [struct[r.path] >= 2 for r in convert.ref_leaf_map(tcfg)]
    assert convert.param_count(tcfg) == jplan_mod._param_count(jcfg)


def test_registry_and_launchers(capsys):
    """``get_config`` / ``get_reduced`` give the arch, the one pending
    architecture still raises naming its ROADMAP item (MLA naming
    deepseek-v2-lite), every family of the reference is admitted and an
    unknown one refused, and both launchers run the reduced MoE on the
    CPU: two trainer steps with finite losses, and a fixed-batch
    generate."""
    assert get_config(ARCH).family == get_reduced(ARCH).family == "moe"
    for name in ("deepseek-v2-lite-16b",):
        with pytest.raises(NotImplementedError, match="item 9"):
            get_config(name)
    with pytest.raises(NotImplementedError, match="deepseek-v2-lite"):
        require_ported(dataclasses.replace(get_reduced(ARCH), mla=object()))
    require_ported(dataclasses.replace(get_reduced(ARCH), family="encdec"))
    with pytest.raises(ValueError, match="unknown family"):
        require_ported(dataclasses.replace(get_reduced(ARCH),
                                           family="conv"))
    losses = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "2", "--seq-len", "32",
                           "--global-batch", "2", "--grad-accum", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "qwen3-moe-smoke [moe]" in out
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--prompt-len", "16", "--gen", "3"])
    assert "generated 6 tokens" in capsys.readouterr().out
