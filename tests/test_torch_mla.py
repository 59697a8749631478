"""The port's MLA attention (``attention_block.mla_apply``, the absorbed
decode) and deepseek-v2-lite-16b (reduced) against the JAX package on the
CPU, one process.

* ``mla_apply`` and its grads (q / k of ``d_qk`` = 24, padded to 32 by the
  kernel path; V of ``d_v`` = 16 zero-padded to 24; one shared rope key
  head broadcast to the 4 heads), with and without a packed
  ``doc_start``, against the reference's on Pallas interpret mode: y
  within 2e-5 norm-relative, grads atol 5e-4 / rtol 1e-3;
* ``moe_apply`` with two shared experts and ``norm_topk=False``, at
  capacity factor 8.0 (no drops) and 0.5 (drops): y, the aux and the
  grads within 1e-5 norm-relative;
* the reduced model: ``forward_loss`` within 1e-5 and every grad leaf
  within 1e-4 norm-relative of ``jax.value_and_grad``'s under each remat
  mode; the bf16 cast tree leaf for leaf and ``init_params(cast=True)``;
  prefill logits and the ``{c, rope}`` caches, then the absorbed decode,
  within 1e-5 of the reference's, and the decode equal to a prefill of
  the longer prompt; the trainer held step by step to the reference
  step; a checkpoint JAX wrote, restored and written again byte for
  byte;
* on the full config (shapes only): ``convert``'s shapes, ``param_count``
  and ``decay_mask`` against the reference's tree, ``plan_memory`` and
  the ZeRO places of the MLA leaves; the registry and both launchers.

The four-rank case (reduced deepseek's ``dp_sp`` step on (1, 2, 1, 2):
Ulysses, the ring and EP over head and inner) is in
``test_torch_runtime_mesh.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import plan as jplan_mod
from repro.core.plan import build_plan as j_build_plan
from repro.core.topology import ParallelConfig as JParallelConfig
from repro.models import attention_block as jattn
from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.model import cast_params_once as j_cast_params_once
from repro.models.model import forward_loss as j_forward_loss
from repro.runtime import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import PENDING, get_config, get_reduced
from repro_torch.core import plan as tplan
from repro_torch.core import zero as tzero
from repro_torch.core.runtime import Runtime
from repro_torch.core.topology import ParallelConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention_block as tattn
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.model import (REMAT, cast_params_once, forward_loss,
                                      init_params, require_ported)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_grad_fn
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"
B, S = 2, 32
SEQ, GB, STEPS = 32, 4, 3
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=STEPS)
CPU = Runtime(impl="plain", device="cpu")
#: a packed table: three documents a row, starts not on a tile edge
DOC = np.repeat(np.array([0, 9, 21]), [9, 12, 11])[None].repeat(B, 0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


NORMS = ("ln1", "ln2", "kv_norm", "final_norm")


def _random_tree(struct, seed: int):
    """numpy leaves of a reference tree of shapes, drawn from a seed:
    linear weights, the router and the experts N(0, d_in^-0.5) (``d_in``
    the next-to-last dim), the rest (the norm weights and the embedding)
    N(0, 0.02), so the norm weights are nonzero too."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = path[-1].key
        linear = key == "w" and len(x.shape) >= 2 and \
            path[-2].key not in NORMS
        std = x.shape[-2] ** -0.5 if linear or key in (
            "router", "w1", "w2", "w3") else 0.02
        return (std * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, struct)


def _batch(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": labels,
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy()}


@pytest.fixture(scope="module")
def pair():
    """The reduced config on both sides, the initial params (numpy, the
    reference's tree) and the port's copy, the JAX one-device runtime and
    its jitted ``value_and_grad`` of ``forward_loss`` (its value does not
    depend on its remat; ``full`` compiles fastest)."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jparams = _random_tree(jplan_mod._params_struct(jcfg), 0)
    tparams = convert.from_jax_params(jparams, tcfg, device="cpu")
    plan = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref")
    jfull = dataclasses.replace(jcfg, remat="full")
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, plan.rt, jfull), has_aux=True))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jrt=plan.rt, jgrad=jgrad)


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jmla(pair):
    """The reference's ``mla_apply`` on Pallas interpret mode at the
    reduced dims, its params and inputs drawn from seeds, and one jitted
    ``value_and_grad`` of ``sum(y * w)`` that takes the doc table as an
    argument (an all-zero table is one document a row, so both cases
    share one compile)."""
    jm = pair["jcfg"].mla
    d = pair["jcfg"].d_model
    rt = j_build_plan(pair["jcfg"], devices=jax.devices()[:1],
                      impl="pallas_interpret").rt
    p = _random_tree(jax.eval_shape(lambda: jattn.init_mla(
        jax.random.PRNGKey(0), d, jm)), 2)
    p["kv_norm"]["w"] = p["kv_norm"]["w"] * 10.0
    rng = np.random.default_rng(3)
    x, w = (rng.standard_normal((B, S, d)).astype(np.float32)
            for _ in range(2))
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    cos, sin = jlayers.rotary_cos_sin(jnp.asarray(positions), jm.d_rope)

    def jf(p, x, doc):
        y = jattn.mla_apply(p, x, cos, sin, rt, jattn.AttnKind(), jm,
                            doc_start=doc)
        return (y * w).sum(), y

    grad = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))
    return dict(p=p, x=x, w=w, positions=positions, grad=grad)


@pytest.mark.parametrize("packed", [False, True])
def test_mla_apply_matches_jax(pair, jmla, packed):
    """``mla_apply`` at the reduced dims (4 heads, d_qk 24, d_v 16, a
    32-wide latent) over 32 tokens, and the grads of ``sum(y * w)`` with
    respect to every leaf and x, through the port's kernel path (fold, pad
    to 32, the plain versions; unpacked with no doc table) against the
    reference's Pallas kernels in interpret mode: y within 2e-5
    norm-relative, grads atol 5e-4 / rtol 1e-3 (the reference suite's
    kernel bounds)."""
    tm = tattn.MLADims(**dataclasses.asdict(pair["jcfg"].mla))
    assert (tm.d_qk, tm.d_v, tm.n_heads) == (24, 16, 4)
    p, x, w = jmla["p"], jmla["x"], jmla["w"]
    assert sorted(p) == ["kv_down", "kv_norm", "kv_up", "wo", "wq"]
    doc = DOC.astype(np.int32) if packed else None
    (_, jy), (jgp, jgx) = jmla["grad"](
        p, x, doc if packed else np.zeros_like(DOC, np.int32))
    leaves = {n: {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v)
                  .requires_grad_() for k, v in lp.items()}
              for n, lp in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tcos, tsin = tlayers.rotary_cos_sin(
        torch.from_numpy(jmla["positions"].copy()), tm.d_rope)
    y = tattn.mla_apply(leaves, tx, tcos, tsin, CPU, tattn.AttnKind(), tm,
                        doc_start=None if doc is None
                        else torch.from_numpy(doc))
    (y * torch.from_numpy(w)).sum().backward()
    assert _rel(y.detach(), jy) < 2e-5
    got = [tx.grad] + [leaves[n][k].grad.T if leaves[n][k].ndim == 2
                       else leaves[n][k].grad
                       for n in sorted(p) for k in sorted(p[n])]
    want = [jgx] + [jgp[n][k] for n in sorted(p) for k in sorted(p[n])]
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=5e-4,
                                   rtol=1e-3)


def test_moe_two_shared_experts_matches_jax(pair):
    """``moe_apply`` as deepseek-v2-lite routes (two shared experts: one
    GLU of twice ``d_ff``; ``norm_topk=False``) at capacity factor 8.0 (no
    drops) and 0.5 (drops): y, the aux and the router / expert / shared
    grads of ``sum(y * w) + aux`` within 1e-5 norm-relative."""
    for cf in (8.0, 0.5):
        kw = dict(d_model=64, n_experts=8, top_k=2, d_ff=64,
                  capacity_factor=cf, n_shared=2, norm_topk=False)
        jm, tm = jmoe.MoEDims(**kw), tmoe.MoEDims(**kw)
        p = _random_tree(jax.eval_shape(lambda: jmoe.init_moe(
            jax.random.PRNGKey(0), jm)), 4)
        assert p["shared"]["w1"]["w"].shape == (64, 128)
        rng = np.random.default_rng(5)
        x, w = (rng.standard_normal((B, S, 64)).astype(np.float32)
                for _ in range(2))

        def jf(p, x):
            y, aux = jmoe.moe_apply(p, x, pair["jrt"], jm)
            return (y * w).sum() + aux, (y, aux)

        (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
            jf, has_aux=True))(p, x)
        tp = {k: torch.from_numpy(p[k]).requires_grad_()
              for k in ("router", "w1", "w3", "w2")}
        tp["shared"] = {k: {"w": torch.from_numpy(
            p["shared"][k]["w"].T.copy()).requires_grad_()}
            for k in ("w1", "w3", "w2")}
        tmoe.DROPS = []
        try:
            y, aux = tmoe.moe_apply(tp, torch.from_numpy(x), CPU, tm)
            ((y * torch.from_numpy(w)).sum() + aux).backward()
            dropped = int(tmoe.DROPS[0][0])
        finally:
            tmoe.DROPS = None
        assert (dropped > 0) == (cf < 1), dropped
        assert _rel(y.detach(), jy) < 1e-5
        assert abs(aux.item() - float(jaux)) <= 1e-5 * abs(float(jaux))
        for k in ("router", "w1", "w3", "w2"):
            assert _rel(tp[k].grad, jg[k]) < 1e-5, (k, cf)
        for k in ("w1", "w3", "w2"):
            assert _rel(tp["shared"][k]["w"].grad.T,
                        jg["shared"][k]["w"]) < 1e-5, (k, cf)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

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
    """``forward_loss`` (the aux included) within 1e-5 relative and every
    grad leaf within 1e-4 norm-relative of ``jax.value_and_grad``, under
    each remat mode; under ``scpp`` the MLA projection is checkpointed
    apart from the attention, which runs once a layer."""
    batch, jl, jaux, want = jax_loss
    cfg = dataclasses.replace(pair["tcfg"], remat=remat)
    leaves, spec = tree_flatten(pair["tparams"])
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    loss, metrics = forward_loss(
        tree_unflatten(leaves, spec),
        {k: torch.from_numpy(v).long() for k, v in batch.items()}, CPU, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - jl) <= 1e-5 * abs(jl)
    assert abs(float(metrics["aux"]) - jaux) <= 1e-5 * jaux
    paths = convert.tree_paths(pair["tparams"])
    assert ("layers", 1, "attn", "kv_norm", "w") in paths
    for g, w, path in zip(grads, want, paths):
        assert g.shape == w.shape, path
        assert _rel(g, w) < 1e-4, path


def test_bf16_cast_matches_jax(pair):
    """In bf16 every leaf's dtype is the reference's ``cast_params_once``'s:
    the MLA weights, the experts and the stacked ``(G, kv_lora)``
    ``kv_norm`` (cast as ``ln1`` is), ``final_norm`` kept fp32;
    ``init_params(cast=True)`` gives the same tree bit for bit."""
    jcfg = dataclasses.replace(pair["jcfg"], dtype="bfloat16")
    tcfg = dataclasses.replace(pair["tcfg"], dtype="bfloat16")
    jcast = jax.eval_shape(lambda p: j_cast_params_once(p, jcfg),
                           pair["jparams"])
    seen = {}
    for ref, path, x in zip(convert.ref_leaf_map(tcfg),
                            convert.tree_paths(pair["tparams"]),
                            tree_flatten(cast_params_once(pair["tparams"],
                                                          tcfg))[0]):
        leaf = jcast
        for k in ref.path:
            leaf = leaf[k]
        want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 else \
            torch.float32
        assert x.dtype == want, path
        seen[path[2:] if path[0] == "layers" else path] = x.dtype
    assert seen["attn", "kv_norm", "w"] == seen["ln1", "w"] == torch.bfloat16
    assert seen["attn", "kv_up", "w"] == seen["moe", "router"] == \
        torch.bfloat16
    assert seen["final_norm", "w"] == torch.float32
    lazy = init_params(tcfg, torch.Generator().manual_seed(3), cast=True)
    eager = cast_params_once(init_params(
        tcfg, torch.Generator().manual_seed(3)), tcfg)
    for a, b in zip(tree_flatten(lazy)[0], tree_flatten(eager)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_prefill_and_absorbed_decode_match_jax(pair):
    """Prefill's last-token logits and the ``{c, rope}`` caches (the normed
    latent and the roped shared key, ``(L, B, S, d)``) within 1e-5 of the
    reference's; 6 absorbed decode steps (one latent head at scale
    ``1/sqrt(d_qk)``, MoE with ``seq_sharded=False``) within 1e-5 of its
    ``decode_step``, and the last equal to a prefill of the longer prompt
    within 1e-5; ``init_caches`` and ``grow_caches`` give the reference's
    shapes."""
    jcfg, tcfg = pair["jcfg"], pair["tcfg"]
    s, t = 24, 6
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab, (B, s + t))
    jrt = pair["jrt"]
    jpf = jax.jit(lambda p, x: jdecode.prefill(p, {"tokens": x}, jrt, jcfg))
    jstep = jax.jit(lambda p, c, x, pos: jdecode.decode_step(
        p, c, x, pos, jrt, jcfg))
    jl, jc = jpf(pair["jparams"], jnp.asarray(tokens[:, :s], jnp.int32))
    rt = Runtime(impl="auto", device="cpu")
    with torch.inference_mode():
        tl, tc = tdecode.prefill(pair["tparams"],
                                 {"tokens": torch.from_numpy(tokens[:, :s])},
                                 rt, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        got, want = (convert.caches_to_numpy(tc),
                     jax.tree.map(np.asarray, jc))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert got["blocks"][0]["c"].shape == (2, B, s, 32)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        jc = jdecode.grow_caches(jcfg, jc, t)
        tc = tdecode.grow_caches(tcfg, tc, t)
        assert jax.tree.map(lambda x: tuple(x.shape), tc) == jax.tree.map(
            lambda x: tuple(x.shape), jc)
        for i in range(t):
            tok = tokens[:, s + i:s + i + 1]
            jl, jc = jstep(pair["jparams"], jc, jnp.asarray(tok, jnp.int32),
                           jnp.int32(s + i))
            tl, tc = tdecode.decode_step(pair["tparams"], tc,
                                         torch.from_numpy(tok), s + i, rt,
                                         tcfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-5, rtol=1e-5)
        full, _ = tdecode.prefill(pair["tparams"],
                                  {"tokens": torch.from_numpy(tokens)}, rt,
                                  tcfg)
    np.testing.assert_allclose(tl.numpy(), full.numpy(), atol=1e-5,
                               rtol=1e-5)
    empty = tdecode.init_caches(tcfg, B, 40)
    assert jax.tree.map(lambda x: tuple(x.shape), empty) == jax.tree.map(
        lambda x: tuple(x.shape), jax.eval_shape(
            lambda: jdecode.init_caches(jcfg, B, 40)))


# ---------------------------------------------------------------------------
# Trainer and checkpoint
# ---------------------------------------------------------------------------

def _plan():
    return tplan.build_plan(get_reduced(ARCH), opt=topt.OptConfig(**OPT),
                            device="cpu", impl="plain", grad_accum=2,
                            seq_len=SEQ, global_batch=GB)


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
    tr.params = convert.from_jax_params(pair["jparams"], tcfg, device="cpu")
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
    """The reference step's loss and grads (``src/repro/train/
    train_step.py``): each microbatch's ``value_and_grad`` weighted by its
    valid-token count, summed and divided by the total."""
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
    at the same params and batch, as
    ``test_torch_moe.py::test_trainer_matches_jax_step`` holds qwen3-moe:
    each step's loss (the aux included) within 1e-5, every grad leaf
    within 1e-4 norm-relative of the token-weighted grads, and the
    reference's ``adamw_update`` of the port's grads within 1e-6 of the
    port's update."""
    tcfg, seen = pair["tcfg"], port_run["seen"]
    assert len(seen) == STEPS
    losses = port_run["losses"]
    assert losses[0] != losses[-1]
    grads_of = make_grad_fn(port_run["plan"])
    j_update = jax.jit(jopt.adamw_update, static_argnums=3)
    spec = tree_flatten(port_run["tr"].params)[1]
    paths = convert.tree_paths(port_run["tr"].params)
    for i, (before, batch) in enumerate(seen):
        loss, want = _jax_step(pair["jgrad"], before["params"], batch)
        assert abs(losses[i] - loss) <= 1e-5 * abs(loss), i
        _, grads = grads_of(
            convert.from_jax_params(before["params"], tcfg, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        for g, w, path in zip(grads, tree_flatten(convert.from_jax_params(
                want, tcfg, device="cpu"))[0], paths):
            assert _rel(g, w) < 1e-4, path
        after = seen[i + 1][0] if i + 1 < STEPS else port_run["final"]
        grads = convert.to_jax_params(tree_unflatten(grads, spec), tcfg)
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
    reference's one-device plan; the port restores it and saves it again:
    the manifest field for field and every ``.npy`` file (the stacked MLA
    leaves included) byte for byte."""
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
    for leaf in ("kv_down", "kv_norm", "kv_up"):
        assert f"['params']['blocks'][0]['attn']['{leaf}']['w']" in paths
    name = f"step_{STEPS:08d}"
    want = sorted(os.listdir(os.path.join(jdir, name)))
    assert sorted(os.listdir(os.path.join(tdir, name))) == want
    for n in want:
        with open(os.path.join(jdir, name, n), "rb") as a, \
                open(os.path.join(tdir, name, n), "rb") as b:
            assert a.read() == b.read(), n


# ---------------------------------------------------------------------------
# The full config, the plan, the registry and the launchers
# ---------------------------------------------------------------------------

def test_convert_on_full_config(pair):
    """``to_jax_params`` inverts ``from_jax_params`` bit for bit on the
    reduced tree; on the full config (shapes from ``jax.eval_shape``,
    nothing allocated) the reference's stacked shapes, its
    ``_param_count`` (16.21 B), ``decay_mask`` exactly its leaves of two
    dims or more (``kv_norm``'s stacked ``(27, 512)`` among them), the
    transposed MLA weights, and the configs field for field."""
    back = convert.to_jax_params(pair["tparams"], pair["tcfg"])
    assert jax.tree.structure(back) == jax.tree.structure(pair["jparams"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pair["jparams"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in ("moe", "mla"):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert tcfg.mla.d_qk == 192 and tcfg.moe.n_shared == 2
    struct = {tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in p): x.shape
              for p, x in jax.tree_util.tree_flatten_with_path(
                  jplan_mod._params_struct(jcfg))[0]}
    shapes = convert.ref_param_shapes(tcfg)
    assert shapes == struct
    assert shapes["blocks", 0, "attn", "kv_norm", "w"] == (27, 512)
    assert shapes["blocks", 0, "attn", "kv_up", "w"] == (27, 512, 4096)
    assert convert.param_count(tcfg) == jplan_mod._param_count(jcfg)
    assert 16.2e9 < convert.param_count(tcfg) < 16.22e9
    assert convert.decay_mask(tcfg) == [len(struct[r.path]) >= 2
                                        for r in convert.ref_leaf_map(tcfg)]
    refs = dict(zip((p for p, _ in convert.port_leaves(tcfg)),
                    convert.ref_leaf_map(tcfg)))
    assert refs["layers", 26, "attn", "kv_up", "w"] == convert.RefLeaf(
        ("blocks", 0, "attn", "kv_up", "w"), (26,), True)
    assert not refs["layers", 0, "attn", "kv_norm", "w"].transposed


def test_plan_memory_and_zero_places(monkeypatch):
    """``plan_memory`` equals the reference's for the full and reduced
    configs on two grids under three ZeRO modes; under ``dp_sp`` on
    (16, 4, 1, 4) every MLA leaf of the full config (``kv_norm``'s stacked
    ``(27, 512)`` included) is cut along a feature dim of its port leaf,
    ``kv_down``'s 576 output rows along its ``d_model`` columns."""
    for name in ("CKPT_D2H_BYTES_PER_S", "OFFLOAD_WIRE_BYTES_PER_S"):
        monkeypatch.setattr(tplan, name, getattr(jplan_mod, name))
    grids = (dict(dp=16, hp=4, cp_inner=4), dict(hp=2, cp_outer=2,
                                                  cp_inner=2))
    for jcfg, tcfg in ((j_get_config(ARCH), get_config(ARCH)),
                       (j_get_reduced(ARCH), get_reduced(ARCH))):
        for kw in grids:
            for zero in ("auto", "dp_sp", "replica"):
                args = dict(grad_accum=2, zero=zero, remat="auto",
                            memory_budget_gb=80, seq_len=4096,
                            global_batch=32)
                assert tplan.plan_memory(tcfg, ParallelConfig(**kw),
                                         **args) == \
                    jplan_mod.plan_memory(jcfg, JParallelConfig(**kw),
                                          **args), (tcfg.name, kw, zero)
    tcfg = get_config(ARCH)
    pc = ParallelConfig(**grids[0])
    mesh = tplan._ShapeOnlyMesh(pc)
    _, _, groups, _ = tplan.plan_memory(tcfg, pc, memory_budget_gb=80,
                                        zero="dp_sp")
    shapes = convert.ref_param_shapes(tcfg)
    specs = tzero.zero_shardings(shapes, mesh, groups)
    seen = set()
    for ref, (path, shape) in zip(convert.ref_leaf_map(tcfg),
                                  convert.port_leaves(tcfg)):
        if path[2:3] != ("attn",):
            continue
        place = tzero._place(ref, shapes[ref.path], specs[ref.path], mesh,
                             shape)
        assert place.axes and place.dim is not None, path
        if path[3] == "kv_down":           # 576 rows: cut along d_model
            assert place.dim == 1, place
        seen.add(path[3])
    assert seen == {"wq", "kv_down", "kv_norm", "kv_up", "wo"}


def test_registry_and_launchers(capsys):
    """The arch loads (``PENDING`` is empty), ``require_ported`` admits
    MLA and still refuses an unknown family, and both launchers run the
    reduced model on the CPU: two trainer steps of two microbatches with
    finite losses, and a fixed-batch generate through the absorbed
    decode."""
    assert PENDING == {}
    assert get_config(ARCH).family == get_reduced(ARCH).family == "moe"
    require_ported(get_config(ARCH))
    with pytest.raises(ValueError, match="unknown family"):
        require_ported(dataclasses.replace(get_reduced(ARCH),
                                           family="conv"))
    losses = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "2", "--seq-len", "32",
                           "--global-batch", "2", "--grad-accum", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "deepseek-v2-lite-smoke [moe]" in capsys.readouterr().out
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--prompt-len", "16", "--gen", "3"])
    assert "generated 6 tokens" in capsys.readouterr().out
