"""The port's model for training (``repro_torch.models``) against the JAX
package, in fp32 on the CPU, on reduced qwen3-1.7b (GQA, qk-norm),
olmo-1b (MHA, non-parametric LayerNorm), chameleon-34b (qk-norm, an
untied head) and gemma3-12b (five local layers to one global, two RoPE
thetas, post-norms, embedding scale, GeGLU): ``forward_loss`` and its
grads (1e-5), the remat modes against each other (1e-6) and what each
keeps for the backward; and, in bf16, ``cast_params_once``'s dtype of
every leaf against the reference's.

Both sides start from the same weights: JAX ``init_params``, brought over
by ``convert.from_jax_params`` (which also carries grad trees across,
since they share the params' structure).  The port runs its attention
through the kernel path with the kernels' plain versions
(``impl="plain"``: the fold, ``_FlashFolded`` and ``_fwd_plain`` /
``_bwd_plain``); the JAX side runs its plan's ``ref`` path.  The
training loop is in ``test_torch_trainer.py``.
"""
import collections
import dataclasses

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
from repro.models.model import cast_params_once as j_cast_params_once
from repro.models.model import forward_loss as j_forward_loss
from repro.models.model import init_params as j_init_params
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.runtime import Runtime
from repro_torch.kernels import ops as tops
from repro_torch.models.model import (REMAT, cast_params_once, forward_loss,
                                      init_params)

torch.set_num_threads(2)

B, S = 2, 32
TOL = dict(atol=1e-5, rtol=1e-5)


def _batch(vocab: int, seed: int = 0):
    """Tokens, labels with a padded tail (-1) and positions, as numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": labels,
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy()}


def _leaves(params):
    """Fresh leaves that require grad, and the tree rebuilt from them."""
    leaves, spec = tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    return leaves, tree_unflatten(leaves, spec)


def _loss_and_grads(params, batch, cfg, impl="plain"):
    leaves, tree = _leaves(params)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, metrics = forward_loss(tree, tb, Runtime(impl=impl, device="cpu"),
                                 cfg)
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module", params=["qwen3-1.7b", "olmo-1b",
                                        "chameleon-34b", "gemma3-12b"])
def arch_pair(request):
    jcfg, tcfg = j_get_reduced(request.param), get_reduced(request.param)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_forward_loss_and_grads_match_jax(arch_pair):
    """``forward_loss`` and every grad leaf (tied embedding: embedding +
    head) against ``jax.value_and_grad(forward_loss)``, through the kernel
    path with remat scpp."""
    jcfg, tcfg, jparams, tparams = arch_pair
    batch = _batch(tcfg.vocab)
    plan = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref")
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, plan.rt, jcfg), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = _loss_and_grads(tparams, batch, tcfg)
    assert tcfg.remat == "scpp"
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert float(metrics["n_tokens"]) == float(jm["n_tokens"]) == B * (S - 3)
    want = tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu"))[0]
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_remat_modes_agree_and_count_forward_calls(monkeypatch):
    """none / full / scpp give one loss and one set of grads (1e-6); the
    forward kernel's wrapper runs once a layer under none and scpp and
    twice under full (the recompute), the backward once a layer."""
    tcfg = get_reduced("qwen3-1.7b")
    params = convert.from_jax_params(jax.tree.map(
        np.asarray, j_init_params(j_get_reduced("qwen3-1.7b"),
                                  jax.random.PRNGKey(1))), tcfg, device="cpu")
    calls = collections.Counter()
    real_fwd, real_bwd = tops._fwd, tops._bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(tops, "_fwd", fwd)
    monkeypatch.setattr(tops, "_bwd", bwd)
    batch = _batch(tcfg.vocab, seed=2)
    results, n = {}, tcfg.num_layers
    for remat in ("none", "full", "scpp"):
        calls.clear()
        loss, _, grads = _loss_and_grads(
            params, batch, dataclasses.replace(tcfg, remat=remat))
        results[remat] = (loss, grads)
        assert dict(calls) == {"fwd": 2 * n if remat == "full" else n,
                               "bwd": n}, remat
    ref_loss, ref_grads = results["none"]
    for remat in ("full", "scpp"):
        loss, grads = results[remat]
        np.testing.assert_allclose(loss.item(), ref_loss.item(), atol=1e-6,
                                   rtol=1e-6)
        for g, w in zip(grads, ref_grads):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                       rtol=1e-6)


def test_scpp_saved_set_is_pinned():
    """What each remat mode keeps for the backward, read with
    ``saved_tensors_hooks`` and counted per layer (depth 2 minus depth 1).
    Full remat keeps its block input.  Selective Checkpoint++ keeps the
    block input (held by both checkpointed halves), ``attn_out`` (the
    second half's input) and what the attention kernels saved: folded q,
    k, v, out and lse; so the forward kernel is not re-run."""
    def saved(remat, n):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        cfg = dataclasses.replace(get_reduced("qwen3-1.7b"), remat=remat,
                                  num_layers=n)
        params = convert.from_jax_params(jax.tree.map(
            np.asarray, j_init_params(j_get_reduced("qwen3-1.7b"),
                                      jax.random.PRNGKey(0))),
            get_reduced("qwen3-1.7b"), device="cpu")
        params["layers"] = params["layers"][:n]
        _, tree = _leaves(params)
        tb = {k: torch.from_numpy(v).long()
              for k, v in _batch(cfg.vocab).items()}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            forward_loss(tree, tb, Runtime(impl="plain", device="cpu"), cfg)
        return collections.Counter(shapes)

    cfg = get_reduced("qwen3-1.7b")
    hq, hkv, d, dm = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    per_layer = {r: saved(r, 2) - saved(r, 1) for r in REMAT}
    assert per_layer["full"] == collections.Counter({(B, S, dm): 1})
    assert per_layer["scpp"] == collections.Counter(
        {(B, S, dm): 3, (B * hq, S, d): 2, (B * hkv, S, d): 2,
         (B * hq, S): 1})
    assert sum(per_layer["none"].values()) > 20
    assert saved("scpp", 1) - saved("full", 1) == \
        per_layer["scpp"] - per_layer["full"]


def test_configs_match_reference():
    for arch in ("qwen3-1.7b", "olmo-1b", "chameleon-34b", "gemma3-12b"):
        for jc, tc in ((j_get_config(arch), get_config(arch)),
                       (j_get_reduced(arch), get_reduced(arch))):
            for f in ("num_layers", "d_model", "n_heads", "n_kv_heads",
                      "d_ff", "vocab", "hd", "qk_norm", "rope_theta", "norm",
                      "tie_embeddings", "final_softcap", "remat", "zigzag",
                      "loss_chunk", "dtype", "period", "window",
                      "window_pattern", "rope_theta_local", "post_norms",
                      "embed_scale", "act"):
                assert getattr(tc, f) == getattr(jc, f), (arch, f)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b",
                                  "chameleon-34b", "gemma3-12b"])
def test_bf16_cast_matches_jax(arch):
    """In bf16 each port leaf's dtype after ``cast_params_once`` is its
    reference counterpart's after the JAX ``cast_params_once``: the
    per-layer norm weights (``ln1``, ``ln2``, qwen3-1.7b's ``qn`` / ``kn``,
    gemma2-2b's ``pn1`` / ``pn2``; stacked ``(G, d)`` there) go to bf16,
    ``final_norm`` stays fp32."""
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16")
    cast = jax.eval_shape(lambda p: j_cast_params_once(p, jcfg),
                          jplan_mod._params_struct(jcfg))
    params = cast_params_once(init_params(tcfg, torch.Generator()), tcfg)
    dtypes = collections.Counter()
    for ref, leaf in zip(convert.ref_leaf_map(tcfg),
                         tree_flatten(params)[0]):
        want = cast
        for k in ref.path:
            want = want[k]
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), ref.path
        dtypes[ref.path[-2], str(want.dtype)] += 1
    assert dtypes["final_norm", "float32"] == 1
    norms = ("ln1", "ln2") + (("qn", "kn") if tcfg.qk_norm else ()) \
        + (("pn1", "pn2") if tcfg.post_norms else ())
    for name in norms:
        assert dtypes[name, "bfloat16"] == tcfg.num_layers, name
