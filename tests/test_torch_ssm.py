"""The port's SSM and hybrid families (``repro_torch.models.ssm``, reduced
falcon-mamba-7b and zamba2-7b) against the JAX package on the CPU, one
process.

* ``mamba1_apply`` / ``mamba2_apply``: y, the input and parameter grads
  and the ``return_state`` state (``h`` and ``conv``), with the scan in
  one group and in groups of one segment (``SCAN_BYTES`` cut), and one
  ``mamba*_decode`` step from that state, within the reference suite's
  fp32 bounds (1e-5; the Mamba2 layer 5e-5, as
  ``tests/_dist_checks.py::check_ssm``); in bf16 (the leaves cast as
  ``cast_params_once`` casts them) y and every grad within 2e-2.  The
  parameters are drawn with numpy so that ``A_log``, ``dt_bias``, ``D``
  and the norm are not at their init.
* the reduced models: ``forward_loss`` and every leaf's grad under each
  remat mode within 1e-5; in bf16 the cast tree leaf for leaf (``A_log``
  and the unstacked ``shared_attn`` norms fp32) and the loss within 2e-2
  (a leaf's bf16 grad lies as far from JAX's bf16 one, up to 1.2e-1 in
  the 7-layer hybrid, as JAX's bf16 from its fp32: rounding, not the
  port; the layer holds 2e-2); prefill and decode logits and caches
  within 1e-5, and decode equal to the incremental forward (the
  reference's ``test_decode_matches_incremental_forward``); what each
  remat mode keeps in the hybrid trunk (a Mamba2 layer its input, the
  shared block what a dense layer keeps).
* ``convert``: the round trip, ``param_count``, ``decay_mask`` and the
  reference's shapes on the full configs (``jax.eval_shape``); the full
  configs field for field; ``plan_memory`` against the reference's, the
  ZeRO specs placed on the port's leaves, and a checkpoint of reduced
  zamba2 that JAX's ``restore`` reads bit for bit; both launchers.

The four-rank cases (both layers on a grid of four sequence ranks, and a
reduced zamba2 ``dp_sp`` step) are in ``test_torch_runtime_mesh.py``.
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
from repro.models import decode as jdecode
from repro.models import ssm as jssm
from repro.models.model import cast_params_once as j_cast_params_once
from repro.models.model import forward_loss as j_forward_loss
from repro.core.topology import ParallelConfig as JParallelConfig
from repro.runtime import checkpoint as jckpt
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import plan as tplan
from repro_torch.core import zero as tzero
from repro_torch.core.runtime import Runtime
from repro_torch.core.topology import ParallelConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import decode as tdecode
from repro_torch.models import ssm as tssm
from repro_torch.models.model import (REMAT, cast_params_once, forward_loss,
                                      init_params, require_ported)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train.optimizer import init_opt_state

torch.set_num_threads(2)

ARCHS = ("falcon-mamba-7b", "zamba2-7b")
B, S = 2, 32
CPU = Runtime(impl="plain", device="cpu")
#: fp32 bounds of one layer (the reference suite's ``check_ssm``)
LAYER_TOL = {"mamba1": 1e-5, "mamba2": 5e-5}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _draw(rng, path, shape):
    """A leaf of the reference's tree: linear weights N(0, d_in^-0.5)
    (``d_in`` the next-to-last dim), ``A_log`` log(U(1, 8)), ``D`` about
    1, the rest N(0, 0.1)."""
    key = path[-1]
    if key == "w" and len(shape) >= 2:
        x = shape[-2] ** -0.5 * rng.standard_normal(shape)
    elif key == "A_log":
        x = np.log(rng.uniform(1.0, 8.0, shape))
    elif key == "D":
        x = 1.0 + 0.1 * rng.standard_normal(shape)
    else:
        x = 0.1 * rng.standard_normal(shape)
    return x.astype(np.float32)


def _random_tree(jcfg, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: _draw(rng, tuple(getattr(k, "key", None) for k in p),
                           x.shape), jplan_mod._params_struct(jcfg))


@pytest.fixture(scope="module")
def jrt():
    return j_build_plan(j_get_reduced("qwen3-1.7b"),
                        devices=jax.devices()[:1], impl="ref").rt


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------

LAYERS = {
    "mamba1": (jssm.Mamba1Dims, tssm.Mamba1Dims, jssm.init_mamba1,
               dict(d_model=32, d_inner=64, d_state=8, seg=8),
               jssm.mamba1_apply, jssm.mamba1_decode, tssm.mamba1_apply,
               tssm.mamba1_decode),
    "mamba2": (jssm.Mamba2Dims, tssm.Mamba2Dims, jssm.init_mamba2,
               dict(d_model=32, d_inner=64, d_state=8, head_dim=8, seg=8),
               jssm.mamba2_apply, jssm.mamba2_decode, tssm.mamba2_apply,
               tssm.mamba2_decode),
}


def _port_layer(p):
    """The reference's mixer leaves (numpy) in the port's layout: linear
    weights transposed."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = {n: torch.from_numpy(np.array(x.T if n == "w" and
                                                   x.ndim == 2 else x))
                      for n, x in v.items()}
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_mamba_layer_matches_jax(jrt, kind):
    """y, the grads of ``sum(y * w)`` with respect to x and every leaf,
    and the prefill state, with the scan in one group and in groups of
    one segment; one decode step from the state against
    ``mamba*_decode``'s, logits and state; and in bf16, y and the grads
    within 2e-2."""
    jdims, tdims, init, kw, japply, jdec, tapply, tdec = LAYERS[kind]
    jm, tm = jdims(**kw), tdims(**kw)
    tol = LAYER_TOL[kind]
    struct = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jm))
    rng = np.random.default_rng(7)
    p = jax.tree_util.tree_map_with_path(
        lambda path, x: _draw(rng, tuple(getattr(k, "key", None)
                                         for k in path), x.shape), struct)
    x = rng.standard_normal((B, S, jm.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    tok = rng.standard_normal((B, 1, jm.d_model)).astype(np.float32)

    def jf(p, x):
        y, st = japply(p, x, jrt, jm, return_state=True)
        return (y * w).sum(), (y, st)

    (_, (jy, jst)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(p, x)
    jy2, jst2 = jax.jit(lambda p, t, s: jdec(p, t, s, jm))(p, tok, jst)
    budget = tssm.SCAN_BYTES
    try:
        for cut in (budget, 1):          # one group; one segment a group
            tssm.SCAN_BYTES = cut
            leaves, spec = tree_flatten(_port_layer(p))
            leaves = [v.requires_grad_() for v in leaves]
            tx = torch.from_numpy(x).requires_grad_()
            y, st = tapply(tree_unflatten(leaves, spec), tx, CPU, tm,
                           return_state=True)
            (y * torch.from_numpy(w)).sum().backward()
            assert _rel(y.detach(), jy) < tol, cut
            assert _rel(tx.grad, jgx) < tol, cut
            want = tree_flatten(_port_layer(jax.tree.map(np.asarray,
                                                         jgp)))[0]
            for path, g, ww in zip(convert.tree_paths(
                    tree_unflatten(leaves, spec)), leaves, want):
                assert _rel(g.grad, ww) < tol, (cut, path)
            for k in ("h", "conv"):
                assert _rel(st[k].detach(), jst[k]) < tol, (cut, k)
    finally:
        tssm.SCAN_BYTES = budget
    with torch.no_grad():
        y2, st2 = tdec(_port_layer(p), torch.from_numpy(tok),
                       {k: v.detach() for k, v in st.items()}, tm)
    assert _rel(y2, jy2) < tol
    for k in ("h", "conv"):
        assert _rel(st2[k], jst2[k]) < tol, k

    def half(path, v):
        return v if path[-1] == "A_log" else v.astype(jnp.bfloat16)

    def jf16(p, x):
        p = jax.tree_util.tree_map_with_path(
            lambda pa, v: half(tuple(getattr(k, "key", None) for k in pa),
                               v), p)
        y = japply(p, x.astype(jnp.bfloat16), jrt, jm)
        return (y.astype(jnp.float32) * w).sum(), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf16, argnums=(0, 1), has_aux=True))(p, x)
    leaves, spec = tree_flatten(_port_layer(p))
    leaves = [v.requires_grad_() for v in leaves]
    paths = convert.tree_paths(_port_layer(p))
    tx = torch.from_numpy(x).requires_grad_()
    y = tapply(tree_unflatten([v if pa[-1] == "A_log" else v.bfloat16()
                               for pa, v in zip(paths, leaves)], spec),
               tx.bfloat16(), CPU, tm)
    (y.float() * torch.from_numpy(w)).sum().backward()
    assert y.dtype == torch.bfloat16
    assert _rel(y.detach().float(), np.asarray(jy, np.float32)) < 2e-2
    assert _rel(tx.grad, np.asarray(jgx, np.float32)) < 2e-2
    want = tree_flatten(_port_layer(jax.tree.map(
        lambda g: np.asarray(g, np.float32), jgp)))[0]
    for path, g, ww in zip(paths, leaves, want):
        assert _rel(g.grad, ww) < 2e-2, path


# ---------------------------------------------------------------------------
# The reduced models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """Per arch: both configs, the reference's tree (numpy) and the port's
    copy."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, tcfg = j_get_reduced(arch), get_reduced(arch)
        jparams = _random_tree(jcfg, i)
        out[arch] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                         tparams=convert.from_jax_params(
                             jparams, tcfg, device="cpu"))
    return out


def _batch(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": labels,
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy()}


def _port_grads(tparams, batch, cfg):
    leaves, spec = tree_flatten(tparams)
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    loss, _ = forward_loss(tree_unflatten(leaves, spec),
                           {k: torch.from_numpy(v).long()
                            for k, v in batch.items()}, CPU, cfg)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_matches_jax(models, jrt, arch):
    """``forward_loss`` within 1e-5 relative and every grad leaf within
    1e-5 norm-relative of ``jax.value_and_grad``'s, under each remat mode
    (the hybrid family's shared block summing its grads over its two
    applications)."""
    m = models[arch]
    batch = _batch(m["tcfg"].vocab)
    # the reference's value does not depend on its remat; "full" compiles
    # fastest
    jcfg = dataclasses.replace(m["jcfg"], remat="full")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, jrt, jcfg), has_aux=True))(
            m["jparams"], jax.tree.map(jnp.asarray, batch))
    want = tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, jg), m["tcfg"], device="cpu"))[0]
    paths = convert.tree_paths(m["tparams"])
    for remat in REMAT:
        cfg = dataclasses.replace(m["tcfg"], remat=remat)
        loss, grads = _port_grads(m["tparams"], batch, cfg)
        assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl)), remat
        assert len(grads) == len(want)
        for g, w, path in zip(grads, want, paths):
            assert _rel(g, w) < 1e-5, (remat, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_jax(models, jrt, arch):
    """In bf16 every leaf's dtype is the reference's ``cast_params_once``'s
    (``A_log`` fp32; zamba2's unstacked ``shared_attn`` norms fp32, its
    stacked per-layer vectors bf16), ``init_params(cast=True)`` gives the
    same tree bit for bit, and the loss lies within 2e-2 of the
    reference's bf16 loss."""
    m = models[arch]
    jcfg = dataclasses.replace(m["jcfg"], dtype="bfloat16")
    tcfg = dataclasses.replace(m["tcfg"], dtype="bfloat16")
    jcast = jax.eval_shape(lambda p: j_cast_params_once(p, jcfg),
                           m["jparams"])
    seen = {}
    for ref, path, x in zip(convert.ref_leaf_map(tcfg),
                            convert.tree_paths(m["tparams"]),
                            tree_flatten(cast_params_once(m["tparams"],
                                                          tcfg))[0]):
        leaf = jcast
        for k in ref.path:
            leaf = leaf[k]
        want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 else torch.float32
        assert x.dtype == want, path
        seen[path[-1] if path[0] == "layers" else path] = x.dtype
    assert seen["A_log"] == torch.float32 and seen["D"] == torch.bfloat16
    if arch == "zamba2-7b":
        assert seen["shared_attn", "ln1", "w"] == torch.float32
        assert seen["dt_bias"] == torch.bfloat16
    lazy = init_params(tcfg, torch.Generator().manual_seed(3), cast=True)
    eager = cast_params_once(init_params(
        tcfg, torch.Generator().manual_seed(3)), tcfg)
    for a, b in zip(tree_flatten(lazy)[0], tree_flatten(eager)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    batch = _batch(tcfg.vocab, 1)
    jl, _ = jax.jit(lambda p, b: j_forward_loss(p, b, jrt, jcfg))(
        m["jparams"], jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        loss, _ = forward_loss(m["tparams"], {
            k: torch.from_numpy(v).long() for k, v in batch.items()}, CPU,
            tcfg)
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, jrt, arch):
    """Prefill's last-token logits and every cache leaf (SSM states, the
    shared block's K / V) within 1e-5 of the reference's, decode steps
    within 1e-5, and T decode steps after a prefill of S equal to a
    prefill of S + T (the reference's incremental-forward test)."""
    m = models[arch]
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    s, t = 16, 4
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (B, s + t))
    jpf = jax.jit(lambda p, x: jdecode.prefill(p, {"tokens": x}, jrt, jcfg))
    jstep = jax.jit(lambda p, c, x, pos: jdecode.decode_step(
        p, c, x, pos, jrt, jcfg))
    jl, jc = jpf(m["jparams"], jnp.asarray(tokens[:, :s], jnp.int32))
    rt = Runtime(impl="auto", device="cpu")
    with torch.inference_mode():
        tl, tc = tdecode.prefill(m["tparams"],
                                 {"tokens": torch.from_numpy(tokens[:, :s])},
                                 rt, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        assert jax.tree.structure(convert.caches_to_numpy(tc)) == \
            jax.tree.structure(jax.tree.map(np.asarray, jc))
        for a, b in zip(jax.tree.leaves(convert.caches_to_numpy(tc)),
                        jax.tree.leaves(jax.tree.map(np.asarray, jc))):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        jc = jdecode.grow_caches(jcfg, jc, t)
        tc = tdecode.grow_caches(tcfg, tc, t)
        for i in range(t):
            tok = tokens[:, s + i:s + i + 1]
            jl, jc = jstep(m["jparams"], jc, jnp.asarray(tok, jnp.int32),
                           jnp.int32(s + i))
            tl, tc = tdecode.decode_step(m["tparams"], tc,
                                         torch.from_numpy(tok), s + i, rt,
                                         tcfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-5, rtol=1e-5)
        full, _ = tdecode.prefill(m["tparams"],
                                  {"tokens": torch.from_numpy(tokens)}, rt,
                                  tcfg)
    np.testing.assert_allclose(tl.numpy(), full.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_remat_saved_sets_hybrid():
    """What each remat mode keeps for the backward in the hybrid trunk,
    read with ``saved_tensors_hooks`` and told apart by depth: a Mamba2
    layer keeps only its input under ``full`` and ``scpp`` (it has no
    ``attn_out``), and under ``scpp`` an application of the shared block
    keeps what a dense layer does in ``test_torch_train.py``'s pin: its
    input (held by both checkpointed halves), ``attn_out`` and the
    attention kernels' folded q, k, v, out and lse."""
    base = get_reduced("zamba2-7b")            # attn_every 3, 4 heads of 16

    def saved(remat, n):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        cfg = dataclasses.replace(base, remat=remat, num_layers=n)
        leaves, spec = tree_flatten(init_params(
            cfg, torch.Generator().manual_seed(0)))
        tree = tree_unflatten([x.requires_grad_() for x in leaves], spec)
        batch = {k: torch.from_numpy(v).long()
                 for k, v in _batch(cfg.vocab).items()}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            forward_loss(tree, batch, CPU, cfg)
        return collections.Counter(shapes)

    d, h, hd = base.d_model, base.n_heads, base.hd
    for remat in ("full", "scpp"):
        mamba = saved(remat, 4) - saved(remat, 3)       # one tail layer
        assert mamba == collections.Counter({(B, S, d): 1}), remat
        # depth 6: two groups (two applications); depth 5: one group and
        # two tail layers
        shared = saved(remat, 6) - saved(remat, 5) - mamba
        want = {(B, S, d): 1} if remat == "full" else {
            (B, S, d): 3, (B * h, S, hd): 4, (B * h, S): 1}
        assert shared == collections.Counter(want), remat
    assert sum((saved("none", 4) - saved("none", 3)).values()) > 20


# ---------------------------------------------------------------------------
# Parameter bookkeeping, the registry and the launchers
# ---------------------------------------------------------------------------

def test_convert_and_full_configs(models):
    """``to_jax_params`` inverts ``from_jax_params`` bit for bit on both
    reduced trees (zamba2: ``blocks`` ``(G, p, ...)``, ``blocks_tail``,
    ``shared_attn``); on the full configs the reference's shapes, its
    ``_param_count`` and the ``decay_mask`` of its rule (two dims or more
    after stacking) from ``jax.eval_shape``, nothing allocated; the full
    configs field for field; a hybrid depth that leaves a tail."""
    for arch in ARCHS:
        m = models[arch]
        back = convert.to_jax_params(m["tparams"], m["tcfg"])
        assert jax.tree.structure(back) == jax.tree.structure(m["jparams"])
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(m["jparams"])):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        for jcfg, tcfg in ((j_get_config(arch), get_config(arch)),
                           (dataclasses.replace(j_get_config(arch),
                                                num_layers=7),
                            dataclasses.replace(get_config(arch),
                                                num_layers=7))):
            struct = {tuple(getattr(k, "key", getattr(k, "idx", None))
                            for k in p): x.shape
                      for p, x in jax.tree_util.tree_flatten_with_path(
                          jplan_mod._params_struct(jcfg))[0]}
            assert convert.ref_param_shapes(tcfg) == struct
            assert convert.param_count(tcfg) == jplan_mod._param_count(jcfg)
            assert convert.decay_mask(tcfg) == [
                len(struct[r.path]) >= 2 for r in convert.ref_leaf_map(tcfg)]
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        for f in dataclasses.fields(tcfg):
            got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
    mask = dict(zip(convert.tree_paths(models["zamba2-7b"]["tparams"]),
                    convert.decay_mask(models["zamba2-7b"]["tcfg"])))
    assert mask["layers", 6, "mix", "A_log"] and \
        not mask["shared_attn", "ln2", "w"]
    refs = dict(zip(convert.tree_paths(models["zamba2-7b"]["tparams"]),
                    convert.ref_leaf_map(models["zamba2-7b"]["tcfg"])))
    assert refs["layers", 4, "mix", "D"].idx == (1, 1)
    assert refs["layers", 6, "ln", "w"].path[0] == "blocks_tail"


def test_plan_memory_specs_and_checkpoint(tmp_path, monkeypatch):
    """``plan_memory`` (which reads ``param_count``) equals the
    reference's for both families, full and reduced, on two grids under
    three ZeRO modes (with the port's two rate constants set to the
    reference's, as ``test_torch_zero.py`` does); the specs of every
    reference leaf place on the port's leaves (the big stacked leaves
    sharded along a feature dim under ``dp_sp``; a spec over zamba2's
    inner layer axis puts whole layers in a shard by their slot); and a
    checkpoint of reduced zamba2's state, written
    through ``ref_leaf_map``, is read by JAX's ``restore`` bit for bit
    and restored by the port into a zeroed state."""
    for name in ("CKPT_D2H_BYTES_PER_S", "OFFLOAD_WIRE_BYTES_PER_S"):
        monkeypatch.setattr(tplan, name, getattr(jplan_mod, name))
    grids = (dict(dp=16, hp=8, cp_inner=2), dict(hp=2, cp_outer=2,
                                                  cp_inner=2))
    for arch in ARCHS:
        for jcfg, tcfg in ((j_get_config(arch), get_config(arch)),
                           (j_get_reduced(arch), get_reduced(arch))):
            for kw in grids:
                for zero in ("auto", "dp_sp", "replica"):
                    args = dict(grad_accum=2, zero=zero, remat="auto",
                                memory_budget_gb=80, seq_len=4096,
                                global_batch=32)
                    want = jplan_mod.plan_memory(jcfg, JParallelConfig(**kw),
                                                 **args)
                    got = tplan.plan_memory(tcfg, ParallelConfig(**kw),
                                            **args)
                    assert got == want, (arch, kw, zero)
        tcfg = get_config(arch)
        mesh = tplan._ShapeOnlyMesh(ParallelConfig(**grids[0]))
        _, _, groups, _ = tplan.plan_memory(tcfg, ParallelConfig(**grids[0]),
                                            memory_budget_gb=80,
                                            zero="dp_sp")
        specs = tzero.zero_shardings(convert.ref_param_shapes(tcfg), mesh,
                                     groups)
        shapes = convert.ref_param_shapes(tcfg)
        for ref, (path, shape) in zip(convert.ref_leaf_map(tcfg),
                                      convert.port_leaves(tcfg)):
            place = tzero._place(ref, shapes[ref.path], specs[ref.path],
                                 mesh, shape)
            if path[-2:] == ("in_proj", "w"):
                assert place.axes and place.dim is not None, path
    # three data ranks divide only zamba2's inner layer axis (6) of
    # A_log (13, 6, 112): whole layers a shard, by the layer's slot
    tcfg, pc = get_config("zamba2-7b"), ParallelConfig(dp=3)
    mesh = tplan._ShapeOnlyMesh(pc)
    shapes = convert.ref_param_shapes(tcfg)
    spec = tzero.leaf_spec(shapes["blocks", "mix", "A_log"], mesh,
                           ((("data",),)))
    assert spec == tzero.LeafSpec(1, ("data",))
    refs = dict(zip(convert.tree_paths(init_params(
        tcfg, torch.Generator(), device="meta")), convert.ref_leaf_map(tcfg)))
    owners = [tzero._place(refs["layers", i, "mix", "A_log"],
                           shapes["blocks", "mix", "A_log"], spec, mesh,
                           (112,)).owner for i in range(12)]
    assert owners == [0, 0, 1, 1, 2, 2] * 2
    cfg = get_reduced("zamba2-7b")
    plan = tplan.build_plan(cfg, device="cpu", impl="plain", seq_len=S,
                            global_batch=B)
    params = init_params(cfg, torch.Generator().manual_seed(4))
    opt = init_opt_state(params)
    for i, x in enumerate(tree_flatten(opt["m"])[0]):
        x.fill_(0.5 + i)
    opt["step"] = 3
    d = str(tmp_path / "c")
    ckpt.CheckpointManager(d, plan=plan).save({"params": params,
                                               "opt": opt}, 3)
    struct = jplan_mod._params_struct(j_get_reduced("zamba2-7b"))
    template = {"params": struct,
                "opt": {"m": struct, "v": struct,
                        "step": jax.ShapeDtypeStruct((), jnp.int32)}}
    got, step = jckpt.restore(template, d, step=3)
    assert step == 3
    want = {"params": convert.to_jax_params(params, cfg),
            "opt": {"m": convert.to_jax_params(opt["m"], cfg),
                    "v": convert.to_jax_params(opt["v"], cfg),
                    "step": np.asarray(3, np.int32)}}
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    zeroed = {"params": init_params(cfg, torch.Generator().manual_seed(5)),
              "opt": init_opt_state(params)}
    state, _ = ckpt.CheckpointManager(d, plan=plan).restore(zeroed, step=3)
    for a, b in zip(tree_flatten(state)[0], tree_flatten(
            {"params": params, "opt": opt})[0]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_registry_and_launchers(capsys):
    """Both arches resolve, ``require_ported`` admits both families, and
    both launchers run each reduced model on the CPU: two trainer steps
    with finite losses and a fixed-batch generate."""
    for arch, family in zip(ARCHS, ("ssm", "hybrid")):
        assert get_config(arch).family == get_reduced(arch).family == family
        require_ported(get_reduced(arch))
        losses = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                               "--steps", "2", "--seq-len", "32",
                               "--global-batch", "2", "--grad-accum", "2"])
        assert len(losses) == 2 and np.isfinite(losses).all()
        assert f"[{family}]" in capsys.readouterr().out
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--prompt-len", "16", "--gen", "3"])
        assert "generated 6 tokens" in capsys.readouterr().out
    losses = tlaunch.main(["--arch", "zamba2-7b", "--smoke", "--device",
                           "cpu", "--steps", "1", "--seq-len", "32",
                           "--global-batch", "2", "--layers", "4"])
    assert len(losses) == 1 and np.isfinite(losses).all()
