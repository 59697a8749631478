"""The port's encoder-decoder family (whisper-small, reduced) against the
JAX package on the CPU, one process.

* the layers: ``layernorm_apply`` (fp32, and bf16 with a bf16 weight),
  ``init_layernorm``, ``sinusoid_positions`` (bit for bit at 1536
  positions, fp32 and bf16) and the biased tanh-GELU MLP, within 1e-6;
* ``cross_attn_apply`` and its grads (decoder queries over encoder
  frames: the non-causal ``ops.flash_attention`` at Lq != Lk, on the
  plain versions of the kernels) against the reference's on Pallas
  interpret mode, at the reference suite's kernel bounds;
* the reduced model: ``forward_loss`` within 1e-5 and every grad leaf
  within 1e-4 norm-relative of ``jax.value_and_grad``'s under each remat
  mode (a self-attention key bias, which the softmax ignores, is
  measured against its layer's key weight); what each remat mode keeps;
  prefill and 8 decode steps within 1e-5 of the reference's logits and
  caches, and decode equal to the longer prefill;
* ``SyntheticLM``'s frames byte for byte, whole and as a rank's shard;
  ``PackedLM`` refusing the family; the bf16 cast and ``decay_mask``
  against the reference's rules; ``convert``'s round trip, the full
  config, ``plan_memory`` and the ZeRO specs; a checkpoint JAX reads bit
  for bit; both launchers.

The four-rank case (a reduced ``dp_sp`` step) is in
``test_torch_runtime_mesh.py``.
"""
import collections
import dataclasses

import _torch_parity as P
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
from repro.data import pipeline as jpipe
from repro.models import attention_block as jattn
from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models.model import cast_params_once as j_cast_params_once
from repro.models.model import forward_loss as j_forward_loss
from repro.runtime import checkpoint as jckpt
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import plan as tplan
from repro_torch.core import zero as tzero
from repro_torch.core.runtime import Runtime
from repro_torch.core.topology import (ParallelConfig, rank_coords,
                                       seq_slice)
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention_block as tattn
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models.model import (REMAT, cast_params_once, forward_loss,
                                      init_params, require_ported)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train.optimizer import init_opt_state

torch.set_num_threads(2)

ARCH = "whisper-small"
B, S = 2, 32
CPU = Runtime(impl="plain", device="cpu")
NORMS = ("ln1", "ln2", "lnx", "enc_norm", "final_norm")


def _rel(a, b, scale=None) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ref = b if scale is None else np.asarray(scale, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(ref), 1e-30))


def _key(k):
    return getattr(k, "key", getattr(k, "idx", None))


def _draw(rng, path, shape):
    """A leaf of the reference's tree: LayerNorm weights about 1, linear
    weights N(0, d_in^-0.5) (``d_in`` the next-to-last dim), the tables
    N(0, 0.3), biases N(0, 0.1)."""
    if path[-1] == "w" and path[-2] in NORMS:
        x = 1.0 + 0.1 * rng.standard_normal(shape)
    elif path[-1] == "w":
        x = shape[-2] ** -0.5 * rng.standard_normal(shape)
    elif path[-1] == "table":
        x = 0.3 * rng.standard_normal(shape)
    else:
        x = 0.1 * rng.standard_normal(shape)
    return x.astype(np.float32)


def _random_tree(struct, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: _draw(rng, tuple(_key(k) for k in p), x.shape), struct)


def _scale_index(paths) -> list:
    """Per leaf, the leaf whose grad norm scales its comparison: itself,
    or for a self-attention key bias (whose true grad is zero: the
    softmax ignores a shift of every key) its layer's key weight."""
    index = {p: i for i, p in enumerate(paths)}
    return [index[p[:-1] + ("w",)] if p[-3:] == ("attn", "wk", "b") else i
            for i, p in enumerate(paths)]


@pytest.fixture(scope="module")
def jrt():
    return j_build_plan(j_get_reduced(ARCH), devices=jax.devices()[:1],
                        impl="ref").rt


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jparams = _random_tree(jplan_mod._params_struct(jcfg), 0)
    batch = jpipe.SyntheticLM(jpipe.DataConfig(
        vocab=jcfg.vocab, seq_len=S, global_batch=B), jcfg).batch(0)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, batch=batch,
                tparams=convert.from_jax_params(jparams, tcfg,
                                                device="cpu"))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The layers and the cross-attention
# ---------------------------------------------------------------------------

def test_layers_match_jax():
    """LayerNorm (fp32 statistics; in bf16 with the cast tree's bf16
    weight and bias), its init, the sinusoid table and the GELU MLP."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 5, 48)) + 1.0).astype(np.float32)
    p = {"w": (1 + 0.1 * rng.standard_normal(48)).astype(np.float32),
         "b": (0.1 * rng.standard_normal(48)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(
        tlayers.layernorm_apply(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.layernorm_apply(p, jnp.asarray(x))), atol=1e-6,
        rtol=1e-6)
    j16 = jlayers.layernorm_apply(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(x, jnp.bfloat16))
    t16 = tlayers.layernorm_apply({k: v.bfloat16() for k, v in tp.items()},
                                  torch.from_numpy(x).bfloat16())
    assert t16.dtype == torch.bfloat16
    np.testing.assert_array_equal(t16.float().numpy(),
                                  np.asarray(j16.astype(jnp.float32)))
    for k, v in jlayers.init_layernorm(48).items():
        np.testing.assert_array_equal(tlayers.init_layernorm(48)[k].numpy(),
                                      np.asarray(v))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            tlayers.sinusoid_positions(1536, 768, tdt).float().numpy(),
            np.asarray(jlayers.sinusoid_positions(1536, 768, jdt).astype(
                jnp.float32)))
    mlp = _random_tree(jax.eval_shape(lambda: jlayers.init_gelu_mlp(
        jax.random.PRNGKey(0), 48, 96)), 1)
    tmlp = {n: {"w": torch.from_numpy(v["w"].T.copy()),
                "b": torch.from_numpy(v["b"])} for n, v in mlp.items()}
    np.testing.assert_allclose(
        tlayers.gelu_mlp_apply(tmlp, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.gelu_mlp_apply(mlp, jnp.asarray(x))), atol=1e-6,
        rtol=1e-6)
    shapes = {n: {k: tuple(v.shape) for k, v in d.items()}
              for n, d in tlayers.init_gelu_mlp(torch.Generator(), 48,
                                                96).items()}
    assert shapes == {"fc1": {"w": (96, 48), "b": (96,)},
                      "fc2": {"w": (48, 96), "b": (48,)}}


def test_cross_attention_matches_jax():
    """The non-causal kernel call at Lq != Lk (48 queries over 80 keys,
    GQA 2) through the port's kernel path (fold, the plain versions)
    against the reference's Pallas kernels in interpret mode: out and
    lse within 2e-5, dq / dk / dv atol 5e-4 / rtol 1e-3 (the reference
    suite's kernel bounds).  ``cross_attn_apply``: 24 decoder queries
    over 40 encoder frames, 4 heads of 16, and the grads of ``sum(y *
    w)`` with respect to the leaves, x and the encoder output, against
    the reference's on Pallas interpret mode: y within 2e-5
    norm-relative (it leaves three fp32 projections as well as the
    kernel), grads atol 5e-4 / rtol 1e-3."""
    q, k, v = P._inputs((1, 48, 4, 32), (1, 80, 2, 32), 11)
    P._check(q, k, v, dict(causal=False), "float32")
    P._check_bwd(q, k, v, P._do(q.shape, 11), dict(causal=False), "float32")
    d, h, hd = 64, 4, 16
    rt = j_build_plan(j_get_reduced(ARCH), devices=jax.devices()[:1],
                      impl="pallas_interpret").rt
    p = _random_tree(jax.eval_shape(lambda: jattn.init_cross_attn(
        jax.random.PRNGKey(0), d, h, hd)), 2)
    assert sorted(p["wq"]) == ["b", "w"] and sorted(p["wk"]) == ["w"]
    rng = np.random.default_rng(3)
    x, enc = (rng.standard_normal((B, n, d)).astype(np.float32)
              for n in (24, 40))
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jf(p, x, enc):
        y = jattn.cross_attn_apply(p, x, enc, rt, n_heads=h, head_dim=hd)
        return (y * w).sum(), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                             has_aux=True))(p, x, enc)
    leaves = {n: {k: torch.from_numpy(v.T.copy() if k == "w" else v)
                  .requires_grad_() for k, v in lp.items()}
              for n, lp in p.items()}
    tx, tenc = (torch.from_numpy(a).requires_grad_() for a in (x, enc))
    y = tattn.cross_attn_apply(leaves, tx, tenc, CPU, n_heads=h,
                               head_dim=hd)
    (y * torch.from_numpy(w)).sum().backward()
    assert _rel(y.detach(), jy) < 2e-5
    got = [tx.grad, tenc.grad] + [
        leaves[n][k].grad.T if k == "w" else leaves[n][k].grad
        for n in sorted(p) for k in sorted(p[n])]
    want = [jg[1], jg[2]] + [jg[0][n][k] for n in sorted(p)
                             for k in sorted(p[n])]
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=5e-4,
                                   rtol=1e-3)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads(model, jrt):
    """The reference's loss and grads (its value does not depend on its
    remat; ``full`` compiles fastest), in the port's leaf order."""
    jcfg = dataclasses.replace(model["jcfg"], remat="full")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, jrt, jcfg), has_aux=True))(
            model["jparams"], jax.tree.map(jnp.asarray, model["batch"]))
    return float(jl), tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, jg), model["tcfg"], device="cpu"))[0]


@pytest.mark.parametrize("remat", REMAT)
def test_reduced_model_matches_jax(model, jax_grads, remat):
    """``forward_loss`` within 1e-5 relative and every grad leaf within
    1e-4 norm-relative (``_scale_index``) of ``jax.value_and_grad``'s,
    through the kernel path's plain versions."""
    jl, want = jax_grads
    cfg = dataclasses.replace(model["tcfg"], remat=remat)
    leaves, spec = tree_flatten(model["tparams"])
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    loss, metrics = forward_loss(tree_unflatten(leaves, spec),
                                 _torch_batch(model["batch"]), CPU, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - jl) <= 1e-5 * abs(jl)
    assert float(metrics["n_tokens"]) == B * S
    paths = convert.tree_paths(model["tparams"])
    scale = _scale_index(paths)
    assert sum(i != s for i, s in enumerate(scale)) == 4   # 2 enc + 2 dec
    for path, g, w, s in zip(paths, grads, want, scale):
        assert _rel(g, w, want[s]) < 1e-4, path


def test_remat_saved_sets():
    """What each remat mode keeps for the backward, told apart by depth
    (one more encoder and decoder layer): under ``full`` a layer keeps
    its input; under ``scpp`` an encoder layer keeps what a dense layer
    does (its input, held by both halves, ``attn_out`` and the kernels'
    folded q, k, v, out and lse), and a decoder layer both attention
    outputs: its self-attention's as the encoder's, and the
    cross-attention's output and its kernel's residuals (q and out over
    the decoder's rows, k and v over the frames), with the residual
    stream between the pieces and the encoder output its cross K/V are
    recomputed from."""
    base = get_reduced(ARCH)         # 4 heads of 16, 32 frames
    s = 48                           # rows apart from the frames

    def saved(remat, n):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        cfg = dataclasses.replace(base, remat=remat, num_layers=n,
                                  encoder_layers=n)
        leaves, spec = tree_flatten(init_params(
            cfg, torch.Generator().manual_seed(0)))
        tree = tree_unflatten([x.requires_grad_() for x in leaves], spec)
        batch = tpipe.SyntheticLM(tpipe.DataConfig(
            vocab=cfg.vocab, seq_len=s, global_batch=B), cfg).batch(0)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            forward_loss(tree, _torch_batch(batch), CPU, cfg)
        return collections.Counter(shapes)

    d, h, hd, f = base.d_model, base.n_heads, base.hd, base.enc_frames
    full = saved("full", 2) - saved("full", 1)
    # an encoder layer its input; a decoder layer its input and enc
    assert full == collections.Counter({(B, f, d): 2, (B, s, d): 1})
    pair = saved("scpp", 2) - saved("scpp", 1)
    enc = {(B, f, d): 3, (B * h, f, hd): 4, (B * h, f): 1}
    dec = {(B, s, d): 3 + 2, (B * h, s, hd): 4 + 2, (B * h, s): 2,
           (B * h, f, hd): 2, (B, f, d): 1}
    assert pair == collections.Counter(enc) + collections.Counter(dec)
    assert sum((saved("none", 2) - saved("none", 1)).values()) > 30


def test_prefill_and_decode_match_jax(model, jrt):
    """Prefill's last-token logits and every cache leaf (the decoder's
    self K/V, the cross K/V of the encoder output) within 1e-5 of the
    reference's; 8 decode steps within 1e-5 of its ``decode_step``; the
    last equal to a prefill of the longer prompt (the reference's
    ``test_decode_matches_incremental_forward``)."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    s, t = 16, 8
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tcfg.vocab, (B, s + t))
    frames = rng.standard_normal((B, tcfg.enc_frames,
                                  tcfg.d_model)).astype(np.float32)
    jpf = jax.jit(lambda p, x, f: jdecode.prefill(
        p, {"tokens": x, "frames": f}, jrt, jcfg))
    jstep = jax.jit(lambda p, c, x, pos: jdecode.decode_step(
        p, c, x, pos, jrt, jcfg))
    jl, jc = jpf(model["jparams"], jnp.asarray(tokens[:, :s], jnp.int32),
                 frames)
    tf = torch.from_numpy(frames)
    with torch.inference_mode():
        tl, tc = tdecode.prefill(model["tparams"], {
            "tokens": torch.from_numpy(tokens[:, :s]), "frames": tf}, CPU,
            tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        got, want = (convert.caches_to_numpy(tc),
                     jax.tree.map(np.asarray, jc))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        jc = jdecode.grow_caches(jcfg, jc, t)
        tc = tdecode.grow_caches(tcfg, tc, t)
        assert tc["cross"]["k"].shape[2] == tcfg.enc_frames
        assert tc["dec_blocks"]["k"].shape[2] == s + t
        for i in range(t):
            tok = tokens[:, s + i:s + i + 1]
            jl, jc = jstep(model["jparams"], jc, jnp.asarray(tok, jnp.int32),
                           jnp.int32(s + i))
            tl, tc = tdecode.decode_step(model["tparams"], tc,
                                         torch.from_numpy(tok), s + i, CPU,
                                         tcfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-5, rtol=1e-5)
        full, _ = tdecode.prefill(model["tparams"], {
            "tokens": torch.from_numpy(tokens), "frames": tf}, CPU, tcfg)
    np.testing.assert_allclose(tl.numpy(), full.numpy(), atol=1e-5,
                               rtol=1e-5)
    empty = tdecode.init_caches(tcfg, B, 40)
    assert jax.tree.map(lambda x: tuple(x.shape), empty) == jax.tree.map(
        lambda x: tuple(x.shape), jdecode.init_caches(jcfg, B, 40))


# ---------------------------------------------------------------------------
# Data, the cast, convert, the plan and the launchers
# ---------------------------------------------------------------------------

def test_frames_match_reference_and_packing_refuses():
    """``SyntheticLM``'s batches, frames included, byte for byte the
    reference's (one and two microbatches, a zigzag layout); each rank's
    shard on an 8-rank grid is its rows and, of the frames, the contiguous
    piece of the reference's ``P(batch, SEQ_AXES, None)`` beside its
    zigzag tokens; ``PackedLM`` and a packed plan refuse the family, as
    the reference asserts."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    for accum in (1, 2):
        kw = dict(vocab=tcfg.vocab, seq_len=64, global_batch=4, cp=2,
                  grad_accum=accum, seed=3)
        jb = jpipe.SyntheticLM(jpipe.DataConfig(**kw), jcfg).batch(5)
        dcfg = tpipe.DataConfig(**kw)
        tb = tpipe.SyntheticLM(dcfg, tcfg).batch(5)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and tb[k].shape == \
                jb[k].shape and tb[k].tobytes() == jb[k].tobytes(), k
    pc = ParallelConfig(dp=2, hp=2, cp_inner=2)
    for r in range(pc.num_devices):
        coord = rank_coords(pc, r)
        rows, piece = tpipe.rank_slices(dcfg, pc, coord)
        got = tpipe.SyntheticLM(dcfg, tcfg, shard=(rows, piece)).batch(5)
        frames = seq_slice(pc, coord, tcfg.enc_frames)
        np.testing.assert_array_equal(got["frames"],
                                      tb["frames"][:, rows, frames])
        np.testing.assert_array_equal(got["tokens"],
                                      tb["tokens"][:, rows, piece])
    with pytest.raises(ValueError, match="encoder-decoder"):
        tpipe.PackedLM(dcfg, tcfg)
    with pytest.raises(AssertionError):
        jpipe.PackedLM(jpipe.DataConfig(**kw), jcfg)
    with pytest.raises(ValueError, match="attention family"):
        tplan.build_plan(tcfg, device="cpu", packed=True)


def test_bf16_cast_and_decay_mask_match_jax(model, jrt):
    """In bf16 every leaf's dtype is the reference's ``cast_params_once``'s
    (the stacked ``(G, d)`` LayerNorm weights and biases and ``dec_pos``
    bf16, the unstacked ``enc_norm`` and ``final_norm`` fp32);
    ``init_params(cast=True)`` gives the same tree bit for bit;
    ``decay_mask`` is the reference's two-dims rule on its stacked tree;
    the bf16 loss lies within 2e-2 of the reference's."""
    jcfg = dataclasses.replace(model["jcfg"], dtype="bfloat16")
    tcfg = dataclasses.replace(model["tcfg"], dtype="bfloat16")
    jcast = jax.eval_shape(lambda p: j_cast_params_once(p, jcfg),
                           model["jparams"])
    shapes = convert.ref_param_shapes(tcfg)
    seen = {}
    for ref, path, x, decay in zip(
            convert.ref_leaf_map(tcfg), convert.tree_paths(model["tparams"]),
            tree_flatten(cast_params_once(model["tparams"], tcfg))[0],
            convert.decay_mask(tcfg)):
        leaf = jcast
        for k in ref.path:
            leaf = leaf[k]
        want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 else \
            torch.float32
        assert x.dtype == want, path
        assert decay == (len(shapes[ref.path]) >= 2), path
        seen[path[2:] if path[0].endswith("_layers") else path] = x.dtype
    assert seen["ln1", "b"] == seen["lnx", "w"] == torch.bfloat16
    assert seen["dec_pos", "table"] == torch.bfloat16
    assert seen["enc_norm", "w"] == seen["final_norm", "b"] == torch.float32
    lazy = init_params(tcfg, torch.Generator().manual_seed(3), cast=True)
    eager = cast_params_once(init_params(
        tcfg, torch.Generator().manual_seed(3)), tcfg)
    for a, b in zip(tree_flatten(lazy)[0], tree_flatten(eager)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jl, _ = jax.jit(lambda p, b: j_forward_loss(p, b, jrt, jcfg))(
        model["jparams"], jax.tree.map(jnp.asarray, model["batch"]))
    with torch.no_grad():
        loss, _ = forward_loss(model["tparams"],
                               _torch_batch(model["batch"]), CPU, tcfg)
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))


def test_convert_and_full_config(model):
    """``to_jax_params`` inverts ``from_jax_params`` bit for bit; on the
    full config the reference's shapes (``enc_blocks`` / ``dec_blocks``
    stacked, ``enc_norm`` / ``dec_pos`` not) and its ``_param_count``
    from ``jax.eval_shape``, nothing allocated; the configs field for
    field; ``require_ported`` admits the family."""
    back = convert.to_jax_params(model["tparams"], model["tcfg"])
    assert jax.tree.structure(back) == jax.tree.structure(model["jparams"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(model["jparams"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for jcfg, tcfg in ((j_get_config(ARCH), get_config(ARCH)),
                       (model["jcfg"], model["tcfg"])):
        struct = {tuple(_key(k) for k in p): x.shape
                  for p, x in jax.tree_util.tree_flatten_with_path(
                      jplan_mod._params_struct(jcfg))[0]}
        assert convert.ref_param_shapes(tcfg) == struct
        assert convert.param_count(tcfg) == jplan_mod._param_count(jcfg)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        require_ported(tcfg)
    refs = dict(zip(convert.tree_paths(model["tparams"]),
                    convert.ref_leaf_map(model["tcfg"])))
    assert refs["dec_layers", 1, "cross", "wk", "w"] == convert.RefLeaf(
        ("dec_blocks", "cross", "wk", "w"), (1,), True)
    assert refs["enc_norm", "b"].idx == ()


def test_plan_memory_and_zero_specs(monkeypatch):
    """``plan_memory`` equals the reference's for the full and reduced
    configs on two grids under three ZeRO modes; under ``dp_sp`` the big
    stacked leaves shard along a feature dim and each port leaf gets its
    place; ``describe`` names the encoder; a plan whose grid does not
    divide the frames is refused."""
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
    for ref, (path, shape) in zip(convert.ref_leaf_map(tcfg),
                                  convert.port_leaves(tcfg)):
        place = tzero._place(ref, shapes[ref.path], specs[ref.path], mesh,
                             shape)
        if path[-2:] in (("fc1", "w"), ("wq", "w")):
            assert place.axes and place.dim is not None, path
    plan = tplan.build_plan(get_reduced(ARCH), device="cpu", seq_len=S,
                            global_batch=B)
    assert "encoder     layers=2 frames=32" in plan.describe()
    with pytest.raises(ValueError, match="frames"):
        tplan.build_plan(dataclasses.replace(get_reduced(ARCH),
                                             enc_frames=30),
                         ParallelConfig(hp=4), device="cpu")


def test_checkpoint_read_by_jax(tmp_path):
    """A checkpoint of reduced whisper's trainer state, written through
    ``ref_leaf_map`` (``enc_blocks`` / ``dec_blocks`` stacked), is read by
    JAX's ``restore`` bit for bit, and restored by the port into another
    state."""
    cfg = get_reduced(ARCH)
    plan = tplan.build_plan(cfg, device="cpu", impl="plain", seq_len=S,
                            global_batch=B)
    params = init_params(cfg, torch.Generator().manual_seed(4))
    opt = init_opt_state(params)
    for i, x in enumerate(tree_flatten(opt["v"])[0]):
        x.fill_(0.25 + i)
    opt["step"] = 2
    d = str(tmp_path / "c")
    ckpt.CheckpointManager(d, plan=plan).save({"params": params,
                                               "opt": opt}, 2)
    struct = jplan_mod._params_struct(j_get_reduced(ARCH))
    got, step = jckpt.restore(
        {"params": struct, "opt": {"m": struct, "v": struct, "step":
                                   jax.ShapeDtypeStruct((), jnp.int32)}},
        d, step=2)
    want = {"params": convert.to_jax_params(params, cfg),
            "opt": {"m": convert.to_jax_params(opt["m"], cfg),
                    "v": convert.to_jax_params(opt["v"], cfg),
                    "step": np.asarray(2, np.int32)}}
    assert step == 2
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    other = init_params(cfg, torch.Generator().manual_seed(5))
    state, _ = ckpt.CheckpointManager(d, plan=plan).restore(
        {"params": other, "opt": init_opt_state(other)}, step=2)
    for a, b in zip(tree_flatten(state)[0],
                    tree_flatten({"params": params, "opt": opt})[0]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_registry_and_launchers(capsys):
    """The arch resolves in both registries' forms, and both launchers
    run the reduced model on the CPU: three trainer steps of two
    microbatches with finite losses (``--layers`` cuts the encoder with
    the decoder), and a fixed-batch generate over frames drawn from the
    seed."""
    assert get_config(ARCH).family == get_reduced(ARCH).family == "encdec"
    losses = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "3", "--seq-len", "32",
                           "--global-batch", "2", "--grad-accum", "2",
                           "--layers", "1"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "whisper-smoke [encdec]" in out and "layers=1 frames=32" in out
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--prompt-len", "16", "--gen", "3"])
    assert "generated 6 tokens" in capsys.readouterr().out
