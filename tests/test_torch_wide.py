"""The port at head dims above 128 against the JAX package, in fp32 on the
CPU: the plain versions of the three kernels through the public ops
(``flash_fwd_chunk``, ``flash_bwd_chunk`` and ``flash_attention`` with
``impl="plain"``) against the reference's Pallas kernels in interpret mode
at D 192 (deepseek-v2-lite MLA's d_qk), 240 (gemma3-12b) and 288
(gemma2-2b), the backward also in bf16 at head dim 320 (padded to 384),
and gemma2-2b's model: ``forward_loss`` and every grad leaf
of the reduced config and of the same config at ``head_dim=288`` against
``jax.value_and_grad`` (1e-5), and the full config field for field.

The reference pads D to a multiple of 128 (384 for 288); the port pads to
the next width its kernels are built for (``KERNEL_D``: 192, 256, 288,
384), so the two zero-pad differently and must still agree.  Tolerances
are the reference suite's: forward 2e-5, backward atol 5e-4 / rtol 1e-3,
bf16 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from _torch_parity import D320, _check, _check_bwd, _do, _inputs
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core.plan import build_plan as j_build_plan
from repro.kernels import ops as jops
from repro.models.model import forward_loss as j_forward_loss
from repro.models.model import init_params as j_init_params
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.runtime import Runtime
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models.model import forward_loss

torch.set_num_threads(2)

ARCH = "gemma2-2b"
# d -> (b, lq, lk, hq, hkv, keyword arguments): GQA group 2 throughout, a
# ragged length, softcap 50 and a window shorter than L.
WIDE = {
    192: (1, 96, 128, 4, 2, dict(causal=True, softcap=50.0)),
    240: (2, 72, 72, 4, 2, dict(causal=True, window=24)),
    288: (1, 128, 128, 4, 2, dict(causal=True, window=40, softcap=50.0)),
}


def _case(d):
    b, lq, lk, hq, hkv, kw = WIDE[d]
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=d)
    return q, k, v, kw


@pytest.mark.parametrize("d", sorted(WIDE))
def test_wide_fwd_matches_pallas(d):
    """``flash_fwd_chunk``'s folded plain path (and the ref path) against
    the reference's Pallas forward in interpret mode."""
    q, k, v, kw = _case(d)
    _check(q, k, v, kw, "float32")


@pytest.mark.parametrize("d", sorted(WIDE))
def test_wide_bwd_matches_pallas(d):
    """``flash_bwd_chunk`` with ``impl="plain"`` (and ``"ref"``) against
    the reference's Pallas dq and dk/dv in interpret mode, from the same
    global ``(out, lse)``."""
    q, k, v, kw = _case(d)
    _check_bwd(q, k, v, _do(q.shape, d), kw, "float32")


@pytest.mark.parametrize("name", list(D320))
def test_wide_bwd_bf16_d320_matches_pallas(name):
    """``flash_bwd_chunk`` with ``impl="plain"`` (and ``"ref"``) in bf16 at
    head dim 320, which the port pads to 384 and a CUDA call sends to the
    sm90w route's dq and dk/dv, against the reference's Pallas dq and dk/dv
    in interpret mode (2e-2, as ``tests/test_kernels.py::test_dtypes``)."""
    b, lq, lk, hq, hkv, kw = D320[name]
    assert tops._d_pad(320) == 384
    assert [tfa.bwd_route(torch.bfloat16, 384, which)
            for which in ("dq", "dkv")] == ["sm90w", "sm90w"]
    q, k, v = _inputs((b, lq, hq, 320), (b, lk, hkv, 320), seed=lq + 321)
    _check_bwd(q, k, v, _do(q.shape, lq), kw, "bfloat16")


def test_wide_autograd_matches_jax_grad():
    """``torch.autograd.grad`` through ``_FlashFolded`` at D 288 (padded to
    288 here, 384 in the reference) against ``jax.grad`` of the
    reference's ``flash_attention`` on its Pallas kernels in interpret
    mode (GQA, window, softcap)."""
    q, k, v, kw = _case(288)
    do = _do(q.shape, 7)

    def j_loss(q, k, v):
        out = jops.flash_attention(q, k, v, impl="pallas_interpret", **kw)
        return jnp.sum(out * do)

    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, impl="plain", **kw)
    tg = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-4,
                                   rtol=1e-3)


def test_wide_padding_and_routes():
    """Every head dim up to 384 pads to a built width.  Above 128, bf16's
    forward, dq and dk/dv take the sm90w tensor-core route at every width
    (384 in their own sources); fp32's forward, dq and dk/dv the 3xTF32
    tf32x3w route; the tf32x3 route keeps D <= 128."""
    pads = {d: tops._d_pad(d) for d in range(129, 385)}
    assert set(pads.values()) == set(tfa.WIDE_D)
    assert all(d <= p and p - d < 96 for d, p in pads.items())
    assert (tops._d_pad(192), tops._d_pad(240), tops._d_pad(288),
            tops._d_pad(320)) == (192, 256, 288, 384)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops._d_pad(385)
    assert set(tfa.SM90W_BWD_D) == {tops._d_pad(d)
                                    for d in (192, 240, 288, 320)}
    assert set(tfa.SM90W_FWD_D) == set(tfa.SM90W_BWD_D) == set(tfa.WIDE_D)
    for d in tfa.WIDE_D:
        assert tfa.fwd_route(torch.float32, d) == "tf32x3w"
        assert tfa.fwd_route(torch.bfloat16, d) == "sm90w"
        for which in ("dq", "dkv"):
            assert tfa.bwd_route(torch.bfloat16, d, which) == "sm90w"
            assert tfa.bwd_route(torch.float32, d, which) == "tf32x3w"
    assert max(tfa.TF32X3_D) == 128


def _batch(vocab: int, b: int = 2, s: int = 32, seed: int = 0):
    """Tokens, labels with a padded tail (-1) and positions, as numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": labels,
            "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                         (b, s)).copy()}


@pytest.mark.parametrize("head_dim", [0, 288], ids=["reduced", "hd288"])
def test_gemma2_loss_and_grads_match_jax(head_dim):
    """Reduced gemma2-2b (4 layers: local window 16 and global layers,
    attention softcap 50, final softcap 30, post-norms, embedding scale,
    tanh-GELU), as it is and with ``head_dim=288`` set on both sides:
    ``forward_loss`` and every grad leaf against
    ``jax.value_and_grad(forward_loss)`` at 1e-5, the port through the
    kernel path with the plain versions (remat scpp).  32 tokens against a
    window of 16, so the local layers cut."""
    jcfg = dataclasses.replace(j_get_reduced(ARCH), head_dim=head_dim)
    tcfg = dataclasses.replace(get_reduced(ARCH), head_dim=head_dim)
    assert tcfg.hd == jcfg.hd == (head_dim or 16)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    assert "pn1" in tparams["layers"][0] and "pn2" in tparams["layers"][3]
    batch = _batch(tcfg.vocab)
    plan = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, plan.rt, jcfg), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, batch))
    leaves, spec = tree_flatten(tparams)
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    calls = (tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    loss, _ = forward_loss(spec.unflatten(leaves), tb,
                           Runtime(impl="plain", device="cpu"), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert (tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == calls
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5, rtol=1e-5)
    want = tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu"))[0]
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_gemma2_config_matches_reference():
    """gemma2-2b's full and reduced configs field for field against the
    reference; the full one has head dim 288, which pads to itself."""
    fields = [f.name for f in dataclasses.fields(get_config(ARCH))]
    for jc, tc in ((j_get_config(ARCH), get_config(ARCH)),
                   (j_get_reduced(ARCH), get_reduced(ARCH))):
        for f in fields + ["hd", "period"]:
            assert getattr(tc, f) == getattr(jc, f), f
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.hd, cfg.n_heads,
            cfg.n_kv_heads, cfg.window, cfg.window_pattern) == \
        (26, 2304, 288, 8, 4, 4096, 2)
    assert tops._d_pad(cfg.hd) == 288
    assert [cfg.attn_kind(i).window for i in range(2)] == [4096, None]
