"""The port's layer functions (``repro_torch.models.layers``) against the
JAX package's (``repro.models.layers``) at 1e-6, fp32, on inputs made with
numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(2)

TOL = dict(atol=1e-6, rtol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


def test_rmsnorm():
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal(16)).astype(np.float32)
    _close(tl.rmsnorm_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x)),
           jl.rmsnorm_apply({"w": jnp.asarray(w)}, jnp.asarray(x)))


def test_layernorm_nonparametric():
    x = (3 + _rng(2).standard_normal((4, 7, 32))).astype(np.float32)
    _close(tl.layernorm_nonparametric(torch.from_numpy(x)),
           jl.layernorm_nonparametric(jnp.asarray(x)))


@pytest.mark.parametrize("bias", [False, True])
def test_linear_takes_transposed_weight(bias):
    rng = _rng(3)
    x = rng.standard_normal((2, 6, 24)).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32)     # (d_in, d_out)
    jp, tp = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w.T.copy())}
    if bias:
        b = rng.standard_normal(40).astype(np.float32)
        jp["b"], tp["b"] = jnp.asarray(b), torch.from_numpy(b)
    _close(tl.linear_apply(tp, torch.from_numpy(x)),
           jl.linear_apply(jp, jnp.asarray(x)))


@pytest.mark.parametrize("scale", [None, 8.0])
def test_embedding(scale):
    rng = _rng(4)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7))
    _close(tl.embedding_apply({"table": torch.from_numpy(table)},
                              torch.from_numpy(ids), dtype=torch.float32,
                              scale=scale),
           jl.embedding_apply({"table": jnp.asarray(table)},
                              jnp.asarray(ids), dtype=jnp.float32,
                              scale=scale))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rotary_cos_sin(theta):
    pos = np.stack([np.arange(0, 4096, 37), np.arange(5, 4101, 37)])
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        cj, sj = jl.rotary_cos_sin(jnp.asarray(pos, jnp.int32), 128,
                                   theta=theta, dtype=jdt)
        ct, st = tl.rotary_cos_sin(torch.from_numpy(pos), 128, theta=theta,
                                   dtype=tdt)
        assert ct.dtype == tdt and ct.shape == cj.shape
        if tdt == torch.float32:
            _close(ct, cj)
            _close(st, sj)
        else:   # the same fp32 angles round to the same bf16 values
            np.testing.assert_array_equal(
                ct.float().numpy(), np.asarray(cj, np.float32))
            np.testing.assert_array_equal(
                st.float().numpy(), np.asarray(sj, np.float32))


def test_apply_rotary():
    rng = _rng(5)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(9)[None].repeat(2, 0) + np.array([[0], [100]])
    cj, sj = jl.rotary_cos_sin(jnp.asarray(pos), 32, theta=1e6)
    ct, st = tl.rotary_cos_sin(torch.from_numpy(pos), 32, theta=1e6)
    _close(tl.apply_rotary(torch.from_numpy(x), ct, st),
           jl.apply_rotary(jnp.asarray(x), cj, sj))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_mlp(act):
    rng = _rng(6)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    ws = {n: (0.25 * rng.standard_normal(s)).astype(np.float32)
          for n, s in (("w1", (16, 48)), ("w3", (16, 48)), ("w2", (48, 16)))}
    jp = {n: {"w": jnp.asarray(w)} for n, w in ws.items()}
    tp = {n: {"w": torch.from_numpy(w.T.copy())} for n, w in ws.items()}
    _close(tl.glu_mlp_apply(tp, torch.from_numpy(x), act=act),
           jl.glu_mlp_apply(jp, jnp.asarray(x), act=act))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = (40 * _rng(7).standard_normal((3, 64))).astype(np.float32)
    _close(tl.softcap(torch.from_numpy(x), cap),
           jl.softcap(jnp.asarray(x), cap))
