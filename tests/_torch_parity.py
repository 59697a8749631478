"""Shared parity helpers for the port's flash-attention tests: the cases,
their inputs (made with numpy from a seed) and the comparisons against the
JAX package's Pallas kernels in interpret mode, forward and backward."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SWEEP = [
    # b, lq, lk, hq, hkv, d, causal, window, softcap (tests/test_kernels.py)
    (2, 64, 64, 4, 4, 32, True, None, 0.0),
    (1, 48, 80, 4, 2, 24, True, None, 0.0),
    (1, 33, 100, 6, 3, 40, True, None, 0.0),
    (2, 16, 96, 4, 4, 32, True, None, 0.0),
    (1, 32, 32, 2, 2, 16, False, None, 30.0),
    (2, 64, 64, 4, 1, 32, True, 16, 0.0),
    (1, 64, 64, 8, 2, 64, True, 8, 25.0),
    (1, 128, 128, 2, 2, 128, True, None, 0.0),
]

# The extra cases: name -> (b, lq, lk, hq, hkv, d, keyword arguments).
# ``zigzag`` is ring step (i=1, j=2) of cp=4 over chunks of 8 (split q_seg
# and k_seg); ``kv_valid`` cuts the keys without re-anchoring the band;
# ``doc`` packs three documents, with the K-tile skip on and off.
_DOC = np.repeat(np.array([0, 20, 52]), [20, 32, 28])[None].repeat(2, 0)
EXTRA = {
    "zigzag": (1, 16, 16, 4, 2, 16,
               dict(causal=True, band=("zigzag", 1, 2, 8, 4))),
    "zigzag_diag": (1, 16, 16, 4, 2, 16,
                    dict(causal=True, window=6,
                         band=("zigzag", 2, 2, 8, 4))),
    "kv_valid": (2, 40, 64, 4, 2, 32, dict(causal=True, kv_valid_len=41)),
    "doc_skip": (2, 80, 80, 4, 2, 32,
                 dict(causal=True, q_doc_start=_DOC, doc_skip=True)),
    "doc_noskip": (2, 80, 80, 4, 2, 32,
                   dict(causal=True, q_doc_start=_DOC, doc_skip=False)),
}

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


def _kw_for(kw, band_cls):
    kw = dict(kw)
    if "band" in kw:
        _, i, j, c, cp = kw["band"]
        kw["band"] = band_cls.zigzag(i, j, c, cp)
    return kw


def _compare(name, o_t, lse_t, o_j, lse_j, tol):
    o_j = np.asarray(jnp.asarray(o_j, jnp.float32))
    lse_j = np.asarray(lse_j)
    np.testing.assert_allclose(o_t.float().numpy(), o_j, atol=tol, rtol=tol,
                               err_msg=f"{name}: out")
    seen = lse_j > jref.NEG_INF / 2
    assert ((lse_t.numpy() > tref.NEG_INF / 2) == seen).all(), name
    np.testing.assert_allclose(np.where(seen, lse_t.numpy(), 0.0),
                               np.where(seen, lse_j, 0.0),
                               atol=tol, rtol=tol, err_msg=f"{name}: lse")


def _check(q, k, v, kw, dtype):
    """Port (folded plain path and ref path) vs JAX Pallas interpret."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    o_j, lse_j = jops.flash_fwd_chunk(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        impl="pallas_interpret", block_q=64, block_k=64,
        **_kw_for(kw, jref.BandMask))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tkw = _kw_for(kw, tref.BandMask)
    before = tfa.FWD_LAUNCHES
    o_p, lse_p = tops._fwd_chunk_folded(tq, tk, tv, **tkw)
    assert o_p.dtype == tdt and lse_p.dtype == torch.float32
    assert tfa.FWD_LAUNCHES == before      # the plain version launches nothing
    _compare("plain", o_p, lse_p, o_j, lse_j, TOL[dtype])
    o_r, lse_r = tops.flash_fwd_chunk(tq, tk, tv, impl="ref", **tkw)
    _compare("ref", o_r, lse_r, o_j, lse_j, TOL[dtype])


BWD_TOL = {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}


def _do(shape_q, seed):
    """An output cotangent for ``_check_bwd``, from numpy."""
    return np.random.default_rng(seed + 1000).standard_normal(
        shape_q).astype(np.float32)


def _check_bwd(q, k, v, do, kw, dtype):
    """The port's chunk backward (folded plain path and ref path) against
    JAX ``flash_bwd_chunk`` in Pallas interpret mode and the JAX oracle,
    from the same global ``(out, lse)`` (the JAX oracle's forward).  The
    JAX calls are jitted with the mask arguments bound, which compiles each
    once instead of op by op."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jkw = _kw_for(kw, jref.BandMask)
    ref_kw = {k_: v_ for k_, v_ in jkw.items() if k_ != "doc_skip"}
    out, lse = jax.jit(functools.partial(jref.attention_ref, **ref_kw))(
        jq, jk, jv)
    want = {
        "pallas": jax.jit(functools.partial(
            jops.flash_bwd_chunk, impl="pallas_interpret", **jkw))(
                jq, jk, jv, out, lse, jdo),
        "jax-ref": jax.jit(functools.partial(
            jref.attention_bwd_ref, **ref_kw))(jq, jk, jv, out, lse, jdo)}
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tout = torch.from_numpy(np.array(out.astype(jnp.float32))).to(tdt)
    tlse = torch.from_numpy(np.array(lse))
    tkw = _kw_for(kw, tref.BandMask)
    before = (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    got = {
        "plain": tops.flash_bwd_chunk(tq, tk, tv, tout, tlse, tdo,
                                      impl="plain", **tkw),
        "ref": tops.flash_bwd_chunk(tq, tk, tv, tout, tlse, tdo,
                                    impl="ref", **tkw)}
    assert (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == before
    atol, rtol = BWD_TOL[dtype]
    for gname, grads in got.items():
        for t, ref_t in zip(grads, (tq, tk, tv)):
            assert t.dtype == tdt and t.shape == ref_t.shape, gname
        for wname, wgrads in want.items():
            for label, t, w in zip(("dq", "dk", "dv"), grads, wgrads):
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(w.astype(jnp.float32)),
                    atol=atol, rtol=rtol,
                    err_msg=f"{gname} vs {wname}: {label}")
