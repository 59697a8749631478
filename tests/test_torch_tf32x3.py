"""The arithmetic of the fp32 3xTF32 kernels, emulated in torch on the CPU
against the JAX package's Pallas kernels run in interpret mode: the
forward (``src/repro_torch/kernels/csrc/flash_fwd_tf32x3.cu`` up to D 128,
``flash_fwd_tf32x3_wide.cu`` above it) against ``_fwd`` through
``flash_fwd_chunk(impl="pallas_interpret")`` at 2e-5 elementwise, 2e-5
norm-relative and lse within 1e-4 (the fp32 bounds of ``chip_smoke.py``
phase 2), and the dq and dk/dv (``flash_bwd_tf32x3.cu``,
``flash_bwd_tf32x3_wide.cu``) against ``_bwd`` through
``flash_bwd_chunk(impl="pallas_interpret")`` at the reference suite's
backward tolerance (atol 5e-4, rtol 1e-3:
``tests/test_kernels.py::test_bwd_matches_oracle``) and 2e-5 norm-relative
(the fp32 bound of phase 3).

The kernels run only on the card.  This emulates what they compute: each
fp32 operand x is split into hi = x rounded to TF32 (to nearest, ties away
from zero, done on the int32 bits as the kernel does) and lo = x - hi with
its low 13 bits cleared, and each product is the fp32 sum hi.lo + lo.hi +
hi.hi.  The backward's first products (S, dP) sum 128 columns (16 k steps)
at a time in a fresh sum and add those in fp32, as both kernels do (up to
D 128 that is the whole contraction); above D 128 the wide kernels split
each such chunk's 16 k steps of 8 columns into two sums, the even k steps
and the odd ones, and add ``x += even + odd``.  The forward's S is one
fresh sum up to D 128; above it the contraction is cut into two halves,
each summed like the backward's wide first products, and the halves are
added.  The forward walks the keys in stages (32 up to D 128, 16 above)
with the online softmax: P.V sums one stage in a fresh sum,
then O = O * alpha + part in fp32.  (The order of the products inside one
sum is torch's, not the tensor core's.)  So it shows on the CPU that the
scheme holds the reference's fp32 tolerances, also at gemma2-2b's head dim
288 with its softcap and window and at head dim 320 (padded to 384).  One
TF32 pass (hi.hi alone, ``passes=1``) does not: on the causal D=128 case
the backward's dq, dk and dv miss atol 5e-4 / rtol 1e-3 (up to 1.87e-3
off) and lie 4.0e-4 to 5.6e-4 norm-relative from the reference, 20-28
times the 2e-5 bound (three passes: at most 2.9e-6 off and 6.6e-7
norm-relative); the forward's out is up to 1.06e-3 off and 3.5e-4
norm-relative from the reference (18 times the 2e-5 bound) and its lse up
to 4.2e-4 off (bound 1e-4), where three passes lie 1.1e-6, 3.9e-7 and
9.5e-7 off.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import BWD_TOL, EXTRA, SWEEP, _do, _inputs, _kw_for
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
REL_TOL = 2e-5
FWD_TOL, LSE_TOL = 2e-5, 1e-4
COLUMNS = 128           # columns of the first products a fresh sum holds
MASK = -0x2000          # 0xffffe000 as an int32: clears the low 13 bits


def _tf32_rna(x):
    """x rounded to TF32, to nearest with ties away from zero, on the bits:
    adding half a TF32 ulp to the sign-and-magnitude word rounds the
    magnitude."""
    return ((x.view(torch.int32) + 0x1000) & MASK).view(torch.float32)


def _split(x):
    """(hi, lo) as the kernel splits ``x``: x - hi - lo is at most 2^-22
    of |x|."""
    hi = _tf32_rna(x)
    lo = ((x - hi).view(torch.int32) & MASK).view(torch.float32)
    return hi, lo


def _product(eq, a, b, passes=3, chunk=None, interleave=False):
    """``einsum(eq, a, b)`` as the kernel forms it: hi.lo + lo.hi + hi.hi
    in fp32 (``passes=1``: hi.hi alone, one TF32 pass).  ``chunk``: the
    contraction, the last axis of both operands, taken ``chunk`` columns at
    a time, each chunk's sum added to the others in fp32; ``interleave``:
    each chunk summed as two sums, its even and its odd k steps of 8
    columns, added together before the chunk joins the others."""
    if chunk is not None and (a.shape[-1] > chunk or interleave):
        out = None
        for c0 in range(0, a.shape[-1], chunk):
            ac, bc = a[..., c0:c0 + chunk], b[..., c0:c0 + chunk]
            if interleave:
                step = torch.arange(ac.shape[-1]) // 8 % 2
                even, odd = (_product(eq, ac[..., step == e],
                                      bc[..., step == e], passes)
                             for e in (0, 1))
                part = even + odd
            else:
                part = _product(eq, ac, bc, passes)
            out = part if out is None else out + part
        return out
    (ah, al), (bh, bl) = _split(a), _split(b)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        out = (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)) + out
    return out


def _bwd_tf32x3(qf, kf, vf, out, lse, dof, p, band, doc, passes=3):
    """``flash_attention._bwd_plain`` with every product formed as the
    kernels form it; fp32 folded operands, the same ``(dq, dk, dv)``."""
    bh, lq, d = qf.shape
    bhkv, lk, _ = kf.shape
    group = bh // bhkv
    kr, vr = (x.repeat_interleave(group, dim=0) for x in (kf, vf))
    product = functools.partial(_product, passes=passes)
    first = functools.partial(product, chunk=COLUMNS, interleave=d > 128)
    dsum = (dof * out).sum(dim=-1)
    s = first("bqd,bkd->bqk", qf, kr) * p.scale
    if p.softcap:
        s = p.softcap * torch.tanh(s / p.softcap)
    mask = tfa._plain_mask(p, band, doc, bh, lq, lk, qf.device)
    shift = torch.where(lse <= tref.NEG_INF / 2, 0.0, lse)
    pmat = torch.where(mask, torch.exp(s - shift[..., None]), 0.0)
    dp = first("bqd,bkd->bqk", dof, vr)
    ds = pmat * (dp - dsum[..., None])
    if p.softcap:
        ds = ds * (1.0 - (s / p.softcap) ** 2)
    ds = ds * p.scale
    dq = product("bqk,bkd->bqd", ds, kr)
    dk = product("bqk,bqd->bkd", ds, qf).reshape(bhkv, group, lk, d).sum(1)
    dv = product("bqk,bqd->bkd", pmat, dof).reshape(bhkv, group, lk, d)
    return dq, dk, dv.sum(1)


def _fwd_scores(qf, kr, passes):
    """S = Q.K^T as the forward kernels sum it: up to D 128 one fresh sum
    (D / 8 <= 16 k steps); above, the contraction in two halves (one a
    warp), each summed ``COLUMNS`` at a time as two interleaved sums, the
    halves added in fp32."""
    d = qf.shape[-1]
    if d <= 128:
        return _product("bqd,bkd->bqk", qf, kr, passes)
    w = d // 2
    out = None
    for c0 in range(0, d, w):
        part = _product("bqd,bkd->bqk", qf[..., c0:c0 + w],
                        kr[..., c0:c0 + w], passes, chunk=COLUMNS,
                        interleave=True)
        out = part if out is None else out + part
    return out


def _fwd_tf32x3(qf, kf, vf, p, band, doc, passes=3):
    """``flash_attention._fwd_plain`` as the kernels compute it: S formed
    as they form it, then the online softmax over stages of keys (32 up to
    D 128, 16 above), O = O * alpha + P.V with each stage's P.V a fresh
    3xTF32 sum; fp32 folded operands, the same ``(out, lse)``."""
    bh, lq, d = qf.shape
    bhkv, lk, _ = kf.shape
    group = bh // bhkv
    kr, vr = (x.repeat_interleave(group, dim=0) for x in (kf, vf))
    s = _fwd_scores(qf, kr, passes) * p.scale
    if p.softcap:
        s = p.softcap * torch.tanh(s * (1.0 / p.softcap))
    s = torch.where(tfa._plain_mask(p, band, doc, bh, lq, lk, qf.device), s,
                    tref.NEG_INF)
    m = torch.full((bh, lq), tref.NEG_INF)
    l, o = torch.zeros(bh, lq), torch.zeros(bh, lq, d)
    keys = 32 if d <= 128 else 16
    for k0 in range(0, lk, keys):
        st = s[..., k0:k0 + keys]
        m_new = torch.maximum(m, st.amax(dim=-1))
        shift = torch.where(m_new <= tref.NEG_INF / 2, 0.0, m_new)
        alpha = torch.where(m <= tref.NEG_INF / 2, 0.0, torch.exp(m - shift))
        pst = torch.exp(st - shift[..., None])
        l = l * alpha + pst.sum(dim=-1)
        o = o * alpha[..., None] + _product(
            "bqk,bkd->bqd", pst, vr[:, k0:k0 + keys], passes)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    lse = torch.where(l == 0.0, tref.NEG_INF,
                      torch.where(m <= tref.NEG_INF / 2, 0.0, m)
                      + torch.log(l_safe))
    return o / l_safe[..., None], lse


def _fwd_errors(case, passes=3):
    """(max |out err|, out norm-relative err, max |lse err| on the rows
    that see a key, whether the same rows see one) of the emulated forward
    against the Pallas forward in interpret mode."""
    b, lq, lk, hq, hkv, d, kw = case
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=lq * 7 + d)
    o_j, lse_j = jax.jit(functools.partial(
        jops.flash_fwd_chunk, impl="pallas_interpret",
        **_kw_for(kw, jref.BandMask)))(*(jnp.asarray(x) for x in (q, k, v)))
    qf, kf, vf, p, band, doc = tops._fold_chunk_args(
        *(torch.from_numpy(x) for x in (q, k, v)),
        **_kw_for(kw, tref.BandMask))
    out, lse = _fwd_tf32x3(qf, kf, vf, p, band, doc, passes)
    got, want = tops._unfold(out, b, hq, lq, d).numpy(), np.asarray(o_j)
    lse, lse_j = lse.reshape(b, hq, lq).numpy(), np.asarray(lse_j)
    seen = lse_j > jref.NEG_INF / 2
    return (float(np.abs(got - want).max()),
            float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            float(np.abs(np.where(seen, lse - lse_j, 0.0)).max()),
            bool(((lse > tref.NEG_INF / 2) == seen).all())
            and bool(np.allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)))


def _errors(case, passes=3):
    """[(label, max |err|, norm-relative err, allclose)] of the emulated
    kernels against the Pallas kernels in interpret mode."""
    b, lq, lk, hq, hkv, d, kw = case
    seed = lq * 7 + d
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=seed)
    do = _do(q.shape, seed)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jkw = _kw_for(kw, jref.BandMask)
    ref_kw = {k_: v_ for k_, v_ in jkw.items() if k_ != "doc_skip"}
    out, lse = jax.jit(functools.partial(jref.attention_ref, **ref_kw))(
        jq, jk, jv)
    want = jax.jit(functools.partial(
        jops.flash_bwd_chunk, impl="pallas_interpret", **jkw))(
            jq, jk, jv, out, lse, jdo)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    qf, kf, vf, p, band, doc = tops._fold_chunk_args(
        tq, tk, tv, **_kw_for(kw, tref.BandMask))
    d_pad = qf.shape[2]
    got = _bwd_tf32x3(qf, kf, vf,
                      tops._fold_pad(torch.from_numpy(np.array(out)), d_pad),
                      torch.from_numpy(np.array(lse)).reshape(b * hq, lq),
                      tops._fold_pad(tdo, d_pad), p, band, doc, passes)
    got = (tops._unfold(got[0], b, hq, lq, d),
           *(tops._unfold(x, b, hkv, lk, d) for x in got[1:]))
    atol, rtol = BWD_TOL["float32"]
    rows = []
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.numpy(), np.asarray(w)
        rows.append((label, float(np.abs(g - w).max()),
                     float(np.linalg.norm(g - w) / np.linalg.norm(w)),
                     bool(np.allclose(g, w, atol=atol, rtol=rtol))))
    return rows


CASES = {
    "causal_d128": (*SWEEP[7][:6], dict(causal=True)),
    "softcap_window": (*SWEEP[6][:6],
                       dict(causal=True, window=8, softcap=25.0)),
    "zigzag": EXTRA["zigzag"],
    # The tf32x3w kernels: gemma2-2b's head dim with its softcap and a
    # window, GQA group 2, ragged; head dim 320, which pads to 384.
    "gemma2_d288": (1, 128, 120, 4, 2, 288,
                    dict(causal=True, window=48, softcap=50.0)),
    "d320": (1, 96, 112, 4, 2, 320, dict(causal=True, softcap=50.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tf32x3_fwd_emulation_matches_pallas(name):
    err, rel, lse_err, close = _fwd_errors(CASES[name])
    assert close and rel <= REL_TOL and lse_err <= LSE_TOL, (
        f"{name} forward: max |err| {err:.3e}, norm-relative {rel:.3e}, "
        f"lse max |err| {lse_err:.3e}")


@pytest.mark.parametrize("name", list(CASES))
def test_tf32x3_emulation_matches_pallas(name):
    for label, err, rel, close in _errors(CASES[name]):
        assert close and rel <= REL_TOL, (
            f"{name} {label}: max |err| {err:.3e}, norm-relative {rel:.3e}")


def test_tf32_split_is_the_kernels():
    """The split's bit arithmetic: hi rounds to nearest with ties away from
    zero (either sign, carrying into the exponent), both halves are TF32,
    and hi + lo is within 2^-22 |x| of x."""
    one_ulp = 2.0 ** -10           # TF32 ulp at 1.0
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + 3 * one_ulp / 2, 2.0 - one_ulp / 4,
                      1.0 + one_ulp / 2 - 2.0 ** -23])
    assert _tf32_rna(x).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp),
                                     1.0 + 2 * one_ulp, 2.0, 1.0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32) * 10.0 ** np.arange(-4, 4)
                         .repeat(512).astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
