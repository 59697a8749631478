"""The port's CUDA kernels against their plain versions, on a machine with
a card (marker ``cuda``; every test skips without one).

This file imports neither ``jax`` nor the JAX package, so it runs where
the card is:

    python -m pytest -m cuda tests/test_torch_cuda.py

Cases: the reference suite's sweep (GQA, ragged lengths, padded head dims,
softcap, window), and the full training shape of qwen3-1.7b (B=1, L=4096,
16 / 8 heads, D=128, causal) and a ragged one (L=4000 with a kv_valid cut
and packed documents).  Tolerances: forward 2e-5 fp32 / 2e-2 bf16 (lse on
the rows that see a key), backward atol 5e-4 / rtol 1e-3 fp32, 2e-2 bf16;
at the full shapes also a norm-relative error, fp32 2e-5 and bf16 1e-2
(``chip_smoke.py`` phase 3's bounds): an fp32 backward whose sums drift
over a long chain (3.67e-5 norm-relative on dk/dv in one 3xTF32 build)
stays inside the elementwise tolerance and fails this one.  Each case must
take the route ``fwd_route`` / ``bwd_route`` picks for each kernel: the
sm90 kernels for bf16 at D in {64, 128}; for fp32 the 3xTF32 forward and
backward (``tf32x3``) at every D up to 128; for bf16 at D in
{16, 32} the narrow tensor-core forward, dq and dk/dv (``sm90n``); above
D 128 (192 for deepseek-v2-lite's MLA, 240 for gemma3-12b, 288 for
gemma2-2b and its full training shape) the sm90w tensor-core forward, dq
and dk/dv in bf16, and in fp32 the 3xTF32 forward, dq and dk/dv
(``tf32x3w``).  The bf16 forward at
the shapes its paths give the sm90n route (the reduced qwen3-1.7b, D 16;
qwen3-1.7b's training shape at D 32) and at head dim 320 (padded to 384:
the sm90w forward of ``csrc/flash_fwd_sm90_d384.cu``) is held to the
norm-relative bound too, as ``chip_smoke.py`` phase 2 holds it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import NEG_INF

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
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
REL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}   # ||err|| / ||plain||


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# The full training shape and a ragged one: (b, l, hq, hkv, d, keyword
# arguments); ``q_doc_start`` holds the document lengths.
FULL = [
    (1, 4096, 16, 8, 128, dict(causal=True)),
    (1, 4000, 16, 8, 128, dict(causal=True, kv_valid_len=3900,
                               q_doc_start=(1111, 1234, 1155, 500))),
]


# Above D 128: (b, l, hq, hkv, d, keyword arguments), GQA group 2; the
# last two are gemma2-2b's training shape (one microbatch), at its head
# dim and at head dim 320 (padded to 384).
WIDE = [
    (2, 200, 8, 4, 192, dict(causal=True, softcap=50.0)),
    (1, 320, 4, 2, 240, dict(causal=True, window=100)),
    (1, 256, 8, 4, 288, dict(causal=True, window=100, softcap=50.0)),
    (1, 4096, 8, 4, 288, dict(causal=True, softcap=50.0)),
    (1, 4096, 8, 4, 320, dict(causal=True, softcap=50.0)),
]


def _norm_rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _rand(rng, shape, tdt):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to("cuda", tdt)


def _cases(dtype):
    """(q, k, v, do, keyword arguments) on the card, from numpy seeds."""
    tdt = getattr(torch, dtype)
    for b, lq, lk, hq, hkv, d, causal, window, cap in SWEEP:
        rng = np.random.default_rng(lq)
        q, k, v, do = (_rand(rng, shape, tdt)
                       for shape in ((b, lq, hq, d), (b, lk, hkv, d),
                                     (b, lk, hkv, d), (b, lq, hq, d)))
        yield q, k, v, do, dict(causal=causal, window=window, softcap=cap)


def _full_cases(dtype, shapes=FULL):
    tdt = getattr(torch, dtype)
    for b, l, hq, hkv, d, kw in shapes:
        rng = np.random.default_rng(l)
        q, k, v, do = (_rand(rng, shape, tdt)
                       for shape in ((b, l, hq, d), (b, l, hkv, d),
                                     (b, l, hkv, d), (b, l, hq, d)))
        kw = dict(kw)
        if "q_doc_start" in kw:
            lens = kw["q_doc_start"]
            starts = np.repeat(np.cumsum((0,) + lens[:-1]), lens)
            kw["q_doc_start"] = torch.as_tensor(
                starts[None].repeat(b, 0), dtype=torch.int32, device="cuda")
        yield q, k, v, do, kw


def _plain_cpu(q, k, v, out, lse, do, kw):
    """The public plain path, on copies on the CPU."""
    return tops.flash_bwd_chunk(q.cpu(), k.cpu(), v.cpu(), out.cpu(),
                                lse.cpu(), do.cpu(), impl="plain", **kw)


def _plain_card(q, k, v, out, lse, do, kw):
    """``flash_bwd_chunk``'s fold and unfold around the plain version, on
    the card (the public ``impl="plain"`` takes CPU tensors only, which
    at the full shapes would take minutes)."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    qf, kf, vf, p, band, doc = tops._fold_chunk_args(q, k, v, **kw)
    d_pad = qf.shape[2]
    got = tfa._bwd_plain(qf, kf, vf, tops._fold_pad(out, d_pad),
                         lse.reshape(b * hq, lq).float().contiguous(),
                         tops._fold_pad(do, d_pad), p, band, doc)
    return (tops._unfold(got[0], b, hq, lq, d),
            *(tops._unfold(x, b, hkv, lk, d) for x in got[1:]))


def _fwd_plain_cpu(q, k, v, kw):
    """The folded plain path, on copies on the CPU."""
    return tops._fwd_chunk_folded(q.cpu(), k.cpu(), v.cpu(), **kw)


def _fwd_plain_card(q, k, v, kw):
    """``flash_fwd_chunk``'s fold and unfold around ``_fwd_plain``, on the
    card (on the CPU the full shapes would take minutes)."""
    b, lq, hq, d = q.shape
    qf, kf, vf, p, band, doc = tops._fold_chunk_args(q, k, v, **kw)
    out, lse = tfa._fwd_plain(qf, kf, vf, p, band, doc)
    return tops._unfold(out, b, hq, lq, d), lse.reshape(b, hq, lq)


def _route_counts():
    return {"fwd_sm90": tfa.FWD_SM90_LAUNCHES,
            "fwd_sm90n": tfa.FWD_SM90N_LAUNCHES,
            "fwd_tf32x3": tfa.FWD_TF32X3_LAUNCHES,
            "dq_sm90": tfa.DQ_SM90_LAUNCHES, "dkv_sm90": tfa.DKV_SM90_LAUNCHES,
            "dq_tf32x3": tfa.DQ_TF32X3_LAUNCHES,
            "dkv_tf32x3": tfa.DKV_TF32X3_LAUNCHES,
            "dq_sm90n": tfa.DQ_SM90N_LAUNCHES,
            "dkv_sm90n": tfa.DKV_SM90N_LAUNCHES,
            "fwd_tf32x3w": tfa.FWD_TF32X3W_LAUNCHES,
            "dq_tf32x3w": tfa.DQ_TF32X3W_LAUNCHES,
            "dkv_tf32x3w": tfa.DKV_TF32X3W_LAUNCHES,
            "fwd_sm90w": tfa.FWD_SM90W_LAUNCHES,
            "dq_sm90w": tfa.DQ_SM90W_LAUNCHES,
            "dkv_sm90w": tfa.DKV_SM90W_LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    """The forward kernel of ``fwd_route``'s route against its plain
    version, on the sweep and at the full and ragged shapes."""
    _card()
    tol = FWD_TOL[dtype]
    routes = set()
    for (q, k, v, _, kw), plain in (
            *((case, _fwd_plain_cpu) for case in _cases(dtype)),
            *((case, _fwd_plain_card) for case in _full_cases(dtype))):
        route = tfa.fwd_route(q.dtype, tops._d_pad(q.shape[3]))
        routes.add(route)
        before = (tfa.FWD_LAUNCHES, _route_counts())
        o_k, lse_k = tops.flash_fwd_chunk(q, k, v, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert tfa.FWD_LAUNCHES == before[0] + 1
        moved = {key: n - before[1][key]
                 for key, n in _route_counts().items()}
        assert moved == {key: int(key == f"fwd_{route}") for key in moved}
        o_p, lse_p = (x.cpu() for x in plain(q, k, v, kw))
        np.testing.assert_allclose(o_k.float().cpu().numpy(),
                                   o_p.float().numpy(), atol=tol, rtol=tol)
        seen = lse_p > NEG_INF / 2
        assert ((lse_k.cpu() > NEG_INF / 2) == seen).all()
        np.testing.assert_allclose(
            torch.where(seen, lse_k.cpu(), 0.0).numpy(),
            torch.where(seen, lse_p, 0.0).numpy(), atol=tol, rtol=tol)
        del o_k, lse_k, o_p, lse_p
    assert routes == ({"tf32x3"} if dtype == "float32"
                      else {"sm90n", "sm90"})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernels_match_plain(dtype):
    """The dq and dk/dv kernels against their plain version, from the same
    global ``(out, lse)``; at the full shapes also norm-relative."""
    _card()
    atol, rtol = BWD_TOL[dtype]
    routes = set()
    for (q, k, v, do, kw), plain in (
            *((case, _plain_cpu) for case in _cases(dtype)),
            *((case, _plain_card) for case in _full_cases(dtype))):
        route = tfa.bwd_route(q.dtype, tops._d_pad(q.shape[3]), "dq")
        assert tfa.bwd_route(q.dtype, tops._d_pad(q.shape[3]), "dkv") == \
            route
        routes.add(route)
        out, lse = tops.flash_fwd_chunk(q, k, v, impl="cuda", **kw)
        before = (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES, _route_counts())
        got = tops.flash_bwd_chunk(q, k, v, out, lse, do, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
        moved = {key: n - before[2][key]
                 for key, n in _route_counts().items()}
        assert moved == {key: int(key in (f"dq_{route}", f"dkv_{route}"))
                         for key in moved}
        want = plain(q, k, v, out, lse, do, kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().cpu().numpy(), atol=atol,
                                       rtol=rtol)
            if plain is _plain_card:
                assert _norm_rel(g, w) <= REL_TOL[dtype]
        del got, want
    assert routes == ({"tf32x3"} if dtype == "float32"
                      else {"sm90n", "sm90"})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wide_kernels_match_plain(dtype):
    """Above D 128 the forward, dq and dk/dv kernels (bf16: the sm90w
    route at every width, D 384 included; fp32: the tf32x3w forward, dq
    and dk/dv) against
    their plain versions on the card
    (folded as ``flash_fwd_chunk`` / ``flash_bwd_chunk`` fold), from the
    same global ``(out, lse)``: the elementwise and norm-relative
    tolerances above, lse on the rows that see a key, and one launch of
    each kernel on its route a case."""
    _card()
    tol, (atol, rtol) = FWD_TOL[dtype], BWD_TOL[dtype]
    for q, k, v, do, kw in _full_cases(dtype, WIDE):
        before = _route_counts()
        o_k, lse_k = tops.flash_fwd_chunk(q, k, v, impl="cuda", **kw)
        got = tops.flash_bwd_chunk(q, k, v, o_k, lse_k, do, impl="cuda",
                                   **kw)
        torch.cuda.synchronize()
        moved = {key: n - before[key] for key, n in _route_counts().items()}
        tc = ("fwd_sm90w", "dq_sm90w", "dkv_sm90w")
        want = tc if dtype == "bfloat16" else ("fwd_tf32x3w", "dq_tf32x3w",
                                               "dkv_tf32x3w")
        assert moved == {key: int(key in want) for key in moved}
        o_p, lse_p = _fwd_plain_card(q, k, v, kw)
        np.testing.assert_allclose(o_k.float().cpu().numpy(),
                                   o_p.float().cpu().numpy(), atol=tol,
                                   rtol=tol)
        assert _norm_rel(o_k, o_p) <= REL_TOL[dtype]
        seen = lse_p > NEG_INF / 2
        assert ((lse_k > NEG_INF / 2) == seen).all()
        np.testing.assert_allclose(
            torch.where(seen, lse_k, 0.0).cpu().numpy(),
            torch.where(seen, lse_p, 0.0).cpu().numpy(), atol=tol, rtol=tol)
        want = _plain_card(q, k, v, o_k, lse_k, do, kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().cpu().numpy(), atol=atol,
                                       rtol=rtol)
            assert _norm_rel(g, w) <= REL_TOL[dtype]
        del got, want, o_k, lse_k, o_p, lse_p


# bf16 forward shapes at the narrow and D 384 ends of the tensor-core
# routes: (b, l, hq, hkv, d, keyword arguments).
FWD_ENDS = [
    (1, 1024, 4, 2, 16, dict(causal=True)),
    (2, 4096, 16, 8, 32, dict(causal=True)),
    (1, 4000, 16, 8, 32, dict(causal=True, kv_valid_len=3900,
                              q_doc_start=(1111, 1234, 1155, 500))),
    (2, 4096, 8, 4, 320, dict(causal=True, softcap=50.0)),
    (1, 4000, 8, 4, 320, dict(causal=True, window=1000, kv_valid_len=3900,
                              q_doc_start=(1111, 1234, 1155, 500))),
]


@pytest.mark.cuda
def test_cuda_fwd_tensor_core_ends():
    """The bf16 forward at padded D 16 / 32 (sm90n) and 384 (sm90w) against
    its plain version on the card: 2e-2 elementwise, 1e-2 norm-relative,
    lse on the rows that see a key, one launch on the route a case."""
    _card()
    tol = FWD_TOL["bfloat16"]
    for q, k, v, _, kw in _full_cases("bfloat16", FWD_ENDS):
        route = "sm90n" if q.shape[3] <= 32 else "sm90w"
        assert tfa.fwd_route(q.dtype, tops._d_pad(q.shape[3])) == route
        before = _route_counts()
        o_k, lse_k = tops.flash_fwd_chunk(q, k, v, impl="cuda", **kw)
        torch.cuda.synchronize()
        moved = {key: n - before[key] for key, n in _route_counts().items()}
        assert moved == {key: int(key == f"fwd_{route}") for key in moved}
        o_p, lse_p = _fwd_plain_card(q, k, v, kw)
        np.testing.assert_allclose(o_k.float().cpu().numpy(),
                                   o_p.float().cpu().numpy(), atol=tol,
                                   rtol=tol)
        assert _norm_rel(o_k, o_p) <= REL_TOL["bfloat16"]
        seen = lse_p > NEG_INF / 2
        assert ((lse_k > NEG_INF / 2) == seen).all()
        np.testing.assert_allclose(
            torch.where(seen, lse_k, 0.0).cpu().numpy(),
            torch.where(seen, lse_p, 0.0).cpu().numpy(), atol=tol, rtol=tol)
        del o_k, lse_k, o_p, lse_p
