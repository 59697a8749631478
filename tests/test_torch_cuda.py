"""The port's CUDA kernels against their plain versions, on a machine with
a card (marker ``cuda``; every test skips without one).

This file imports neither ``jax`` nor the JAX package, so it runs where
the card is:

    python -m pytest -m cuda tests/test_torch_cuda.py

Cases: the reference suite's sweep (GQA, ragged lengths, padded head dims,
softcap, window).  Tolerances: forward 2e-5 fp32 / 2e-2 bf16 (lse on the
rows that see a key), backward atol 5e-4 / rtol 1e-3 fp32, 2e-2 bf16.
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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cases(dtype):
    """(q, k, v, do, keyword arguments) on the card, from numpy seeds."""
    tdt = getattr(torch, dtype)
    for b, lq, lk, hq, hkv, d, causal, window, cap in SWEEP:
        rng = np.random.default_rng(lq)
        q, k, v, do = (torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to("cuda", tdt)
            for shape in ((b, lq, hq, d), (b, lk, hkv, d), (b, lk, hkv, d),
                          (b, lq, hq, d)))
        yield q, k, v, do, dict(causal=causal, window=window, softcap=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    """The forward kernel against its plain version."""
    _card()
    tol = FWD_TOL[dtype]
    for q, k, v, _, kw in _cases(dtype):
        before = tfa.FWD_LAUNCHES
        o_k, lse_k = tops.flash_fwd_chunk(q, k, v, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert tfa.FWD_LAUNCHES == before + 1
        o_p, lse_p = tops._fwd_chunk_folded(q.cpu(), k.cpu(), v.cpu(), **kw)
        np.testing.assert_allclose(o_k.float().cpu().numpy(),
                                   o_p.float().numpy(), atol=tol, rtol=tol)
        seen = lse_p > NEG_INF / 2
        assert ((lse_k.cpu() > NEG_INF / 2) == seen).all()
        np.testing.assert_allclose(
            torch.where(seen, lse_k.cpu(), 0.0).numpy(),
            torch.where(seen, lse_p, 0.0).numpy(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernels_match_plain(dtype):
    """The dq and dk/dv kernels against their plain version, from the same
    global ``(out, lse)``."""
    _card()
    atol, rtol = BWD_TOL[dtype]
    for q, k, v, do, kw in _cases(dtype):
        out, lse = tops.flash_fwd_chunk(q, k, v, impl="cuda", **kw)
        before = (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
        got = tops.flash_bwd_chunk(q, k, v, out, lse, do, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
        want = tops.flash_bwd_chunk(q.cpu(), k.cpu(), v.cpu(), out.cpu(),
                                    lse.cpu(), do.cpu(), impl="plain", **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().numpy(), atol=atol,
                                       rtol=rtol)
