"""The port's flash forward in bf16 against the JAX package's Pallas kernel
in interpret mode, on the reference suite's sweep and one packed-document
band case, and its backward on one GQA case (tolerance 2e-2, as
``tests/test_kernels.py::test_dtypes``); which forward kernel a CUDA call
takes.  The fp32 sweep and the band
cases are in ``test_torch_kernels.py`` and ``test_torch_kernels_bwd.py``;
the files split the work between test workers."""
import pytest
import torch

from _torch_parity import EXTRA, SWEEP, _check, _check_bwd, _do, _inputs
from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)


@pytest.mark.parametrize("case", SWEEP, ids=[str(i) for i in range(len(SWEEP))])
def test_fwd_bf16_matches_pallas(case):
    b, lq, lk, hq, hkv, d, causal, window, cap = case
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=lq * 7 + d)
    _check(q, k, v, dict(causal=causal, window=window, softcap=cap),
           "bfloat16")


def test_fwd_bf16_band_case_matches_pallas():
    b, lq, lk, hq, hkv, d, kw = EXTRA["doc_skip"]
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=3)
    _check(q, k, v, kw, "bfloat16")


def test_bwd_bf16_matches_pallas():
    """dq, dk, dv in bf16 (GQA, ragged lengths, D padded 40->64)."""
    b, lq, lk, hq, hkv, d, causal, window, cap = SWEEP[2]
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=5)
    _check_bwd(q, k, v, _do(q.shape, 5),
               dict(causal=causal, window=window, softcap=cap), "bfloat16")


def test_fwd_route_choice():
    """A CUDA call's forward route follows from the dtype and the padded
    head dim alone: bf16 at D in {64, 128} takes the sm90 tensor-core
    kernel, fp32 (full fp32 math) and narrower bf16 the FMA kernel."""
    for d in (64, 128):
        assert tfa.fwd_route(torch.bfloat16, d) == "sm90"
        assert tfa.fwd_route(torch.float32, d) == "fma"
    for d in (16, 32):
        assert tfa.fwd_route(torch.bfloat16, d) == "fma"
        assert tfa.fwd_route(torch.float32, d) == "fma"
