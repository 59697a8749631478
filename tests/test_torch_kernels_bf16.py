"""The port's flash forward in bf16 against the JAX package's Pallas kernel
in interpret mode, on the reference suite's sweep and one packed-document
band case (tolerance 2e-2, as ``tests/test_kernels.py::test_dtypes``).
The fp32 sweep and the band cases are in ``test_torch_kernels.py``; the
two files split the work between test workers."""
import pytest
import torch

from _torch_parity import EXTRA, SWEEP, _check, _inputs

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
