"""The port's flash forward in bf16 against the JAX package's Pallas kernel
in interpret mode, on the reference suite's sweep, one packed-document
band case and head dim 320 (which both packages pad to 384: the sm90w
route's ``csrc/flash_fwd_sm90_d384.cu`` on the card), and its backward on
one GQA case (tolerance 2e-2, as ``tests/test_kernels.py::test_dtypes``);
which forward kernel a CUDA call takes.  The fp32 sweep and the band
cases are in ``test_torch_kernels.py`` and ``test_torch_kernels_bwd.py``;
the files split the work between test workers."""
import pytest
import torch

from _torch_parity import (D320, EXTRA, SWEEP, _check, _check_bwd, _do,
                           _inputs)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

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
    head dim alone: bf16 runs on the tensor cores at every width (sm90n at
    D in {16, 32}, sm90 at {64, 128}, sm90w above), fp32 on them too in
    three TF32 passes (tf32x3 up to D 128, tf32x3w above)."""
    for d in (64, 128):
        assert tfa.fwd_route(torch.bfloat16, d) == "sm90"
        assert tfa.fwd_route(torch.float32, d) == "tf32x3"
    for d in (16, 32):
        assert tfa.fwd_route(torch.bfloat16, d) == "sm90n"
        assert tfa.fwd_route(torch.float32, d) == "tf32x3"
    for d in tfa.WIDE_D:
        assert tfa.fwd_route(torch.bfloat16, d) == "sm90w"
        assert tfa.fwd_route(torch.float32, d) == "tf32x3w"


@pytest.mark.parametrize("name", list(D320))
def test_fwd_bf16_d320_matches_pallas(name):
    """The bf16 forward at head dim 320, which the port pads to 384 and a
    CUDA call sends to the sm90w route."""
    b, lq, lk, hq, hkv, kw = D320[name]
    assert tops._d_pad(320) == 384
    assert tfa.fwd_route(torch.bfloat16, 384) == "sm90w"
    q, k, v = _inputs((b, lq, hq, 320), (b, lk, hkv, 320), seed=lq + 320)
    _check(q, k, v, kw, "bfloat16")
