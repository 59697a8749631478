"""The port's bf16 forward and backward at padded head dims 16 and 32, where
a CUDA call takes the ``sm90n`` route (``csrc/flash_fwd_sm90_narrow.cu``,
``csrc/flash_bwd_sm90_narrow.cu``), against the JAX package's Pallas
forward, dq and dk/dv kernels in interpret mode (and, for the backward, its
dense oracle), at the reference suite's bf16 tolerance 2e-2
(``tests/test_kernels.py::test_dtypes``).

Each case runs the plain versions (``_fwd_plain``, ``_bwd_plain``) through
the fold and pad of ``ops`` (``_fwd_chunk_folded``,
``flash_bwd_chunk(impl="plain")``) and the torch oracle; the card holds the
kernels to the plain versions (``chip_smoke.py`` phases 2 and 3).
Cases: GQA group 2 on a ragged length at D 24 (padded 32), a softcap, a
window, zigzag ring steps with split q_seg / k_seg (one with a window) at
D 16, and packed documents.  They sit in a file of their own, beside the
D 40 case of ``test_torch_kernels_bf16.py``, so that test workers run the
two files side by side.
"""
import pytest
import torch

from _torch_parity import EXTRA, _check, _check_bwd, _do, _inputs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

# name -> (b, lq, lk, hq, hkv, d, keyword arguments); every case pads D to
# 16 or 32.
CASES = {
    "gqa_ragged_d24": (1, 48, 80, 4, 2, 24, dict(causal=True)),
    "softcap_d32": (1, 64, 64, 4, 2, 32, dict(causal=True, softcap=1.0)),
    "window_d32": (2, 64, 64, 4, 2, 32, dict(causal=True, window=16)),
    "zigzag_d16": EXTRA["zigzag"],
    "zigzag_window_d16": EXTRA["zigzag_diag"],
    "doc_skip_d32": EXTRA["doc_skip"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_bf16_narrow_matches_pallas(name):
    b, lq, lk, hq, hkv, d, kw = CASES[name]
    assert tops._d_pad(d) in tfa.SM90N_BWD_D
    assert {tfa.bwd_route(torch.bfloat16, tops._d_pad(d), kernel)
            for kernel in ("dq", "dkv")} == {"sm90n"}
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=len(name) + d)
    _check_bwd(q, k, v, _do(q.shape, len(name)), kw, "bfloat16")


@pytest.mark.parametrize("name", list(CASES))
def test_fwd_bf16_narrow_matches_pallas(name):
    b, lq, lk, hq, hkv, d, kw = CASES[name]
    assert tops._d_pad(d) in tfa.SM90N_FWD_D
    assert tfa.fwd_route(torch.bfloat16, tops._d_pad(d)) == "sm90n"
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=len(name) + 2 * d)
    _check(q, k, v, kw, "bfloat16")
