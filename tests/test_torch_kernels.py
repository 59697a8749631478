"""The port's flash forward (``repro_torch.kernels``) against the JAX
package's Pallas kernel run in interpret mode.

On the CPU the port's wrapper takes its plain version (``_fwd_plain``), so
these tests hold the plain version, the fold/pad/band plumbing of
``ops`` and the ref path to the reference kernel, in fp32 (tolerance
2e-5, as ``test_kernels.py::test_fwd_matches_oracle``); lse is compared
on rows that see a key.  The bf16 cases are in
``test_torch_kernels_bf16.py`` and the ``ops`` entry points in
``test_torch_ops.py``: no file here holds more tests than
``test_distributed.py``, so ``--dist loadfile`` still starts that long
file first.
"""
import pytest
import torch

from _torch_parity import EXTRA, SWEEP, _check, _inputs

torch.set_num_threads(2)


@pytest.mark.parametrize("case", SWEEP, ids=[str(i) for i in range(len(SWEEP))])
def test_fwd_matches_pallas(case):
    b, lq, lk, hq, hkv, d, causal, window, cap = case
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=lq * 7 + d)
    _check(q, k, v, dict(causal=causal, window=window, softcap=cap),
           "float32")


@pytest.mark.parametrize("name", list(EXTRA))
def test_fwd_band_cases_match_pallas(name):
    b, lq, lk, hq, hkv, d, kw = EXTRA[name]
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=len(name))
    _check(q, k, v, kw, "float32")
