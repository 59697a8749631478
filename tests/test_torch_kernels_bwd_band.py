"""The port's flash backward on the forward suite's band cases against the
JAX package's Pallas dq and dk/dv kernels in interpret mode and its dense
oracle, in fp32 (atol 5e-4, rtol 1e-3): zigzag ring steps with split
q_seg / k_seg, a kv_valid cut whose rows see no key, and packed documents
with the K-tile skip on and off.  The sweep is in
``test_torch_kernels_bwd.py``."""
import pytest
import torch

from _torch_parity import EXTRA, _check_bwd, _do, _inputs

torch.set_num_threads(2)


@pytest.mark.parametrize("name", list(EXTRA))
def test_bwd_band_cases_match_pallas(name):
    b, lq, lk, hq, hkv, d, kw = EXTRA[name]
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=len(name))
    _check_bwd(q, k, v, _do(q.shape, len(name)), kw, "float32")
