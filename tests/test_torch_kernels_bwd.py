"""The port's flash backward (``repro_torch.kernels``) against the JAX
package's Pallas dq and dk/dv kernels run in interpret mode and its dense
oracle, in fp32, at the reference suite's backward tolerance (atol 5e-4,
rtol 1e-3: ``tests/test_kernels.py::test_bwd_matches_oracle``).

On the CPU the port's wrapper takes its plain version (``_bwd_plain``), so
these tests hold the plain version, the fold/pad/band plumbing of
``ops.flash_bwd_chunk`` and ``ref.attention_bwd_ref`` to the reference, on
the forward suite's sweep (GQA, ragged lengths, padded head dims,
softcap, window).  Both sides take the same global ``(out, lse)``.  The
band cases are in ``test_torch_kernels_bwd_band.py``: one file would
take over 30 s.
"""
import pytest
import torch

from _torch_parity import SWEEP, _check_bwd, _do, _inputs
from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)


@pytest.mark.parametrize("case", SWEEP, ids=[str(i) for i in range(len(SWEEP))])
def test_bwd_matches_pallas(case):
    b, lq, lk, hq, hkv, d, causal, window, cap = case
    seed = lq * 7 + d
    q, k, v = _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=seed)
    _check_bwd(q, k, v, _do(q.shape, seed),
               dict(causal=causal, window=window, softcap=cap), "float32")


def test_bwd_route_choice():
    """A CUDA call's backward route follows from the dtype and the padded
    head dim alone: bf16 at D in {64, 128} takes the sm90 tensor-core
    kernels, fp32 (full fp32 math) and narrower bf16 the FMA kernels."""
    for d in (64, 128):
        assert tfa.bwd_route(torch.bfloat16, d) == "sm90"
        assert tfa.bwd_route(torch.float32, d) == "fma"
    for d in (16, 32):
        assert tfa.bwd_route(torch.bfloat16, d) == "fma"
