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
    """A CUDA call's backward routes follow from the kernel, the dtype and
    the padded head dim alone: bf16 at D in {64, 128} takes the sm90
    tensor-core kernels, fp32 at every D up to 128 the 3xTF32 tensor-core
    kernels, bf16 at D in {16, 32} the sm90n tensor-core kernels; above 128
    bf16 takes the sm90w tensor-core kernels at every width (192, 256, 288
    and 384) and fp32 the 3xTF32 tensor-core ones of the tf32x3w route.  No
    backward runs on the FMA cores, and a width no kernel is built for
    raises."""
    for which in ("dq", "dkv"):
        for d in (64, 128):
            assert tfa.bwd_route(torch.bfloat16, d, which) == "sm90"
        for d in (16, 32):
            assert tfa.bwd_route(torch.bfloat16, d, which) == "sm90n"
        for d in (16, 32, 64, 128):
            assert tfa.bwd_route(torch.float32, d, which) == "tf32x3"
        for d in tfa.WIDE_D:
            assert tfa.bwd_route(torch.float32, d, which) == "tf32x3w"
            assert tfa.bwd_route(torch.bfloat16, d, which) == "sm90w"
    with pytest.raises(ValueError, match="dkv"):
        tfa.bwd_route(torch.bfloat16, 128, "dk")
    with pytest.raises(ValueError, match="head dim 48"):
        tfa.bwd_route(torch.bfloat16, 48, "dq")
