"""The route table of the port's CUDA kernels, pinned on the CPU: which
hand-written kernel a CUDA call of each of the three flash kernels
(forward, dq, dk/dv) launches at each dtype and padded head dim
(``KERNEL_D``).  The routes are pure functions of those three, so a change
to the table shows here before a card runs it; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` check on the card that each launch took the
route named here.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

F32, BF16 = torch.float32, torch.bfloat16
# (kernel, dtype) -> route at each of KERNEL_D = 16, 32, 64, 128, 192, 256,
# 288, 384.
TABLE = {
    ("fwd", F32): ("tf32x3",) * 4 + ("tf32x3w",) * 4,
    ("dq", F32): ("tf32x3",) * 4 + ("tf32x3w",) * 4,
    ("dkv", F32): ("tf32x3",) * 4 + ("tf32x3w",) * 4,
    ("fwd", BF16): ("sm90n", "sm90n", "sm90", "sm90", "sm90w", "sm90w",
                    "sm90w", "sm90w"),
    ("dq", BF16): ("sm90n", "sm90n", "sm90", "sm90", "sm90w", "sm90w",
                   "sm90w", "sm90w"),
    ("dkv", BF16): ("sm90n", "sm90n", "sm90", "sm90", "sm90w", "sm90w",
                    "sm90w", "sm90w"),
}


def _route(kernel, dtype, d):
    if kernel == "fwd":
        return tfa.fwd_route(dtype, d)
    return tfa.bwd_route(dtype, d, kernel)


@pytest.mark.parametrize("kernel,dtype", list(TABLE),
                         ids=[f"{k}-{str(dt)[6:]}" for k, dt in TABLE])
def test_route_table(kernel, dtype):
    """Every padded head dim's route for this kernel and dtype, and every
    head dim up to 384 takes the route of the width it pads to."""
    assert tfa.KERNEL_D == (16, 32, 64, 128, 192, 256, 288, 384)
    assert tuple(_route(kernel, dtype, d) for d in tfa.KERNEL_D) == \
        TABLE[kernel, dtype]
    for d in range(1, 385):
        assert _route(kernel, dtype, tops._d_pad(d)) in TABLE[kernel, dtype]
