"""The port's attention entry points (``repro_torch.kernels.ops``): the
prefill entry on its ref and folded paths, the ragged per-request masks of
decode against the JAX oracle, impl dispatch, head-dim padding, the
backward that waits for the training slice, and the CUDA kernel against
its plain version (on a machine with a card).  Tolerances are the
reference suite's: fp32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SWEEP, TOL, _compare, _inputs
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)


def test_flash_attention_ref_and_plain_agree():
    """``flash_attention`` (the prefill entry) on the ref path and the
    folded plain path give one answer: GQA, odd lengths, D padded 40->64,
    a kv_valid cut."""
    q, k, v = (torch.from_numpy(x) for x in
               _inputs((2, 33, 6, 40), (2, 33, 3, 40), seed=5))
    out = tops.flash_attention(q, k, v, causal=True, kv_valid_len=29,
                               impl="ref")
    qf, kf, vf, p, band, doc = tops._fold_chunk_args(
        q, k, v, causal=True, kv_valid_len=29)
    plain = tops._unfold(tops._FlashFolded.apply(qf, kf, vf, doc, p, band),
                         2, 6, 33, 40)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_ref_ragged_masks_match_jax():
    """Per-request (B,) mask offsets, kv_valid_len and kv_start on the ref
    path (the decode case) against the JAX oracle."""
    q, k, v = _inputs((3, 1, 4, 16), (3, 20, 2, 16), seed=11)
    off, valid, start = (np.array(x) for x in ([19, 4, -1], [20, 12, 20],
                                                [0, 3, 0]))
    o_j, l_j = jref.attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True,
        mask_offset=jnp.asarray(off), kv_valid_len=jnp.asarray(valid),
        kv_start=jnp.asarray(start))
    o_t, l_t = tref.attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        mask_offset=torch.from_numpy(off),
        kv_valid_len=torch.from_numpy(valid), kv_start=torch.from_numpy(start))
    _compare("ragged", o_t, l_t, o_j, l_j, 2e-5)
    assert float(o_t[2].abs().max()) == 0.0       # the slot at -1 sees nothing


def test_cuda_impl_on_cpu_tensors_raises():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, q, q, causal=True, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_fwd_chunk(q, q, q, causal=True, impl="cuda")
    assert tops.resolve_impl("auto", q) == "ref"


def test_head_dim_padding_and_limit():
    assert [tops._d_pad(d) for d in (8, 16, 24, 40, 64, 100, 128)] == \
        [16, 16, 32, 64, 64, 128, 128]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops._d_pad(256)


def test_backward_waits_for_training_slice():
    q = torch.randn((1, 8, 2, 16), requires_grad=True)
    qf, kf, vf, p, band, doc = tops._fold_chunk_args(q, q, q, causal=True)
    out = tops._FlashFolded.apply(qf, kf, vf, doc, p, band)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    """The CUDA kernel against its plain version on the card (skips on a
    machine without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tdt = getattr(torch, dtype)
    for b, lq, lk, hq, hkv, d, causal, window, cap in SWEEP:
        q, k, v = (torch.from_numpy(x).to("cuda", tdt) for x in
                   _inputs((b, lq, hq, d), (b, lk, hkv, d), seed=lq))
        kw = dict(causal=causal, window=window, softcap=cap)
        before = tfa.FWD_LAUNCHES
        o_k, lse_k = tops.flash_fwd_chunk(q, k, v, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert tfa.FWD_LAUNCHES == before + 1
        o_p, lse_p = tops._fwd_chunk_folded(q.cpu(), k.cpu(), v.cpu(), **kw)
        _compare("cuda", o_k.cpu(), lse_k.cpu(), o_p.float().numpy(),
                 lse_p.numpy(),
                 TOL[dtype])
