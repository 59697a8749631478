"""The port's attention entry points (``repro_torch.kernels.ops``): the
prefill entry on its ref and folded paths, the ragged per-request masks of
decode against the JAX oracle, impl dispatch, head-dim padding, the
backward through ``_FlashFolded`` (against the dense oracle and against
``jax.grad`` of the reference's ``flash_attention``), and the naming of
the kernels' built libraries.  The CUDA kernels against their plain
versions are in ``test_torch_cuda.py``.  Tolerances
are the reference suite's: forward fp32 2e-5, bf16 2e-2; backward atol
5e-4 / rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _compare, _inputs
from repro.kernels import ops as jops
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
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_bwd_chunk(q, q, q, q, q[:, :, :, 0], q, causal=True,
                             impl="cuda")
    assert tops.resolve_impl("auto", q) == "ref"
    assert tops.resolve_impl("plain", q) == "plain"


def test_head_dim_padding_and_limit():
    assert [tops._d_pad(d) for d in (8, 16, 24, 40, 64, 100, 128)] == \
        [16, 16, 32, 64, 64, 128, 128]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops._d_pad(256)


def test_backward_waits_for_training_slice():
    """The CPU backward through ``_FlashFolded`` (fold, ``_fwd_plain``,
    ``_bwd_plain``, unfold; GQA, D padded 24->32, a kv_valid cut) matches
    the dense backward oracle ``attention_bwd_ref`` given the same global
    ``(out, lse)``, and launches no kernel."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in
               _inputs((2, 37, 4, 24), (2, 45, 2, 24), seed=9))
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 37, 4, 24)).astype(np.float32))
    kw = dict(causal=True, kv_valid_len=40)
    before = (tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    out = tops.flash_attention(q, k, v, impl="plain", **kw)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == before
    o_r, lse_r = tref.attention_ref(q.detach(), k.detach(), v.detach(), **kw)
    want = tref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), o_r,
                                  lse_r, do, **kw)
    for g, w, x in zip(grads, want, (q, k, v)):
        assert g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-4,
                                   rtol=1e-3)


def test_autograd_matches_jax_grad():
    """``torch.autograd.grad`` through ``_FlashFolded`` against
    ``jax.grad`` of the reference's ``flash_attention`` on its Pallas
    kernels in interpret mode (GQA, window, softcap)."""
    q, k, v = _inputs((1, 40, 4, 32), (1, 40, 2, 32), seed=13)
    do = np.random.default_rng(13).standard_normal(q.shape).astype(
        np.float32)
    kw = dict(causal=True, window=12, softcap=20.0)

    def j_loss(q, k, v):
        out = jops.flash_attention(q, k, v, impl="pallas_interpret", **kw)
        return jnp.sum(out * do)

    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, impl="plain", **kw)
    tg = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-4,
                                   rtol=1e-3)


def test_library_path_follows_headers(tmp_path, monkeypatch):
    """A built library is named by a hash of its source, every header in
    ``csrc/`` and the flags, so an edit to ``sm90_common.cuh`` names a new
    library for both sm90 sources and a stale build is never loaded.  No
    nvcc is needed: only the names are computed."""
    import shutil

    from repro_torch.kernels import build

    names = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_fwd")
    real = {n: build.library_path(n) for n in names}
    for n, path in real.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"{n}-") and path.suffix == ".so"
    for src in build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert {n: build.library_path(n) for n in names} == real
    header = tmp_path / "sm90_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: build.library_path(n) for n in names}
    assert all(edited[n] != real[n] for n in names)
    (tmp_path / "flash_fwd_sm90.cu").write_text("// edited source\n")
    assert build.library_path("flash_fwd_sm90") != edited["flash_fwd_sm90"]
    assert build.library_path("flash_bwd_sm90") == edited["flash_bwd_sm90"]
