"""The port's ``OffloadManager`` and the FPDT chunk pipeline
(``repro_torch.runtime.offload``, ``core/attention2d.py::
ChunkedAttention``) against the JAX package on the CPU, one process.

* The six residency invariants of ``tests/test_offload.py`` on the port's
  manager (never read before landing, never exceed the budget, bitwise
  round trips, fp32 host accumulation, a stall-free double buffer,
  ``discard``), each schedule also run on the JAX manager, whose
  ``stats()`` the port's must equal.
* ``chunked_attention_2d`` at C 2 and 4, with and without a doc table
  whose boundaries straddle the chunk edges, against JAX's
  ``chunked_attention_2d`` and the port's resident ``attention_2d``
  (out, dq, dk, dv in fp32 within 1e-5), with no stall and a peak within
  the double-buffer schedule's bytes.
* ``build_plan(offload_chunks=4)``'s ``mem`` against JAX's.
(The mesh grids are in ``test_torch_runtime_mesh.py``.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_reduced as j_get_reduced
from repro.core import plan as jplan
from repro.runtime import offload as joff
from repro_torch.configs import get_reduced
from repro_torch.core import plan as tplan
from repro_torch.runtime.offload import (HOST, BudgetExceeded,
                                         OffloadManager, prefetched)

torch.set_num_threads(2)

RNG = np.random.default_rng(0)


def chunk(shape=(4, 8), dtype=np.float32, rng=RNG):
    return np.asarray(rng.standard_normal(shape), dtype)


def _both(budget=None):
    return OffloadManager(budget), joff.OffloadManager(budget)


def _same_stats(t, j):
    assert t.stats() == j.stats()


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n_keys=st.integers(min_value=1, max_value=4),
       n_ops=st.integers(min_value=5, max_value=40))
def test_random_schedule_never_reads_unlanded(seed, n_keys, n_ops):
    """Whatever the schedule, ``get`` only returns a landed tensor whose
    bytes equal the staged host copy; the accounts close and equal the
    JAX manager's on the same schedule."""
    rng = np.random.default_rng(seed)
    mgr, jmgr = _both()
    model = {}
    for i in range(n_keys):
        model[i] = chunk(rng=rng)
        mgr.put(i, model[i])
        jmgr.put(i, model[i])
    for _ in range(n_ops):
        key = int(rng.integers(0, n_keys))
        op = ("put", "prefetch", "get", "release")[int(rng.integers(0, 4))]
        if op == "put":
            model[key] = chunk(rng=rng)
            mgr.put(key, model[key])
            jmgr.put(key, model[key])
        elif op == "prefetch":
            mgr.prefetch(key)
            jmgr.prefetch(key)
        elif op == "release":
            mgr.release(key)
            jmgr.release(key)
        else:
            dev = mgr.get(key)
            jmgr.get(key)
            e = mgr._entries[key]
            assert e.state == "device" and e.landed
            assert np.array_equal(dev.numpy(), model[key])
    assert mgr.device_bytes == sum(mgr._entries[k].nbytes
                                   for k in mgr.resident())
    assert mgr.device_bytes <= mgr.peak_device_bytes
    _same_stats(mgr, jmgr)


@settings(max_examples=10, deadline=None)
@given(budget_chunks=st.integers(min_value=1, max_value=3),
       n_keys=st.integers(min_value=2, max_value=6))
def test_budget_never_exceeded(budget_chunks, n_keys):
    one = chunk().nbytes
    mgr, jmgr = _both(budget_chunks * one)
    for i in range(n_keys):
        x = chunk()
        mgr.put(i, x)
        jmgr.put(i, x)
    fetched = 0
    for i in range(n_keys):
        if fetched < budget_chunks:
            mgr.prefetch(i)
            jmgr.prefetch(i)
            fetched += 1
            assert mgr.device_bytes <= mgr.budget_bytes
        else:
            before = mgr.device_bytes
            with pytest.raises(BudgetExceeded):
                mgr.prefetch(i)
            with pytest.raises(joff.BudgetExceeded):
                jmgr.prefetch(i)
            assert mgr.device_bytes == before
            assert mgr._entries[i].state == HOST
    if n_keys > budget_chunks:
        for m in (mgr, jmgr):
            m.release(0)
            m.prefetch(budget_chunks)
        assert mgr.device_bytes <= mgr.budget_bytes
    assert mgr.peak_device_bytes <= mgr.budget_bytes
    _same_stats(mgr, jmgr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
def test_roundtrip_bitwise_identity(dtype):
    """put -> prefetch -> get -> release -> get keeps the bits, host and
    device."""
    x = (torch.from_numpy(RNG.standard_normal((3, 5))) * 100).to(dtype)
    mgr = OffloadManager()
    mgr.put("x", x)
    mgr.prefetch("x")
    assert torch.equal(mgr.get("x"), x) and mgr.get("x").dtype == dtype
    mgr.release("x")
    assert torch.equal(mgr.host_array("x"), x)
    assert torch.equal(mgr.get("x"), x) and mgr.stalls == 1


def test_accumulate_sums_on_host():
    mgr, jmgr = _both()
    deltas = [chunk() for _ in range(4)]
    for d in deltas:
        mgr.accumulate("dk", torch.from_numpy(d))
        jmgr.accumulate("dk", d)
    np.testing.assert_allclose(mgr.host_array("dk").numpy(),
                               np.sum(deltas, axis=0), rtol=1e-6)
    assert mgr.host_array("dk").dtype == torch.float32
    assert mgr.device_bytes == 0
    _same_stats(mgr, jmgr)


@settings(max_examples=10, deadline=None)
@given(n_keys=st.integers(min_value=1, max_value=8),
       depth=st.integers(min_value=1, max_value=3))
def test_prefetched_schedule_is_stall_free(n_keys, depth):
    one = chunk().nbytes
    mgr, jmgr = _both((depth + 1) * one)
    model = {}
    for i in range(n_keys):
        model[i] = chunk()
        mgr.put(i, model[i])
        jmgr.put(i, model[i])
    seen = []
    for key, dev in prefetched(mgr, range(n_keys), depth=depth):
        seen.append(key)
        assert np.array_equal(dev.numpy(), model[key])
    list(joff.prefetched(jmgr, range(n_keys), depth=depth))
    assert seen == list(range(n_keys))
    assert mgr.stalls == 0 and mgr.resident() == []
    assert mgr.h2d_bytes == n_keys * one
    _same_stats(mgr, jmgr)


def test_discard_returns_bytes():
    mgr = OffloadManager()
    mgr.put("a", chunk())
    mgr.prefetch("a")
    mgr.get("a")
    mgr.discard("a")
    assert mgr.device_bytes == 0 and mgr.host_bytes == 0
    mgr.discard("a")                  # idempotent
    with pytest.raises(KeyError):
        mgr.get("a")


# ---------------------------------------------------------------------------
# The chunk pipeline on one process
# ---------------------------------------------------------------------------

B, S, H, HKV, D = 1, 64, 4, 2, 16
#: Document starts whose boundaries fall inside chunks at C 2 and 4.
DOC = np.repeat([0, 10, 37, 50], [10, 27, 13, 14])[None].astype(np.int32)


def _inputs():
    rng = np.random.default_rng(7)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D),
                      (B, S, H, D))]


def _jax_chunked(q, k, v, w, chunks, doc):
    from repro.core.attention2d import Attn2DConfig, chunked_attention_2d
    from repro.core.topology import ParallelConfig, make_mesh
    mesh = make_mesh(ParallelConfig(), devices=jax.devices()[:1])
    with mesh:
        out, vjp = chunked_attention_2d(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh=mesh,
            cfg=Attn2DConfig(impl="ref"), chunks=chunks,
            doc_start=None if doc is None else jnp.asarray(doc),
            offload=joff.OffloadManager())
        grads = vjp(jnp.asarray(w))
    return [np.asarray(x) for x in (out, *grads)]


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_attention_matches_jax_and_resident(chunks):
    """Out, dq, dk and dv of the port's chunk pipeline (the kernels' plain
    versions) against JAX's ``chunked_attention_2d`` and the port's
    resident ``attention_2d`` with autograd, fp32 within 1e-5, with and
    without a doc table across the chunk edges; no stall, the peak within
    the double-buffer schedule's bytes, and one forward / dq / dk/dv
    call a chunk pair."""
    from repro_torch.core.attention2d import (Attn2DConfig, attention_2d,
                                              chunked_attention_2d)
    from repro_torch.kernels import ops
    q, k, v, w = _inputs()
    cfg = Attn2DConfig(impl="plain")
    for doc in (None, DOC):
        want = _jax_chunked(q, k, v, w, chunks, doc)
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in
                      (q, k, v))
        td = None if doc is None else torch.from_numpy(doc)
        res = attention_2d(tq, tk, tv, cfg=cfg, doc_start=td)
        (res * torch.from_numpy(w)).sum().backward()
        resident = [res.detach(), tq.grad, tk.grad, tv.grad]
        sc = S // chunks
        per = sc * D * 4
        budget = per * H + 2 * 2 * per * HKV + 2 * per * H + sc * H * 4
        mgr = OffloadManager(budget_bytes=budget)
        calls = {"fwd": 0, "bwd": 0}
        real_fwd, real_bwd = ops.flash_fwd_chunk, ops.flash_bwd_chunk
        import repro_torch.core.attention2d as a2d

        def fwd(*a, **kw):
            calls["fwd"] += 1
            return real_fwd(*a, **kw)

        def bwd(*a, **kw):
            calls["bwd"] += 1
            return real_bwd(*a, **kw)

        a2d.flash_fwd_chunk, a2d.flash_bwd_chunk = fwd, bwd
        try:
            out, vjp = chunked_attention_2d(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                cfg=cfg, chunks=chunks, doc_start=td, offload=mgr)
            got = [out, *vjp(torch.from_numpy(w))]
        finally:
            a2d.flash_fwd_chunk, a2d.flash_bwd_chunk = real_fwd, real_bwd
        pairs = chunks * (chunks + 1) // 2
        assert calls == {"fwd": pairs, "bwd": pairs}
        for name, g, jw, r in zip(("out", "dq", "dk", "dv"), got, want,
                                  resident):
            np.testing.assert_allclose(g.numpy(), jw, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
        assert mgr.stalls == 0 and mgr.resident() == []
        assert mgr.peak_device_bytes <= budget


def test_build_plan_offload_mem_matches_jax(monkeypatch):
    """``build_plan(offload_chunks=4)``'s memory model equals JAX
    ``build_plan``'s at the same budget (with the port's two rate
    constants set to the reference's), and ``describe()`` prints the
    offload line's values."""
    for name in ("CKPT_D2H_BYTES_PER_S", "OFFLOAD_WIRE_BYTES_PER_S"):
        monkeypatch.setattr(tplan, name, getattr(jplan, name))
    kw = dict(seq_len=4096, global_batch=4, grad_accum=2,
              memory_budget_gb=16.0, offload_chunks=4)
    want = jplan.build_plan(j_get_reduced("qwen3-1.7b"),
                            devices=jax.devices()[:1], impl="ref", **kw)
    got = tplan.build_plan(get_reduced("qwen3-1.7b"), device="cpu", **kw)
    assert got.mem == want.mem
    assert got.offload_chunks == want.offload_chunks == 4
    line = [x for x in want.describe().splitlines() if "offload" in x][0]
    assert line in got.describe()
