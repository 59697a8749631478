"""The port's paged serving engine (``repro_torch.serve``,
``models/decode.py``'s paged path and ``prefill_chunk``, the plan's
``serve_spec``) against the JAX package on reduced configs, fp32, on the
CPU.

Both sides start from the same weights: JAX ``init_params(cfg,
PRNGKey(0))``, brought over by ``convert.from_jax_params``.  The JAX side
runs jitted on its ref path; the port's prefill chunks run the kernel
path's plain version (``impl="plain"``) at an int band, its decode the ref
path.

* The sampler: greedy and temperature -> 0 equal to JAX's
  ``sample_tokens`` token for token; the top-k / top-p supports equal the
  set of JAX's draws (``jax.random`` streams cannot be matched: the port
  draws from a counter hash of (seed, rid, step)), and the port's
  frequencies follow the filtered softmax; streams reproducible and
  distinct across request ids.
* ``BlockAllocator`` and ``Scheduler``: FIFO, block-bounded admission,
  eviction to the queue's head, double frees.
* Paged decode on qwen3-1.7b, gemma2-2b and deepseek-v2-lite-16b along the
  reference's ragged stream (``tests/test_serve.py``): bitwise equal to
  the port's contiguous decode, within atol / rtol 1e-5 of JAX's paged
  ``decode_step``; ``prefill_chunk`` (two chunks, gemma2's window layers
  one) within 1e-5 of JAX's, logits and pools.
* The engine's greedy tokens identical to JAX's ``generate``; a mixed
  stream with sampling, eviction and EOS; ``serve_spec`` field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core.plan import build_plan as j_build_plan
from repro.launch import serve as jserve
from repro.models import decode as jdecode
from repro.models.model import init_params as j_init_params
from repro.serve import init_paged_caches as j_init_paged
from repro.serve import sample_tokens as j_sample_tokens
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.plan import build_plan
from repro_torch.models import decode as tdecode
from repro_torch.serve import (BlockAllocator, SamplingParams,
                               Scheduler, ServeEngine, blocks_needed,
                               init_paged_caches, sample_tokens)
from repro_torch.serve.engine import _pow2
from repro_torch.serve.sampling import filter_logits, request_stream
from repro_torch.serve.scheduler import DECODE, PREFILL, WAITING, Request

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("qwen3-1.7b", "gemma2-2b", "deepseek-v2-lite-16b")


def _port_sample(logits, temperature, top_k=0, top_p=1.0, stream=0,
                 steps=None):
    b = logits.shape[0]
    steps = torch.zeros(b, dtype=torch.int64) if steps is None else steps
    return sample_tokens(torch.as_tensor(logits),
                         torch.full((b,), temperature),
                         torch.full((b,), top_k, dtype=torch.int64),
                         torch.full((b,), top_p),
                         torch.full((b,), stream, dtype=torch.int64), steps)


def _jax_sample(logits, temperature, top_k=0, top_p=1.0, seed=0, steps=None):
    b = logits.shape[0]
    steps = jnp.zeros((b,), jnp.int32) if steps is None else steps
    return np.asarray(j_sample_tokens(
        jnp.asarray(logits), jnp.full((b,), temperature, jnp.float32),
        jnp.full((b,), top_k, jnp.int32), jnp.full((b,), top_p, jnp.float32),
        jnp.broadcast_to(jax.random.PRNGKey(seed), (b, 2)), steps))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**20), k=st.integers(0, 9),
       p=st.sampled_from([0.05, 0.5, 1.0]))
def test_greedy_and_temperature_to_zero_match_jax(seed, k, p):
    """temperature 0 is the argmax, and a temperature of 1e-5 leaves the
    argmax alone in the draw, whatever the filters: the same tokens as
    JAX's ``sample_tokens``."""
    logits = np.random.default_rng(seed).standard_normal(
        (4, 96)).astype(np.float32)
    for temp in (0.0, 1e-5):
        got = _port_sample(logits, temp, k, p, stream=seed).numpy()
        np.testing.assert_array_equal(got, _jax_sample(logits, temp, k, p,
                                                       seed=seed))
        np.testing.assert_array_equal(got, logits.argmax(-1))


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**20), k=st.integers(1, 8),
       p=st.sampled_from([0.3, 0.7, 0.95]))
def test_top_k_top_p_supports_match_jax(seed, k, p):
    """Over 4,096 draws a row (the step varies) at a vocab of 16, the
    tokens JAX draws and the tokens the port draws are each exactly the
    port's filtered support (top-k, top-p, both), and the port's
    frequencies lie within 0.05 of the filtered softmax."""
    rng = np.random.default_rng(seed)
    logits = (0.5 * rng.standard_normal((2, 16))).astype(np.float32)
    n = 4096
    j_draw = jax.jit(jax.vmap(
        lambda s, kk, pp: j_sample_tokens(
            jnp.asarray(logits), jnp.ones((2,)), jnp.full((2,), kk),
            jnp.full((2,), pp), jnp.broadcast_to(jax.random.PRNGKey(seed),
                                                 (2, 2)),
            jnp.full((2,), s)), in_axes=(0, None, None)))
    for kk, pp in ((k, 1.0), (0, p), (k, p)):
        masked = filter_logits(torch.as_tensor(logits),
                               torch.full((2,), kk, dtype=torch.int64),
                               torch.full((2,), pp))
        jd = np.asarray(j_draw(jnp.arange(n), kk, pp))            # (n, 2)
        steps = torch.arange(n).repeat_interleave(2)
        td = _port_sample(np.repeat(logits, n, 0).reshape(2, n, 16)
                          .transpose(1, 0, 2).reshape(-1, 16), 1.0, kk, pp,
                          stream=seed, steps=steps).reshape(n, 2).numpy()
        probs = torch.softmax(masked, dim=-1).numpy()
        for b in range(2):
            support = set(np.flatnonzero(np.isfinite(masked[b].numpy())))
            assert set(jd[:, b]) == support, (kk, pp, b)
            assert set(td[:, b]) == support, (kk, pp, b)
            freq = np.bincount(td[:, b], minlength=16) / n
            np.testing.assert_allclose(freq, probs[b], atol=0.05)


def test_streams_reproducible_and_distinct():
    """A draw depends on (seed, rid, step) only: the same triple repeats
    its token, another request id or seed draws others."""
    logits = np.random.default_rng(0).standard_normal(
        (1, 128)).astype(np.float32)

    def draws(seed, rid):
        s = request_stream(SamplingParams(seed=seed), rid)
        return [int(_port_sample(logits, 1.0, stream=s,
                                 steps=torch.tensor([t]))[0])
                for t in range(20)]

    a = draws(7, 3)
    assert a == draws(7, 3)
    assert a != draws(7, 4) and a != draws(8, 3)
    assert len(set(a)) > 1


# ---------------------------------------------------------------------------
# Block allocator and scheduler (host code, ported as it is)
# ---------------------------------------------------------------------------

def _req(rid, prompt_len=16, max_new=8):
    return Request(rid=rid, prompt=np.zeros(prompt_len, np.int32),
                   sampling=SamplingParams(), max_new_tokens=max_new)


def test_allocator_and_scheduler():
    alloc = BlockAllocator(8)
    a, b = alloc.alloc(3), alloc.alloc(5)
    assert sorted(a + b) == list(range(8)) and alloc.alloc(1) is None
    alloc.free(a)
    c = alloc.alloc(3)
    assert sorted(c) == sorted(a)
    with pytest.raises(ValueError):
        alloc.free(c + c[:1])                     # double free
    with pytest.raises(ValueError):
        alloc.free([99])                          # foreign block
    assert blocks_needed(33, 16) == 3

    alloc = BlockAllocator(6)
    sched = Scheduler(max_batch=2, allocator=alloc, page_size=8,
                      max_blocks_per_seq=4)
    r1, r2, r3 = _req(1), _req(2), _req(3)        # 24 tokens: 3 blocks
    for r in (r1, r2, r3):
        sched.submit(r)
    assert sched.admit() == [r1, r2] and r3.state == WAITING
    assert alloc.free_blocks == 0
    r1.state = DECODE
    sched.retire(r1)
    assert sched.admit() == [r3] and sched.slots[r3.slot] is r3
    with pytest.raises(ValueError):               # over max_blocks_per_seq
        sched.submit(_req(4, prompt_len=40, max_new=8))
    held = alloc.free_blocks
    sched.evict(r2)
    assert r2.state == WAITING and r2.blocks == []
    assert alloc.free_blocks > held and sched.waiting[0] is r2
    assert sched.admit() == [r2] and r2.state == PREFILL


# ---------------------------------------------------------------------------
# Paged decode and prefill_chunk against contiguous decode and JAX
# ---------------------------------------------------------------------------

B, PAGE, MAXB = 2, 8, 6
NB = B * MAXB
S = PAGE * MAXB


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX config, params and one-device runtime, and the port's
    config, params and CPU plan (kernel path's plain version)."""
    out = {}
    for arch in ARCHS:
        jcfg = j_get_reduced(arch)
        jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = get_reduced(arch)
        out[arch] = dict(
            jcfg=jcfg, jparams=jparams,
            jrt=j_build_plan(jcfg, devices=jax.devices()[:1],
                             impl="ref").rt,
            tcfg=tcfg,
            tparams=convert.from_jax_params(
                jax.tree.map(np.asarray, jparams), tcfg, device="cpu"),
            plan=build_plan(tcfg, device="cpu", impl="plain",
                            memory_budget_gb=8.0))
    return out


def _close(t, j, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), err_msg=msg,
                               **TOL)


def _close_tree(t, j, msg=""):
    j = jax.tree.map(np.asarray, j)
    t = convert.caches_to_numpy(t)
    assert jax.tree.structure(t) == jax.tree.structure(j)
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(j)):
        _close(a, b, msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_and_prefill_chunk_match(models, arch):
    """The reference's ragged stream (lengths 0 and 3, six steps) through
    block-table pools (an identity layout) is bitwise the port's
    contiguous decode and within 1e-5 of JAX's paged ``decode_step``; two
    prefill chunks of one request (start 0, 11 tokens; start 11, 9 tokens;
    gemma2's window layers: one chunk of 20) within 1e-5 of JAX's
    ``prefill_chunk``, logits and pools."""
    m = models[arch]
    jcfg, tcfg, rt = m["jcfg"], m["tcfg"], m["plan"].rt
    jrt = m["jrt"]
    btabs = np.arange(NB).reshape(B, MAXB)
    j_step = jax.jit(lambda p, c, t, pos, bt: jdecode.decode_step(
        p, c, t, pos, jrt, jcfg, jdecode.PagedLayout(bt, PAGE, NB)))
    cont = tdecode.init_caches(tcfg, B, S, device="cpu")
    pools = init_paged_caches(tcfg, num_blocks=NB, page_size=PAGE,
                              max_batch=B)
    jpools = j_init_paged(jcfg, num_blocks=NB, page_size=PAGE, max_batch=B)
    paged = tdecode.PagedLayout(torch.as_tensor(btabs), PAGE, NB)
    rng = np.random.default_rng(0)
    lengths = np.array([0, 3])
    with torch.inference_mode():
        for step in range(6):
            toks = rng.integers(0, tcfg.vocab, size=(B, 1))
            pos = torch.as_tensor(lengths)
            lg_c, _ = tdecode.decode_step(m["tparams"], cont,
                                          torch.as_tensor(toks), pos, rt,
                                          tcfg)
            lg_p, _ = tdecode.decode_step(m["tparams"], pools,
                                          torch.as_tensor(toks), pos, rt,
                                          tcfg, paged)
            lg_j, jpools = j_step(m["jparams"], jpools,
                                  jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(lengths, jnp.int32),
                                  jnp.asarray(btabs, jnp.int32))
            assert torch.equal(lg_c, lg_p), f"{arch} step {step}"
            _close(lg_p, lg_j, f"{arch} step {step}")
            lengths += 1
    _close_tree(pools, jpools, arch)

    # prefill_chunk at B=1 on request 1's blocks, fresh pools
    chunks = ((0, 20),) if tcfg.window else ((0, 11), (11, 9))
    prompt = rng.integers(0, tcfg.vocab, size=32)
    pools = init_paged_caches(tcfg, num_blocks=NB, page_size=PAGE,
                              max_batch=1)
    jpools = j_init_paged(jcfg, num_blocks=NB, page_size=PAGE, max_batch=1)
    bt1 = btabs[1:2, :4]
    j_chunk = jax.jit(lambda p, c, t, s0, n: jdecode.prefill_chunk(
        p, c, t, s0, n, jrt, jcfg, jdecode.PagedLayout(bt1, PAGE, NB)))
    for s0, n in chunks:
        toks = np.zeros((1, 32), np.int64)
        toks[0, :n] = prompt[s0:s0 + n]
        with torch.inference_mode():
            lg_t, _ = tdecode.prefill_chunk(
                m["tparams"], pools, torch.as_tensor(toks), s0, n, rt, tcfg,
                tdecode.PagedLayout(torch.as_tensor(bt1), PAGE, NB))
        lg_j, jpools = j_chunk(m["jparams"], jpools,
                               jnp.asarray(toks, jnp.int32), jnp.int32(s0),
                               jnp.int32(n))
        _close(lg_t, lg_j, f"{arch} chunk {s0}")
        _close_tree(pools, jpools, f"{arch} chunk {s0}")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _spec(plan, max_batch=2, maxb=8, prefill_chunk=16):
    """The plan's ``serve_spec`` at pages of 8, its pool cut to
    ``max_batch`` sequences of ``maxb`` blocks."""
    spec = plan.serve_spec(page_size=8, max_batch=max_batch,
                           max_seq_len=8 * maxb, prefill_chunk=prefill_chunk)
    return dataclasses.replace(spec, num_blocks=max_batch * maxb)


@pytest.mark.parametrize("arch,prompt_len", [("qwen3-1.7b", 24),
                                             ("gemma2-2b", 32),
                                             ("deepseek-v2-lite-16b", 24)])
def test_engine_greedy_matches_jax_generate(models, arch, prompt_len):
    """The engine's greedy tokens, token for token, JAX's fixed-batch
    ``generate`` on the same weights and prompts (gemma2 at a
    window-divisible prompt, the baseline ring's precondition)."""
    m = models[arch]
    prompts = np.random.default_rng(0).integers(0, m["tcfg"].vocab,
                                                size=(2, prompt_len))
    base = np.asarray(jserve.generate(m["jparams"], m["jcfg"], m["jrt"],
                                      jnp.asarray(prompts), gen=6))
    eng = ServeEngine(m["plan"], m["tparams"], _spec(m["plan"]))
    for p in prompts:
        eng.submit(p, SamplingParams(), max_new_tokens=6)
    res = eng.run()
    for b in range(2):
        assert res["requests"][b]["tokens"] == list(base[b]), arch


def test_engine_mixed_stream_eviction_and_eos(models):
    """After ``warmup``, more requests than slots with ragged prompts and
    lengths, sampling, one eviction mid-decode and an EOS: every request
    gets exactly its token count (the EOS one stops at its EOS), the
    evicted request's tokens repeat an uninterrupted run's, the pool ends
    free, and the shape counters stay at the ladder's size."""
    m = models["qwen3-1.7b"]
    spec = _spec(m["plan"])
    eng = ServeEngine(m["plan"], m["tparams"], spec)
    eng.warmup(prompt_lens=(16, 32), max_new=3)
    ladder = len({_pow2(n, 4, spec.max_blocks_per_seq)
                  for n in range(1, spec.max_blocks_per_seq + 1)})
    assert eng.decode_traces == 2 * ladder      # greedy and sampling
    prefill_keys = set(eng.prefill_traces)
    rng = np.random.default_rng(1)
    lens = [(10, 3), (25, 9), (7, 5), (40, 2), (18, 7)]
    sp = SamplingParams(temperature=0.7, top_k=20, seed=3)
    prompts = [rng.integers(0, m["tcfg"].vocab, size=n) for n, _ in lens]
    rids = [eng.submit(p, sp, max_new_tokens=g)
            for p, (_, g) in zip(prompts, lens)]
    done = {}
    for _ in range(4):
        done.update((r.rid, r.out_tokens) for r in eng.step())
    victim = rids[1]
    assert eng.requests[victim].state == DECODE
    eng.evict(victim)
    assert eng.sched.waiting[0] is eng.requests[victim]
    res = eng.run()
    done.update((rid, r["tokens"]) for rid, r in res["requests"].items())
    for rid, (_, gen) in zip(rids, lens):
        assert len(done[rid]) == gen
    assert eng.alloc.free_blocks == spec.num_blocks
    assert all(r is None for r in eng.sched.slots)
    assert eng.decode_traces == 2 * ladder
    views = {_pow2(n, 4, spec.max_blocks_per_seq)
             for n in range(1, spec.max_blocks_per_seq + 1)}
    chunks = {_pow2(n, 16) for n in range(1, spec.prefill_chunk + 1)}
    assert prefill_keys <= set(eng.prefill_traces) <= {
        (lc, nbv) for lc in chunks for nbv in views}

    # the evicted request's draws depend on (seed, rid, step) alone
    solo = ServeEngine(m["plan"], m["tparams"], spec)
    solo._next_rid = victim
    solo.submit(prompts[1], sp, max_new_tokens=lens[1][1])
    assert solo.run()["requests"][victim]["tokens"] == done[victim]

    # EOS: greedy, stop at the third token of the uninterrupted run
    rid = eng.submit(prompts[1], SamplingParams(), max_new_tokens=20)
    toks = eng.run()["requests"][rid]["tokens"]
    rid = eng.submit(prompts[1], SamplingParams(), max_new_tokens=20,
                     eos_id=toks[2])
    got = eng.run()["requests"][rid]["tokens"]
    assert got == toks[:toks.index(toks[2]) + 1]
    assert eng.alloc.free_blocks == spec.num_blocks


# ---------------------------------------------------------------------------
# The plan's serving side
# ---------------------------------------------------------------------------

def test_serve_spec_matches_jax():
    """``serve_spec`` field for field against JAX's at the same budget:
    reduced qwen3-1.7b, gemma2-2b (window ring bytes), deepseek (the
    latent), a budget so small the pool floors at one sequence, the full
    qwen3-1.7b; falcon-mamba has none and ``describe`` says so."""
    cases = [(get_reduced, j_get_reduced, a, 16.0) for a in ARCHS]
    cases += [(get_reduced, j_get_reduced, "qwen3-1.7b", 0.0005),
              (get_config, j_get_config, "qwen3-1.7b", 80.0)]
    for get_t, get_j, arch, gb in cases:
        plan = build_plan(get_t(arch), device="cpu", memory_budget_gb=gb)
        jplan = j_build_plan(get_j(arch), devices=jax.devices()[:1],
                             memory_budget_gb=gb)
        for kw in ({}, dict(page_size=16, max_batch=4, max_seq_len=1024)):
            sv, jsv = plan.serve_spec(**kw), jplan.serve_spec(**kw)
            assert dataclasses.asdict(sv) == dataclasses.asdict(jsv), arch
        line = [s for s in plan.describe().splitlines()
                if s.lstrip().startswith("serve")]
        jline = [s for s in jplan.describe().splitlines()
                 if s.lstrip().startswith("serve")]
        assert line == jline, (line, jline)
    assert build_plan(get_reduced("gemma2-2b"), device="cpu").serve_spec(
    ).window_bytes > 0
    ssm = build_plan(get_reduced("falcon-mamba-7b"), device="cpu",
                     memory_budget_gb=16.0)
    assert ssm.serve_spec() is None
    assert "paged=n/a (family=ssm)" in ssm.describe()
