"""The port's serving slice (``repro_torch``) against the JAX package on a
reduced qwen3-1.7b, fp32, on the CPU.

Both sides start from the same weights: JAX ``init_params(cfg,
PRNGKey(0))``, brought over by ``convert.from_jax_params``.  The JAX side
runs its plan with ``impl="pallas_interpret"`` (the Pallas forward kernel
in interpret mode); the port runs its ref path.  Prefill logits, KV caches
and one decode step agree within atol/rtol 1e-5; greedy ``generate`` is
token-identical.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core.plan import build_plan
from repro.launch import serve as jserve
from repro.models import decode as jdecode
from repro.models.model import init_params as j_init_params
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.runtime import Runtime
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as tdecode
from repro_torch.models.model import cast_params_once, init_params

torch.set_num_threads(2)

ARCH = "qwen3-1.7b"
B, S, GEN = 2, 24, 6
TOL = dict(atol=1e-5, rtol=1e-5)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def pair():
    """Reduced config, both sides' params, runtimes and the JAX jitted
    (prefill, decode_step) pair shared by the tests."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    plan = build_plan(jcfg, devices=jax.devices()[:1],
                      impl="pallas_interpret")
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    rt = Runtime(impl="auto", device="cpu")
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jrt=plan.rt, rt=rt, tokens=tokens,
                jfns=jserve.make_generate_fns(jcfg, plan.rt))


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def _close_caches(tc, jc):
    jc = jax.tree.map(np.asarray, jc)
    tc = convert.caches_to_numpy(tc)
    assert jax.tree.structure(jc) == jax.tree.structure(tc)
    for a, b in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        assert a.shape == b.shape
        _close(a, b)


def _prefill_both(pair):
    pf = pair["jfns"][0]
    jl, jc = pf(pair["jparams"], {"tokens": jnp.asarray(pair["tokens"],
                                                        jnp.int32)})
    with torch.inference_mode():
        tl, tc = tdecode.prefill(pair["tparams"],
                                 {"tokens": torch.from_numpy(pair["tokens"])},
                                 pair["rt"], pair["tcfg"])
    return (jl, jc), (tl, tc)


def test_prefill_matches_jax(pair):
    (jl, jc), (tl, tc) = _prefill_both(pair)
    assert tl.shape == (B, 1, pair["tcfg"].vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    _close_caches(tc, jc)


def test_decode_step_matches_jax(pair):
    (jl, jc), (tl, tc) = _prefill_both(pair)
    jc = jdecode.grow_caches(pair["jcfg"], jc, GEN)
    tc = tdecode.grow_caches(pair["tcfg"], tc, GEN)
    tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    jl2, jc2 = pair["jfns"][1](pair["jparams"], jc,
                               jnp.asarray(tok, jnp.int32), jnp.int32(S))
    with torch.inference_mode():
        tl2, tc2 = tdecode.decode_step(pair["tparams"], tc,
                                       torch.from_numpy(tok), S, pair["rt"],
                                       pair["tcfg"])
    _close(tl2, jl2)
    _close_caches(tc2, jc2)


def test_ragged_decode_step_matches_jax(pair):
    """Per-request positions (the continuous-batching case): one request at
    S, one retired slot at -1 (sees no keys, writes slot 0)."""
    (jl, jc), (tl, tc) = _prefill_both(pair)
    jc = jdecode.grow_caches(pair["jcfg"], jc, GEN)
    tc = tdecode.grow_caches(pair["tcfg"], tc, GEN)
    tok = np.array([[3], [7]])
    pos = np.array([S, -1])
    jl2, jc2 = pair["jfns"][1](pair["jparams"], jc,
                               jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos, jnp.int32))
    with torch.inference_mode():
        tl2, tc2 = tdecode.decode_step(pair["tparams"], tc,
                                       torch.from_numpy(tok),
                                       torch.from_numpy(pos), pair["rt"],
                                       pair["tcfg"])
    _close(tl2, jl2)
    _close_caches(tc2, jc2)


def test_generate_token_identical(pair):
    jt = jserve.generate(pair["jparams"], pair["jcfg"], pair["jrt"],
                         jnp.asarray(pair["tokens"], jnp.int32), gen=GEN,
                         fns=pair["jfns"])
    tt, calls = tserve.generate(pair["tparams"], pair["tcfg"], pair["rt"],
                                torch.from_numpy(pair["tokens"]), gen=GEN,
                                return_stats=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert calls == {"prefill": 1, "decode": GEN - 1}


def test_full_config_matches_reference():
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    for f in ("num_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "hd", "qk_norm", "rope_theta", "tie_embeddings",
              "window", "period", "dtype"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.compute_dtype == torch.bfloat16
    assert (tc.num_layers, tc.hd, tc.n_kv_heads) == (28, 128, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("gemma3-12b")


def test_init_params_distributions_and_cast():
    cfg = get_reduced(ARCH)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen)
    jparams = j_init_params(j_get_reduced(ARCH), jax.random.PRNGKey(0))
    ref = convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda t: tuple(t.shape), ref)
    lay = params["layers"][0]
    assert float(lay["ln1"]["w"].abs().max()) == 0.0
    assert float(lay["attn"]["qn"]["w"].abs().max()) == 0.0
    assert abs(float(params["embed"]["table"].std()) / 0.02 - 1) < 0.05
    w1 = lay["mlp"]["w1"]["w"]                     # (d_ff, d_model)
    assert abs(float(w1.std()) * cfg.d_model ** 0.5 - 1) < 0.1
    bf = cast_params_once(params, dataclasses.replace(cfg, dtype="bfloat16"))
    assert bf["layers"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert bf["layers"][0]["ln1"]["w"].dtype == torch.float32
    assert cast_params_once(params, cfg)["embed"]["table"] is \
        params["embed"]["table"]


def test_entry_points_refuse_cpu_without_asking():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runtime()
    with pytest.raises(SystemExit, match="ROADMAP"):
        tserve.main(["--smoke", "--engine", "paged", "--device", "cpu"])


def test_port_imports_no_jax_and_no_reference():
    """Every module of the port imports with ``jax`` and ``repro`` made
    unimportable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "jax" not in sys.modules or sys.modules["jax"] is None
        print(len(names))
    """)
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 16
