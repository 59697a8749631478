"""Decode on the 2D-Attention mesh: the port's counterpart of the
reference's ``tests/_dist_checks.py::check_decode_consistency``.

A module fixture spawns four gloo ranks once (``tests/_torch_runtime_
worker.py::decode_case``, which imports no JAX).  On each grid (dp, hp,
outer, inner) every rank runs ``prefill`` over the contiguous ring on its
piece of the prompt, ``grow_caches`` by 4 and one ``decode_step``, on
reduced configs at B=2, S=32, fp32, the prefill on the kernel path's
plain version.  Each test holds, for one grid:

* every rank's prefill and decode logits within the reference's 1e-3 of
  JAX's one-device ``prefill`` / ``decode_step`` on the same weights
  (``convert.to_jax_params``), tokens and next token;
* every rank's cache shards after the growth within 1e-3 of the slice of
  JAX's grown caches that ``kv_cache_spec`` / ``cache_shardings`` give it:
  S over ``(outer, inner)`` (the growth re-split), KV heads over ``head``,
  the MLA latent over S only (deepseek on (1, 4, 1, 1): one latent head,
  four head ranks), SSM states whole.

A last test drives the serve launcher there: ``main(... --engine fixed
--hp 2)`` on every rank (``launch_case``), whose rank 0 tokens must equal
the launcher's on one process.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_runtime_worker as W
from repro.configs import get_reduced as j_get_reduced
from repro.core.plan import build_plan as j_build_plan
from repro.launch import serve as jserve
from repro.models import decode as jdecode
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models.model import init_params

TOL = 1e-3
#: The fixture's limit: a rank that hangs fails the module, not the run.
SPAWN_SECONDS = 240


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh")
    ctx = mp.start_processes(W.main, args=(W.WORLD, str(out),
                                           ("decode", "launch")),
                             nprocs=W.WORLD, join=False,
                             start_method="spawn")
    try:
        deadline = time.monotonic() + SPAWN_SECONDS
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(W.WORLD)]


def _jax_reference(name: str, nxt):
    """JAX's one-device prefill logits, grown caches and decode logits on
    the workers' weights and tokens."""
    jcfg = j_get_reduced(name)
    plan = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref")
    params = init_params(get_reduced(name),
                         torch.Generator().manual_seed(W.DEC_SEED))
    jparams = convert.to_jax_params(params, get_reduced(name))
    pf, step, _ = jserve.make_generate_fns(jcfg, plan.rt)
    tokens = jnp.asarray(W.decode_tokens(jcfg.vocab), jnp.int32)
    lg, caches = pf(jparams, {"tokens": tokens})
    caches = jdecode.grow_caches(jcfg, caches, W.DEC_GROW)
    lg2, _ = step(jparams, caches, jnp.asarray(nxt, jnp.int32),
                  jnp.int32(W.DEC_S))
    return (np.asarray(lg), jax.tree.map(np.asarray, caches),
            np.asarray(lg2))


def _shard(path: str, x, coord, pc):
    """The slice of JAX's global cache leaf ``x`` that the rank at
    ``coord`` holds."""
    _, _, head, outer, inner = coord
    leaf = path.split("/")[-1]
    if leaf in ("h", "conv"):                 # SSM state: on every rank
        return x
    cp = pc.cp_outer * pc.cp_inner
    n = x.shape[2] // cp
    r = outer * pc.cp_inner + inner
    x = x[:, :, r * n:(r + 1) * n]
    if leaf in ("c", "rope"):                 # the MLA latent: S only
        return x
    if pc.hp > x.shape[3]:
        x = np.repeat(x, pc.hp // x.shape[3], axis=3)
    h = x.shape[3] // pc.hp
    return x[:, :, :, head * h:(head + 1) * h]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.dist
@pytest.mark.parametrize("name,grid", W.DECODE_CASES,
                         ids=[f"{n}-{g}" for n, g in W.DECODE_CASES])
def test_decode_consistency_on_grid(ranks, name, grid):
    pc = W.pc_of(grid)
    nxt = ranks[0]["decode"][name]["next"]
    j_pf, j_caches, j_dec = _jax_reference(name, nxt)
    np.testing.assert_array_equal(nxt, j_pf[:, -1].argmax(-1)[:, None])
    worst = {"prefill": 0.0, "decode": 0.0, "caches": 0.0}
    j_leaves = dict(_leaves(j_caches))
    for r in ranks:
        res = r["decode"][name]
        np.testing.assert_array_equal(res["next"], nxt)
        worst["prefill"] = max(worst["prefill"], _err(res["prefill"], j_pf))
        worst["decode"] = max(worst["decode"], _err(res["decode"], j_dec))
        t_leaves = dict(_leaves(res["caches"]))
        assert t_leaves.keys() == j_leaves.keys()
        for path, x in t_leaves.items():
            want = _shard(path, j_leaves[path], res["coord"], pc)
            assert x.shape == want.shape, (path, x.shape, want.shape)
            worst["caches"] = max(worst["caches"], _err(x, want))
    print(f"{name} on {grid}: max |err| against JAX's one device: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    assert max(worst.values()) < TOL, worst


@pytest.mark.dist
def test_launcher_fixed_engine_on_mesh(ranks):
    """``python -m repro_torch.launch.serve --engine fixed --hp 2`` in a
    four-rank world: every rank returns the same tokens, equal to the
    launcher's on one process."""
    one = serve.main(W.LAUNCH_ARGV).numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["launch"], one)
