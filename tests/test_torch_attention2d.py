"""The port's mesh and 2D-Attention (``repro_torch.core.topology``,
``core/attention2d.py``) against the JAX package on the CPU.

Without a process group: the rank -> ``(pod, data, head, outer, inner)``
map against JAX ``make_mesh``'s device assignment for both placements,
``factor_cp``, the zigzag tensor helpers and the lse combine.

With one: a module fixture spawns eight gloo ranks once
(``tests/_torch_dist_worker.py``, which imports no JAX).  Each rank runs
every case on its shard and writes the shards out; the tests put them
together and hold them against JAX single-device results computed here:

* the attention grids of ``tests/_dist_checks.py`` (Ulysses, the double
  ring, both placements, repeated KV heads, dp = 2) and the pure double
  ring: out and dq / dk / dv within the reference's 5e-6 on
  ``impl="ref"``; one grid also on ``impl="plain"`` (the kernel path the
  card runs) at the kernel tolerances;
* ``check_attention_modes``'s cases (window, softcap, non-causal,
  contiguous chunks) and a doc-start table;
* reduced qwen3-1.7b's ``forward_loss`` and every grad leaf, summed over
  ranks, on two grids (1e-5);
* the launcher's path, ``build_plan`` + ``Trainer``, for 3 steps on the
  (1, 2, 2, 2) grid, against the port's one-device trainer (which
  ``test_torch_trainer.py`` holds to JAX).
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.utils._pytree import tree_flatten

import _torch_dist_worker as W
from repro.configs import get_reduced as j_get_reduced
from repro.core import zigzag as jzz
from repro.core.plan import build_plan as j_build_plan
from repro.core.topology import ParallelConfig as JParallelConfig
from repro.core.topology import factor_cp as j_factor_cp
from repro.core.topology import make_mesh as j_make_mesh
from repro.kernels.ref import attention_ref as j_attention_ref
from repro.kernels.ref import combine_attention as j_combine_attention
from repro.kernels.ref import combine_pair as j_combine_pair
from repro.models.model import forward_loss as j_forward_loss
from repro.models.model import init_params as j_init_params
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import zigzag as tzz
from repro_torch.core.plan import build_plan
from repro_torch.core.topology import (ParallelConfig, factor_cp, rank_coords,
                                       rank_grid)
from repro_torch.kernels.ref import NEG_INF, combine_attention, combine_pair
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

REF_TOL = 5e-6                          # tests/_dist_checks.py
FWD_TOL = 2e-5                          # the kernel forward
BWD_TOL = dict(atol=5e-4, rtol=1e-3)    # the kernel backward
TOL = dict(atol=1e-5, rtol=1e-5)        # loss and grads of a grid
#: The fixture's limit: a rank that hangs fails the module, not the run.
SPAWN_SECONDS = 300

#: tests/test_plan.py's 16-device grid and tests/_dist_checks.py's grids,
#: as (dp, hp, outer, inner).
MAP_GRIDS = [(1, 4, 2, 2), (1, 1, 1, 4), (1, 1, 2, 2), (1, 2, 2, 2),
             (1, 4, 1, 2), (1, 8, 1, 1), (2, 2, 2, 1), (2, 1, 1, 2)]


class FakeDev:
    def __init__(self, i):
        self.id = i


# ---------------------------------------------------------------------------
# Without a process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["head_first", "context_first"])
def test_rank_map_matches_jax_mesh(placement):
    """Every rank's coordinates equal the position of its device in JAX
    ``make_mesh``; ``factor_cp`` agrees."""
    for dp, hp, no, wi in MAP_GRIDS:
        kw = dict(dp=dp, hp=hp, cp_outer=no, cp_inner=wi,
                  placement=placement)
        pc, jpc = ParallelConfig(**kw), JParallelConfig(**kw)
        jmesh = j_make_mesh(jpc, devices=[FakeDev(i)
                                          for i in range(pc.num_devices)])
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        np.testing.assert_array_equal(rank_grid(pc), ids)
        for r in range(pc.num_devices):
            assert rank_coords(pc, r) == tuple(
                int(c) for c in np.argwhere(ids == r)[0]), (kw, r)
    for cp in range(1, 17):
        for inner in (None, 1, 2, 4):
            if inner is None or cp % inner == 0:
                assert factor_cp(cp, inner) == j_factor_cp(cp, inner)


def test_zigzag_tensor_helpers_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 48, 12, 3)).astype(
        np.float32)
    for cp in (1, 2, 3, 4, 6):
        for axis in (1, 2) if cp <= 3 else (1,):
            t = tzz.to_zigzag(torch.from_numpy(x), cp, axis=axis)
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jzz.to_zigzag(jnp.asarray(x), cp,
                                                    axis=axis)))
            np.testing.assert_array_equal(
                tzz.from_zigzag(t, cp, axis=axis).numpy(), x)
        np.testing.assert_array_equal(tzz.zigzag_position_ids(48, cp),
                                      jzz.zigzag_position_ids(48, cp))


def test_combine_matches_jax():
    """The lse combine of three parts and of a pair, with rows that see no
    key in some parts and in all of them."""
    rng = np.random.default_rng(3)
    b, l, h, d = 2, 7, 3, 4
    outs = [rng.standard_normal((b, l, h, d)).astype(np.float32)
            for _ in range(3)]
    lses = [rng.standard_normal((b, h, l)).astype(np.float32)
            for _ in range(3)]
    lses[0][:, :, 1] = NEG_INF
    for x in lses:
        x[:, :, 4] = NEG_INF
    t = combine_attention([(torch.from_numpy(o), torch.from_numpy(s))
                           for o, s in zip(outs, lses)])
    j = j_combine_attention([(jnp.asarray(o), jnp.asarray(s))
                             for o, s in zip(outs, lses)])
    tp = combine_pair(*(torch.from_numpy(a) for a in (outs[0], lses[0],
                                                      outs[1], lses[1])))
    jp = j_combine_pair(*(jnp.asarray(a) for a in (outs[0], lses[0],
                                                   outs[1], lses[1])))
    for (to, tl), (jo, jl) in ((t, j), (tp, jp)):
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# Eight gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the eight ranks once; returns each rank's results."""
    out = tmp_path_factory.mktemp("attention2d")
    jcfg, tcfg = j_get_reduced("qwen3-1.7b"), get_reduced("qwen3-1.7b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    torch.save(convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu"),
               out / "params.pt")
    ctx = mp.start_processes(W.main, args=(W.WORLD, str(out)),
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
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(W.WORLD)]
    return {"res": res, "jparams": jparams, "jcfg": jcfg, "tcfg": tcfg}


def _assemble(res, section, key, field, shape):
    """The global logical array of ``field`` from every rank's shard."""
    full = np.zeros(shape, np.float32)
    for r in res:
        case = r[section][key]
        b0, b1, s0, s1 = case["where"]
        full[b0:b1, s0:s1] = case[field].numpy()
    if case["zz"]:
        full = full[:, jzz.zigzag_inverse(shape[1], case["cp"])]
    return full


def _oracle(arrays, **mask):
    """out and the grads of sum(out * w) of JAX's dense oracle."""
    q, k, v, w = (jnp.asarray(a) for a in arrays)

    def f(q, k, v, w):
        out, _ = j_attention_ref(q, k, v, **mask)
        return (out * w).sum(), out

    (_, out), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v, w)
    return [np.asarray(x) for x in (out, *g)]


def _check(res, section, key, arrays, want, impl="ref"):
    shapes = [a.shape for a in arrays[:3]]
    got = [_assemble(res, section, key, f, sh)
           for f, sh in zip(("out", "dq", "dk", "dv"),
                            (shapes[0], *shapes))]
    if impl == "ref":
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            err = float(np.abs(a - b).max())
            assert err < REF_TOL, (key, name, err)
        return
    assert float(np.abs(got[0] - want[0]).max()) < FWD_TOL, key
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **BWD_TOL)


@functools.lru_cache(maxsize=None)
def _grid_oracle():
    return _oracle(W.grid_inputs(), causal=True)


@pytest.mark.dist
@pytest.mark.parametrize("grid", list(W.GRIDS))
def test_attention_grid_matches_jax(ranks, grid):
    """Out and q/k/v grads of each 8-rank grid against JAX single-device
    ``value_and_grad`` of the dense oracle; the (1, 2, 2, 2) head-first
    grid also through the kernel path (``impl="plain"``)."""
    arrays, want = W.grid_inputs(), _grid_oracle()
    _check(ranks["res"], "grid", (grid, "ref"), arrays, want)
    if grid == W.PLAIN_GRID:
        _check(ranks["res"], "grid", (grid, "plain"), arrays, want,
               impl="plain")


@pytest.mark.dist
def test_attention_modes_match_jax(ranks):
    """Window, softcap, non-causal, contiguous chunks (with and without a
    window) and a packed-document table, each on an 8-rank grid."""
    arrays = W.mode_inputs()
    for name, c in W.MODES.items():
        mask = dict(causal=c["causal"], window=c["window"],
                    softcap=c["softcap"])
        if c.get("doc"):
            mask["q_doc_start"] = jnp.asarray(W.doc_table())
        _check(ranks["res"], "mode", name, arrays, _oracle(arrays, **mask))


@pytest.mark.dist
def test_model_loss_and_grads_match_jax(ranks):
    """Reduced qwen3-1.7b on (1, 2, 2, 2) and (2, 2, 1, 2): the global loss
    on every rank, and the grads summed over ranks, against JAX
    single-device ``value_and_grad`` of ``forward_loss`` (1e-5)."""
    jcfg, tcfg = ranks["jcfg"], ranks["tcfg"]
    batch = W.model_batch(tcfg.vocab)
    plan = j_build_plan(jcfg, devices=jax.devices()[:1], impl="ref")
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, plan.rt, jcfg), has_aux=True))(
            ranks["jparams"], jax.tree.map(jnp.asarray, batch))
    want = tree_flatten(convert.from_jax_params(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu"))[0]
    for grid in W.MODEL_GRIDS:
        runs = [r["model"][grid] for r in ranks["res"]]
        for run in runs:
            np.testing.assert_allclose(run["loss"], float(jl), **TOL)
            assert run["n_tokens"] == float(jm["n_tokens"])
        for run in runs[1:]:
            for a, b in zip(run["grads"], runs[0]["grads"]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert len(runs[0]["grads"]) == len(want)
        for g, w in zip(runs[0]["grads"], want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.dist
def test_mesh_trainer_matches_one_device(ranks):
    """``build_plan`` + ``Trainer`` on the (1, 2, 2, 2) grid, 3 steps of 2
    microbatches: the same losses on every rank, equal to the one-device
    trainer's within 1e-5; the params after the last update as
    ``test_torch_trainer.py`` holds them to JAX's.  ``describe()`` shows
    the mesh and the rank; ``zero="sp"`` plans an extent of 8 and
    ``remat="auto"`` the JAX ``build_plan``'s policy on that grid.  The
    ``DeviceMesh`` that ``make_mesh`` builds, and
    ``refine_mesh`` of a flat one, hold ``rank_grid``, and each rank's
    coordinates on it are ``rank_coords``'."""
    t = W.TRAIN
    plan = build_plan(get_reduced("qwen3-1.7b"), opt=OptConfig(**t["opt"]),
                      device="cpu", impl="plain", grad_accum=t["accum"],
                      seq_len=t["seq"], global_batch=t["gb"])
    tr = Trainer(plan, plan.data_config(t["seq"], t["gb"]),
                 TrainerConfig(num_steps=t["steps"], log_every=1))
    losses = tr.run()
    want = tree_flatten(tr.params)[0]
    for rank, r in enumerate(ranks["res"]):
        for placement, (made, refined, coord) in r["mesh"].items():
            grid = rank_grid(W.pc_of((1, 2, 2, 2), placement)).tolist()
            assert made == refined == grid, placement
            assert coord == rank_coords(W.pc_of((1, 2, 2, 2), placement),
                                        rank)
    runs = [r["trainer"] for r in ranks["res"]]
    remat = j_build_plan(
        ranks["jcfg"], JParallelConfig(hp=2, cp_outer=2, cp_inner=2),
        devices=[FakeDev(i) for i in range(W.WORLD)], remat="auto",
        **W.TRAIN_REMAT_AUTO).cfg.remat
    for rank, run in enumerate(runs):
        assert run["losses"] == runs[0]["losses"]
        assert "(pod, data, head, outer, inner) = (1, 1, 2, 2, 2)" in \
            run["describe"]
        assert f"this rank   {rank}:" in run["describe"]
        assert run["planned"] == {"zero": 8, "remat": remat}
    np.testing.assert_allclose(runs[0]["losses"], losses, **TOL)
    assert losses[0] != losses[-1]
    for a, b in zip(runs[0]["params"], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3, rtol=0)
        assert float(((a - b).abs() > 1e-5).float().mean()) <= 1e-3
