"""The port's checkpoints (``repro_torch.runtime.checkpoint``), the
trainer's resume and preemption flush, the launcher's checkpoint flags
and ``elastic_plan``, against the JAX package on the CPU, one process.

A module fixture runs the JAX ``Trainer`` on reduced qwen3-1.7b for four
steps with a save every two, then the port's trainer resumes from JAX's
step-2 checkpoint and saves its own step 4.  The tests hold the two
packages' files to each other: manifests field for field, ``.npy``
files byte for byte, the resumed losses to the uninterrupted JAX run's,
and JAX's ``restore`` of the port's files bit for bit.  The four-rank
sharded cases are in ``test_torch_runtime_mesh.py``.
"""
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.configs import ARCH_IDS, get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core.plan import build_plan as j_build_plan
from repro.core.topology import ParallelConfig as JParallelConfig
from repro.runtime import checkpoint as jckpt
from repro.runtime import resilience as jres
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core.plan import build_plan
from repro_torch.launch import args as targs
from repro_torch.launch import train as tlaunch
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import resilience as tres
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
SEQ, GB, STEPS, EVERY = 32, 4, 4, 2
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=STEPS)


def _plan(**kw):
    return build_plan(get_reduced("qwen3-1.7b"), opt=topt.OptConfig(**OPT),
                      device="cpu", impl="plain", seq_len=SEQ,
                      global_batch=GB, **kw)


def _trainer(ckpt_dir=None, steps=STEPS, **kw):
    plan = _plan()
    return Trainer(plan, plan.data_config(SEQ, GB),
                   TrainerConfig(num_steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=EVERY, log_every=1, **kw))


def _jax_state_tree(jtr):
    return {"params": jtr.params, "opt": jtr.opt_state}


def _port_as_jax(tr) -> dict:
    """The port trainer's state as the reference's tree of numpy
    leaves."""
    cfg = tr.plan.cfg
    opt = tr.opt_state
    return {"params": convert.to_jax_params(tr.params, cfg),
            "opt": {"m": convert.to_jax_params(opt["m"], cfg),
                    "v": convert.to_jax_params(opt["v"], cfg),
                    "step": np.asarray(opt["step"], np.int32)}}


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX trainer's four steps (saves at 2 and 4), then the port's
    trainer resumed from JAX's step 2 in a directory of its own."""
    root = tmp_path_factory.mktemp("ckpt")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jplan = j_build_plan(j_get_reduced("qwen3-1.7b"), JParallelConfig(),
                         jopt.OptConfig(**OPT), devices=jax.devices()[:1],
                         impl="ref", seq_len=SEQ, global_batch=GB)
    jtr = jtrainer.Trainer(jplan, jplan.data_config(SEQ, GB),
                           jtrainer.TrainerConfig(
                               num_steps=STEPS, ckpt_dir=jdir,
                               ckpt_every=EVERY, log_every=1))
    try:
        jlosses = jtr.run()
    finally:
        jtr.guard.uninstall()
    os.makedirs(tdir)
    shutil.copytree(os.path.join(jdir, "step_00000002"),
                    os.path.join(tdir, "step_00000002"))
    tr = _trainer(tdir)
    start = tr.start_step
    losses = tr.run()
    return dict(jdir=jdir, tdir=tdir, jlosses=jlosses, jplan=jplan,
                jtemplate=_jax_state_tree(jtr), start=start, losses=losses,
                plan=tr.plan, final=_port_as_jax(tr))


def test_state_leaves_are_the_references(run):
    """The port's trainer-state leaves (path, shape, dtype, layout) are the
    JAX manifest's: 40 leaves for reduced qwen3-1.7b, the reference's
    keystr paths in its flatten order, ``opt.step`` an int32 scalar."""
    man = ckpt.read_manifest(run["jdir"], 2)
    leaves = ckpt.state_leaves(run["plan"])
    assert len(leaves) == len(man["leaves"]) == 40
    for leaf, e in zip(leaves, man["leaves"]):
        assert (leaf.path, list(leaf.shape), leaf.dtype, leaf.dim,
                leaf.shards) == (e["path"], e["shape"], e["dtype"],
                                 e["dim"], e["shards"])
    assert leaves[13].path == "['opt']['step']"
    assert "['params']['blocks'][0]['attn']['wq']['w']" in [
        x.path for x in leaves]
    paths, _ = ckpt._flatten_with_paths(jax.tree.map(np.asarray,
                                                     run["jtemplate"]))
    assert paths == [x.path for x in leaves]


def test_manifest_and_files_match_jax(run, tmp_path):
    """The port restores JAX's step-2 checkpoint and saves the same state:
    the manifest equals JAX's field for field (plan and
    ``bytes_per_host`` included) and every file is byte-identical."""
    tr = _trainer()
    state = {"params": tr.params, "opt": tr.opt_state}
    state, step = ckpt.CheckpointManager(run["jdir"], plan=tr.plan).restore(
        state, step=2)
    assert step == 2 and state["opt"]["step"] == 2
    ckpt.CheckpointManager(str(tmp_path), plan=tr.plan).save(state, 2)
    jd = os.path.join(run["jdir"], "step_00000002")
    td = os.path.join(str(tmp_path), "step_00000002")
    assert ckpt.read_manifest(str(tmp_path)) == jckpt.read_manifest(
        run["jdir"], 2)
    want, got = _files(jd), _files(td)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_port_resumes_jax_checkpoint(run):
    """The port's trainer auto-resumes at JAX's step 2 (a skip, not a
    replay) and its steps 2-3 give the uninterrupted JAX run's losses
    within 1e-5."""
    assert run["start"] == 2
    assert len(run["losses"]) == STEPS - 2
    np.testing.assert_allclose(run["losses"], run["jlosses"][2:], **TOL)
    assert ckpt.list_steps(run["tdir"]) == [2, 4]


def test_jax_restores_port_checkpoint_bitwise(run):
    """JAX's ``ckpt.restore`` reads the port's step-4 checkpoint into its
    trainer state, bit for bit the port trainer's final state."""
    got, step = jckpt.restore(run["jtemplate"], run["tdir"], step=4)
    assert step == 4
    want = run["final"]
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w) == 40
    for a, b in zip(g, w):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    man = jckpt.read_manifest(run["tdir"], 4)
    assert man["plan"] == jckpt._plan_info(run["jplan"])


def test_format1_restores(run, tmp_path):
    """The seed layout (one ``leaf_<i>.npy`` a leaf, no ``format``) reads
    back through the manager's restore and the free ``restore``."""
    d = tmp_path / "step_00000002"
    d.mkdir()
    man = ckpt.read_manifest(run["jdir"], 2)
    src = os.path.join(run["jdir"], "step_00000002")
    for i, e in enumerate(man["leaves"]):
        shutil.copy(os.path.join(src, f"leaf_{i}.s0.npy"),
                    d / f"leaf_{i}.npy")
    with open(d / "manifest.json", "w") as f:
        json.dump({"step": 2, "leaves": [
            {k: e[k] for k in ("path", "shape", "dtype")}
            for e in man["leaves"]]}, f)
    plan = _plan()
    fresh = _trainer(steps=STEPS)
    state = {"params": fresh.params, "opt": fresh.opt_state}
    ckpt.CheckpointManager(str(tmp_path), plan=plan).restore(state)
    ref = _trainer(steps=STEPS)
    ckpt.CheckpointManager(run["jdir"], plan=plan).restore(
        {"params": ref.params, "opt": ref.opt_state}, step=2)
    for a, b in zip(tree_flatten(state)[0], tree_flatten(
            {"params": ref.params, "opt": ref.opt_state})[0]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.ones(3, np.float32)]}
    d1 = tmp_path / "plain" / "step_00000007"
    d1.mkdir(parents=True)
    paths, leaves = ckpt._flatten_with_paths(tree)
    for i, x in enumerate(leaves):
        np.save(d1 / f"leaf_{i}.npy", x)
    with open(d1 / "manifest.json", "w") as f:
        json.dump({"step": 7, "leaves": [
            {"path": p, "shape": list(x.shape), "dtype": str(x.dtype)}
            for p, x in zip(paths, leaves)]}, f)
    got, step = ckpt.restore({"w": np.zeros((2, 3)), "b": [np.zeros(3)]},
                             str(tmp_path / "plain"))
    assert step == 7
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["b"][0], tree["b"][0])


def test_crash_mid_write_leaves_no_trace(tmp_path, monkeypatch):
    """A crash between shard files leaves neither a visible checkpoint nor
    a temp dir, for the free ``save`` and for a trainer state under a
    plan; the error reaches the caller."""
    real_save = np.save

    def dies_after(n):
        calls = []

        def boom(path, arr, **kw):
            calls.append(path)
            if len(calls) > n:
                raise OSError("disk gone")
            real_save(path, arr, **kw)
        return boom, calls

    boom, calls = dies_after(1)
    monkeypatch.setattr(np, "save", boom)
    with pytest.raises(OSError):
        ckpt.save({"a": np.zeros(4, np.float32),
                   "b": np.ones(4, np.float32)}, 5, str(tmp_path / "a"))
    assert len(calls) == 2
    assert os.listdir(tmp_path / "a") == []
    tr = _trainer()
    boom, calls = dies_after(7)
    monkeypatch.setattr(np, "save", boom)
    mgr = ckpt.CheckpointManager(str(tmp_path / "b"), plan=tr.plan)
    mgr.save_async({"params": tr.params, "opt": tr.opt_state}, 3)
    with pytest.raises(OSError):
        mgr.flush()
    assert len(calls) == 8
    assert mgr.list_steps() == [] and os.listdir(tmp_path / "b") == []


def test_save_async_serializes_and_keeps(tmp_path):
    """Back-to-back ``save_async`` calls never race: every step lands, no
    temp dir leaks, ``flush`` is idempotent and ``keep`` holds; a trainer
    state's pinned snapshot buffers are allocated once and reused."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "a"), keep=100)
    state = {"x": np.arange(4096, dtype=np.float32)}
    for s in range(1, 9):
        mgr.save_async(state, s)
    mgr.flush()
    assert mgr.list_steps() == list(range(1, 9))
    assert not [n for n in os.listdir(tmp_path / "a") if ".tmp" in n]
    mgr.flush()
    kept = ckpt.AsyncCheckpointer(str(tmp_path / "b"), keep=2)
    for s in (1, 2, 3, 4):
        kept.save_async({"x": np.zeros(8, np.float32)}, s)
    kept.wait()
    assert kept.list_steps() == [3, 4]
    tr = _trainer()
    mgr = ckpt.CheckpointManager(str(tmp_path / "c"), plan=tr.plan, keep=2)
    state = {"params": tr.params, "opt": tr.opt_state}
    for s in (1, 2, 3):
        mgr.save_async(state, s)
        if s == 1:
            first = dict(mgr._buffers)
            assert mgr.last_snapshot["bytes"] == sum(
                x.numel() * 4 for x in tree_flatten(
                    [tr.params, tr.opt_state["m"], tr.opt_state["v"]])[0])
    mgr.flush()
    assert mgr.list_steps() == [2, 3]
    assert all(mgr._buffers[k] is first[k] for k in first)


def test_elastic_plan_matches_jax():
    """``elastic_plan`` equals the reference's over 1-64 chips and every
    reference config's head counts, both placements; and
    ``StepMonitor.stop`` records a step."""
    heads = {(j_get_config(a).n_kv_heads, j_get_config(a).n_heads)
             for a in ARCH_IDS
             if getattr(j_get_config(a), "n_heads", 0)}
    assert heads
    for kv, nh in sorted(heads):
        for n in range(1, 65):
            for placement in ("head_first", "context_first"):
                kw = dict(kv_heads=kv, n_heads=nh, placement=placement)
                want = jres.elastic_plan(n, **kw)
                got = tres.elastic_plan(n, **kw)
                assert got.__dict__ == want.__dict__, (n, kv, nh)
    mon = tres.StepMonitor()
    mon.start()
    assert mon.stop() >= 0 and mon.report()["steps"] == 1
    with pytest.raises(RuntimeError):
        mon.stop()


def test_launcher_checkpoint_flags(tmp_path):
    """``--ckpt-dir`` with ``--save-every`` saves and a relaunch resumes;
    ``--ckpt-every`` is the older name; ``--no-resume`` starts fresh;
    ``save_every`` picks the cadence as the reference's does."""
    base = ["--smoke", "--device", "cpu", "--seq-len", "16",
            "--global-batch", "2"]
    d = str(tmp_path / "c")
    assert len(tlaunch.main(base + ["--steps", "2", "--ckpt-dir", d,
                                    "--save-every", "1"])) == 2
    assert ckpt.list_steps(d) == [1, 2]
    assert len(tlaunch.main(base + ["--steps", "3", "--ckpt-dir", d,
                                    "--ckpt-every", "3"])) == 1
    assert ckpt.latest_step(d) == 3
    assert len(tlaunch.main(base + ["--steps", "2", "--ckpt-dir", d,
                                    "--no-resume"])) == 2
    for argv, want in (([], 50), (["--ckpt-every", "7"], 7),
                       (["--save-every", "5", "--ckpt-every", "7"], 5)):
        args = tlaunch.parse_args(argv)
        assert targs.save_every(args) == want
    assert tlaunch.parse_args(["--no-resume"]).resume is False
    assert tlaunch.parse_args([]).resume is True


def test_preemption_flush(tmp_path):
    """SIGTERM during step 1 stops the trainer at that step boundary with
    a checkpoint of step 2, flushed; a new trainer resumes there and its
    losses continue the uninterrupted run's exactly."""
    base = _trainer().run()
    tr = _trainer(str(tmp_path), steps=STEPS)
    tr.tcfg.ckpt_every = 100
    step_fn, calls = tr.step_fn, []

    def signalled(*a):
        calls.append(1)
        if len(calls) == 2:
            signal.raise_signal(signal.SIGTERM)
        return step_fn(*a)

    tr.step_fn = signalled
    first = tr.run()
    assert len(first) == 2 and ckpt.list_steps(str(tmp_path)) == [2]
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    again = _trainer(str(tmp_path), steps=STEPS)
    assert again.start_step == 2
    rest = again.run()
    np.testing.assert_allclose(first + rest, base, rtol=0, atol=1e-6)
