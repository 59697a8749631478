"""Plan-aware sharded checkpoints: async atomic saves, elastic restore
(counterpart of ``src/repro/runtime/checkpoint.py``, in its file format).

``CheckpointManager`` is the trainer's surface.  Layout (format 2):
``<dir>/step_<N>/``

    manifest.json       step, the saving plan, each leaf's shard layout
    leaf_<i>.s<j>.npy   shard j of leaf i, split along the leaf's
                        ZeRO-sharded dim

The files are the reference's: a checkpoint written by either package
restores in the other.  Leaf ``i`` is the ``i``-th leaf of the
reference's trainer state ``{"params": <tree>, "opt": {"m", "v",
"step"}}`` in its flatten order (sorted dict keys; the blocks of each
period slot stacked over the group axis, linear weights ``(d_in,
d_out)``), its ``path`` that tree's ``jax.tree_util.keystr``, its
``dtype`` the numpy name, and ``opt.step`` an int32 0-d array.

* **Sharded**: a leaf is split along the dim its hybrid-ZeRO spec shards
  (``ExecutionPlan.state_shardings``).  On a mesh each rank writes only
  the shards it holds, and of a shard that several ranks hold, only the
  copy whose complement coordinates are all zero
  (``ZeroLayout.counts_once``), so the bytes a rank writes fall with the
  ZeRO extent.  Shard ``j`` is the stack over the group axis of the
  (transposed) slices the rank with shard index ``j`` holds, or, where
  the spec shards the group axis itself, that rank's whole layers.
* **Atomic**: every rank writes into ``step_<N>.tmp-<run>-<n>`` (``run``
  agreed once, when the manager is built; ``n`` counts the manager's
  saves) and then leaves a marker there.  Rank 0 waits for every marker,
  writes the manifest and renames the directory, so a crash never leaves
  a visible half checkpoint.  The writers issue no collective.
* **Async**: ``save_async`` blocks only for the device -> host copy of
  this rank's shards, into pinned buffers allocated once and reused, and
  writes in a non-daemon thread.  A second save joins the first;
  ``flush`` (registered with ``atexit`` for as long as the manager
  lives) joins too, and raises what the writer raised.
* **Elastic**: ``restore`` rebuilds one reference leaf at a time on the
  host and hands this rank its shard under the *target* plan's layout,
  so a checkpoint from any grid, extent or one device restores onto any
  other.

The free functions (``save`` / ``restore`` / ``list_steps`` /
``latest_step`` / ``read_manifest``) act on trees of whole host leaves,
as the reference's do on host trees; a manager without a plan does the
same.  ``AsyncCheckpointer`` is the reference's older name.
"""
from __future__ import annotations

import atexit
import itertools
import json
import math
import os
import shutil
import threading
import time
import uuid
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch import convert
from repro_torch.core.topology import MESH_AXES

#: manifest format: 1 = whole-leaf files (seed), 2 = per-shard files
FORMAT = 2
#: How long the writers wait for the other ranks' shards, and how often
#: they look.
WAIT_SECONDS = 1800.0
POLL_SECONDS = 0.02

_TMP_IDS = itertools.count()


# ---------------------------------------------------------------------------
# Trees of host leaves
# ---------------------------------------------------------------------------

def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _flatten(tree, prefix=()):
    """``(path, leaf)`` pairs in the reference's flatten order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _flatten(x, prefix + (i,))
    else:
        yield prefix, tree


def _flatten_with_paths(tree):
    pairs = list(_flatten(tree))
    return [keystr(p) for p, _ in pairs], [x for _, x in pairs]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _manifest(step: int, plan_info: dict | None, entries) -> dict:
    """The manifest of a checkpoint whose leaves are ``entries``, each
    ``(path, shape, dtype name, dim, n_shards)``."""
    manifest = {"format": FORMAT, "step": step, "leaves": []}
    if plan_info:
        manifest["plan"] = plan_info
    bytes_host = 0
    for p, shape, dtype, dim, n in entries:
        bytes_host += math.prod(shape) * np.dtype(dtype).itemsize // n
        manifest["leaves"].append(
            {"path": p, "shape": list(shape), "dtype": dtype,
             "dim": dim if n > 1 else None, "shards": n})
    manifest["bytes_per_host"] = bytes_host
    return manifest


def _write_checkpoint(directory: str, step: int, paths, host_leaves,
                      layouts, plan_info: dict | None) -> str:
    """Write one checkpoint of whole host leaves from one process, each
    split as ``layouts`` says; returns the final path."""
    files, entries = [], []
    for i, (p, x, (dim, n)) in enumerate(zip(paths, host_leaves, layouts)):
        x = np.ascontiguousarray(x)
        shards = np.split(x, n, axis=dim) if n > 1 else [x]
        files += [(f"leaf_{i}.s{j}.npy", s) for j, s in enumerate(shards)]
        entries.append((p, x.shape, str(x.dtype), dim, n))
    tmp_name = f"step_{step:08d}.tmp-{os.getpid()}-{next(_TMP_IDS)}"
    return _write_rank(directory, step, tmp_name, files,
                       _manifest(step, plan_info, entries), _Rank(None))


def save(tree, step: int, directory: str, plan=None) -> str:
    """Blocking atomic save of a tree of host leaves (numpy arrays or
    tensors), each leaf whole; ``plan`` is recorded in the manifest.
    Returns the final checkpoint path."""
    paths, leaves = _flatten_with_paths(tree)
    host = [_host(x) for x in leaves]
    return _write_checkpoint(directory, step, paths, host,
                             [(None, 1)] * len(host), _plan_info(plan))


def _plan_info(plan) -> dict | None:
    """The manifest's record of the saving plan (None when unplanned)."""
    if plan is None:
        return None
    pc = plan.pc
    return {"dp": pc.dp, "hp": pc.hp, "cp_outer": pc.cp_outer,
            "cp_inner": pc.cp_inner, "pods": pc.pods,
            "placement": pc.placement, "zero_mode": plan.zero_mode,
            "zero_extent": plan.mem.get("zero_extent", 1)}


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str):
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _step_dir(directory: str, step: int | None) -> tuple[str, int]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"step_{step:08d}"), step


def read_manifest(directory: str, step: int | None = None) -> dict:
    """The manifest of one checkpoint (the latest when ``step`` is
    None)."""
    path, _ = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _load_leaf(path: str, i: int, entry: dict, fmt: int) -> np.ndarray:
    if fmt < 2:                        # seed layout: one file per leaf
        return np.load(os.path.join(path, f"leaf_{i}.npy"))
    n = entry.get("shards", 1)
    parts = [np.load(os.path.join(path, f"leaf_{i}.s{j}.npy"))
             for j in range(n)]
    return parts[0] if n == 1 else np.concatenate(parts,
                                                  axis=entry["dim"])


def _open(directory: str, step: int | None):
    """``(path, step, manifest, format, {leaf path: index})``."""
    path, step = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: i for i, e in enumerate(manifest["leaves"])}
    return path, step, manifest, manifest.get("format", 1), by_path


def _read(opened, p: str, shape) -> np.ndarray:
    """Leaf ``p`` of an opened checkpoint, whole, checked against
    ``shape``."""
    path, _, manifest, fmt, by_path = opened
    if p not in by_path:
        raise KeyError(f"the checkpoint at {path} has no leaf {p}")
    i = by_path[p]
    x = _load_leaf(path, i, manifest["leaves"][i], fmt)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{p}: the checkpoint holds {x.shape}, the target "
                         f"wants {tuple(shape)}")
    return x


def restore(template, directory: str, *, step: int | None = None):
    """Restore a tree of whole host leaves into ``template``'s structure;
    returns ``(tree of numpy arrays, step)``."""
    opened = _open(directory, step)
    paths, leaves = _flatten_with_paths(template)
    out = [_read(opened, p, np.shape(t)) for p, t in zip(paths, leaves)]
    return _unflatten(template, out), opened[1]


# ---------------------------------------------------------------------------
# The trainer state under a plan
# ---------------------------------------------------------------------------

def shard_layout(shape, spec, mesh) -> tuple[int | None, int]:
    """``(dim, n_shards)`` the save splits a reference leaf on, from its
    ``LeafSpec``: the sharded dim where the extent of its mesh axes
    divides it, ``(None, 1)`` for a replicated leaf (the reference's
    ``_shard_layout`` on a ``NamedSharding``)."""
    if not spec.axes or spec.dim is None or spec.dim >= len(shape):
        return None, 1
    n = math.prod(mesh.shape[a] for a in spec.axes)
    if n > 1 and shape[spec.dim] % n == 0:
        return spec.dim, n
    return None, 1


class StateLeaf(NamedTuple):
    """One leaf of the reference's trainer state: its ``path`` (keystr),
    the port tree it comes from (``"params"``, ``"m"``, ``"v"`` or
    ``"step"``), its shape, dtype and shard layout, and the port leaves
    that make it (their indices in the port's flatten order, by group)."""
    path: str
    tree: str
    shape: tuple
    dtype: str
    dim: int | None
    shards: int
    members: tuple


def state_leaves(plan) -> list:
    """The reference trainer state's leaves under ``plan``, in its
    flatten order: ``opt`` (``m``, ``step``, ``v``), then ``params``."""
    from repro_torch.core.plan import _ShapeOnlyMesh
    cfg, mesh = plan.cfg, _ShapeOnlyMesh(plan.pc)
    refs = convert.ref_leaf_map(cfg)
    specs = plan.state_shardings()
    members: dict = {}
    for i, r in enumerate(refs):
        members.setdefault(r.path, []).append((r.idx, i))

    def tree(name, prefix, spec_tree):
        out = []
        for ref_path, shape in convert.ref_param_shapes(cfg).items():
            dim, n = shard_layout(shape, spec_tree[ref_path], mesh)
            out.append(StateLeaf(
                keystr(prefix + ref_path), name, tuple(shape), "float32",
                dim, n, tuple(i for _, i in sorted(members[ref_path]))))
        return out

    opt = specs["opt"]
    return (tree("m", ("opt", "m"), opt["m"])
            + [StateLeaf(keystr(("opt", "step")), "step", (), "int32",
                         None, 1, ())]
            + tree("v", ("opt", "v"), opt["v"])
            + tree("params", ("params",), specs["params"]))


def _port_trees(state) -> dict:
    """``{"params" | "m" | "v": port leaves}`` and the step of a trainer
    state ``{"params": ..., "opt": {"m", "v", "step"}}``."""
    opt = state["opt"]
    return ({"params": tree_flatten(state["params"])[0],
             "m": tree_flatten(opt["m"])[0],
             "v": tree_flatten(opt["v"])[0]}, opt["step"])


class _Rank:
    """This process's place in a save: rank, world size, and whether its
    mesh coordinates are all zero."""

    def __init__(self, plan):
        mesh = plan is not None and plan.rt.mesh is not None
        self.rank = dist.get_rank() if mesh else 0
        self.world = dist.get_world_size() if mesh else 1
        self.origin = (not mesh) or all(getattr(plan.rt.coord, a) == 0
                                        for a in MESH_AXES)


def _my_shard(leaf: StateLeaf, plan, me: _Rank) -> int | None:
    """The shard index of ``leaf`` this rank writes, or None."""
    if leaf.shards == 1:
        return 0 if me.origin else None
    layout, i = plan.zero, leaf.members[0]
    if not layout.counts_once(i):
        return None
    return layout.groups[layout.places[i].axes].index


def shard_parts(leaf: StateLeaf, j: int, plan):
    """``(slot, port leaf)`` of the port leaves behind shard ``j`` of
    ``leaf``: ``slot`` is its row on the shard's stacked layer axes taken
    as one (row-major, as ``stacked_rows`` views them; None for an
    unstacked leaf).  Where the spec shards the leading layer axis, the
    shard is the layers whose owner is ``j``."""
    refs, layout = convert.ref_leaf_map(plan.cfg), plan.zero
    slot = 0
    for i in leaf.members:
        place = layout.places[i]
        if place.axes and place.dim is None and place.owner != j:
            continue                 # a layer another shard holds whole
        yield (slot if refs[i].idx else None), i
        slot += 1


def stacked_rows(buf, ref):
    """``buf`` (a shard of a leaf stacked over ``len(ref.idx)`` layer
    axes) with those axes taken as one."""
    return buf.reshape((-1,) + tuple(buf.shape[len(ref.idx):]))


def _shard_shape(leaf: StateLeaf) -> tuple:
    shape = list(leaf.shape)
    if leaf.shards > 1:
        shape[leaf.dim] //= leaf.shards
    return tuple(shape)


def _wait_for(cond, what: str, timeout: float):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: waited {timeout:.0f} s for "
                               f"{what}")
        time.sleep(POLL_SECONDS)


def _write_rank(directory: str, step: int, tmp_name: str, files,
                manifest: dict | None, me: _Rank,
                timeout: float = WAIT_SECONDS) -> str:
    """Write this rank's shard ``files`` (``(name, array)`` pairs, made
    lazily) into the shared temp dir and leave its marker.  Rank 0 then
    waits for every rank's marker, writes ``manifest`` and renames the
    directory; the other ranks wait until it is renamed or abandoned.
    Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, tmp_name)
    failed = f"{tmp}.failed"
    os.makedirs(tmp, exist_ok=True)
    marker = lambda r, s: os.path.join(tmp, f"rank{r}.{s}")   # noqa: E731

    def write_files():
        for name, x in files:
            np.save(os.path.join(tmp, name), x)

    if me.rank != 0:
        try:
            write_files()
        except BaseException:
            open(marker(me.rank, "failed"), "w").close()
            raise
        open(marker(me.rank, "done"), "w").close()
        _wait_for(lambda: os.path.exists(failed) or not os.path.exists(tmp),
                  f"rank 0 to publish {final}", timeout)
        if os.path.exists(failed):
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(f"checkpoint step {step}: rank 0 abandoned "
                               f"{tmp}")
        return final
    others = range(1, me.world)

    def all_done():
        bad = [r for r in others if os.path.exists(marker(r, "failed"))]
        if bad:
            raise RuntimeError(f"checkpoint step {step}: ranks {bad} failed "
                               "to write their shards")
        return all(os.path.exists(marker(r, "done")) for r in others)

    try:
        write_files()
        _wait_for(all_done, f"the shards of {final}", timeout)
        for r in others:
            os.remove(marker(r, "done"))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    except BaseException:
        if me.world > 1:
            open(failed, "w").close()
        shutil.rmtree(tmp, ignore_errors=True)   # never leave a tmp dir
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Plan-aware checkpoint manager: the trainer's save / restore surface.

    With a ``plan`` it saves and restores the port's trainer state
    ``{"params": shards, "opt": {"m": shards, "v": shards, "step": int}}``
    in the reference's layout; without one, trees of whole host leaves.
    On a mesh every rank builds its manager at the same point (the ranks
    agree on the temp dir's name here, with one broadcast) and saves at
    the same steps."""

    def __init__(self, directory: str, plan=None, keep: int = 3):
        self.directory = directory
        self.plan = plan
        self.keep = keep
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        self._buffers: dict = {}
        self._ids = itertools.count()
        self._me = _Rank(plan)
        run = [f"{os.getpid()}-{uuid.uuid4().hex[:8]}"]
        if self._me.world > 1:
            dist.broadcast_object_list(run, src=0)
        self._run = run[0]
        #: seconds and bytes of the last snapshot: pinned buffers
        #: allocated (``alloc_s``, zero once they exist) and the copy
        #: (``copy_s``)
        self.last_snapshot: dict = {}
        # a weak reference: the manager (and its pinned buffers) goes when
        # its owner drops it; a write in flight keeps it alive until done
        atexit.register(_flush_at_exit, weakref.ref(self))

    # -- saving -------------------------------------------------------------

    def _snapshot(self, state):
        """This rank's device -> host copy of the shards it writes, each
        straight into a pinned buffer of the shard's shape (a linear
        weight is transposed on the device on its way), the buffers
        allocated once and reused.  Returns ``(leaves, {leaf index:
        buffer}, step)``."""
        plan, me = self.plan, self._me
        leaves = state_leaves(plan)
        trees, step = _port_trees(state)
        mine = {n: j for n, leaf in enumerate(leaves)
                if leaf.tree != "step"
                and (j := _my_shard(leaf, plan, me)) is not None}
        pin = plan.rt.device.type == "cuda"
        t0 = time.perf_counter()
        for n in mine:
            shape = _shard_shape(leaves[n])
            buf = self._buffers.get(n)
            if buf is None or tuple(buf.shape) != shape:
                self._buffers[n] = torch.empty(shape, dtype=torch.float32,
                                               pin_memory=pin)
        t1 = time.perf_counter()
        refs = convert.ref_leaf_map(plan.cfg)
        for n, j in mine.items():
            leaf, buf = leaves[n], self._buffers[n]
            for slot, i in shard_parts(leaf, j, plan):
                x = trees[leaf.tree][i].detach()
                if refs[i].transposed:
                    x = x.t().contiguous()
                (buf if slot is None else stacked_rows(buf, refs[i])[slot]
                 ).copy_(x, non_blocking=True)
        if pin:
            torch.cuda.current_stream(plan.rt.device).synchronize()
        t2 = time.perf_counter()
        self.last_snapshot = {
            "alloc_s": t1 - t0, "copy_s": t2 - t1,
            "bytes": sum(self._buffers[n].numel() * 4 for n in mine)}
        return leaves, {n: self._buffers[n] for n in mine}, int(step)

    def _writes(self, leaves, host, step):
        """This rank's files: its shard buffers, and ``opt.step`` where it
        writes the replicated leaves."""
        for n, leaf in enumerate(leaves):
            j = _my_shard(leaf, self.plan, self._me)
            if j is None:
                continue
            x = np.asarray(step, np.int32) if leaf.tree == "step" \
                else host[n].numpy()
            yield f"leaf_{n}.s{j}.npy", x

    def _prepare(self, state, step: int):
        """Snapshot now; return the write to run (blocking or not)."""
        if self.plan is None:
            paths, leaves = _flatten_with_paths(state)
            host = [_host(x) for x in leaves]
            return lambda: _write_checkpoint(
                self.directory, step, paths, host, [(None, 1)] * len(host),
                None)
        leaves, host, opt_step = self._snapshot(state)
        tmp_name = f"step_{step:08d}.tmp-{self._run}-{next(self._ids)}"
        manifest = _manifest(step, _plan_info(self.plan), [
            (x.path, x.shape, x.dtype, x.dim, x.shards) for x in leaves])
        return lambda: _write_rank(self.directory, step, tmp_name,
                                   self._writes(leaves, host, opt_step),
                                   manifest, self._me)

    def save(self, state, step: int) -> str:
        """Blocking sharded save (snapshot + write); returns the path."""
        self.flush()
        final = self._prepare(state, step)()
        self._gc()
        return final

    def save_async(self, state, step: int):
        """Snapshot now, write in the background.  Joins any write still
        in flight first, so two saves never race on the directory or the
        buffers."""
        self.flush()
        write = self._prepare(state, step)

        def _write():
            try:
                write()
                self._gc()
            except BaseException as e:     # re-raised by flush
                self._error = e

        self._writer = threading.Thread(target=_write,
                                        name=f"ckpt-write-{step}")
        self._writer.start()

    def flush(self):
        """Join the in-flight write (no-op when idle); raise what it
        raised."""
        w, self._writer = self._writer, None
        if w is not None:
            w.join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    #: pre-manager name for ``flush`` (AsyncCheckpointer API)
    wait = flush

    def _gc(self):
        if self._me.rank != 0:
            return
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restoring ----------------------------------------------------------

    def restore(self, state, *, step: int | None = None, plan=None):
        """Restore into ``state``, through the target plan (``plan``,
        default the manager's): each reference leaf is read whole on the
        host, one at a time, and this rank's shard of it under the
        target layout is copied into ``state``'s tensor in place (a
        trainer state), or a tree of whole leaves is returned (no plan).
        Returns ``(state, step)``."""
        self.flush()                   # a just-queued save is readable
        plan = plan or self.plan
        if plan is None:
            return restore(state, self.directory, step=step)
        opened = _open(self.directory, step)
        trees, _ = _port_trees(state)
        refs, layout = convert.ref_leaf_map(plan.cfg), plan.zero
        new_step = None
        for leaf in state_leaves(plan):
            x = _read(opened, leaf.path, leaf.shape)
            if leaf.tree == "step":
                new_step = int(x)
                continue
            with torch.no_grad():
                for i in leaf.members:
                    r, dst = refs[i], trees[leaf.tree][i]
                    part = x[r.idx]
                    # to the device as stored, transposed there
                    full = torch.from_numpy(part).to(dst.device)
                    dst.copy_(layout.shard(i, full.t() if r.transposed
                                           else full))
            del x
        state["opt"]["step"] = new_step
        return state, opened[1]

    def list_steps(self):
        return list_steps(self.directory)

    def latest_step(self):
        return latest_step(self.directory)

    def manifest(self, step: int | None = None) -> dict:
        return read_manifest(self.directory, step)


def _flush_at_exit(ref):
    mgr = ref()
    if mgr is not None:
        mgr.flush()


class AsyncCheckpointer(CheckpointManager):
    """The reference's pre-manager name; prefer ``CheckpointManager``."""
