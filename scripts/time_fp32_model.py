"""Time ``chip_smoke.py`` phase 6's fp32 run for one or more source trees.

    python3 scripts/time_fp32_model.py [SRC_DIR ...]

The run is full-width qwen3-1.7b at depth 2 in fp32, ``forward_loss`` and
its backward at B=1, L=4096 on the kernels (random weights from seed 1,
``SyntheticLM`` batch 0).  Each SRC_DIR (default: this repository's
``src/``) holds a ``repro_torch`` package and is timed in a process of its
own, since two versions of the package cannot share one.  The trees are
timed in turns, A B .. B A, so two versions are compared on one card.
Each process builds the kernels its tree needs, runs one warm-up, then
times 5 runs with CUDA events (each from the call to its last gradient)
and prints one JSON line: the tree, the milliseconds, their median and
the kernel launches of one run by route.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import dataclasses, json, statistics, sys
import torch
sys.path.insert(0, sys.argv[1])
from torch.utils._pytree import tree_flatten, tree_unflatten
from repro_torch.configs import get_config
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.model import forward_loss, init_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2,
                          dtype="float32")
params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=4096,
                               global_batch=1, seed=1)).batch(0)
batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
leaves, spec = tree_flatten(params)
rt = Runtime(impl="cuda", device="cuda")
names = [n for n in dir(fa) if n.endswith("_LAUNCHES")]


def run():
    xs = [x.detach().requires_grad_() for x in leaves]
    loss, _ = forward_loss(tree_unflatten(xs, spec), batch, rt, cfg)
    return torch.autograd.grad(loss, xs)


run()
torch.cuda.synchronize()
before = {n: getattr(fa, n) for n in names}
ms = []
for _ in range(5):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    grads = run()
    end.record()
    torch.cuda.synchronize()
    ms.append(start.elapsed_time(end))
    del grads
launches = {n: (getattr(fa, n) - before[n]) // 5 for n in names
            if getattr(fa, n) != before[n]}
print(json.dumps({"src": sys.argv[1], "ms": ms,
                  "median_ms": statistics.median(ms),
                  "launches_per_run": launches}))
"""


def main() -> int:
    srcs = sys.argv[1:] or [str(ROOT / "src")]
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    print(chip_smoke.smi_line(), flush=True)
    results = {src: [] for src in srcs}
    for src in [*srcs, *reversed(srcs)]:
        proc = subprocess.run([sys.executable, "-c", CHILD, src],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[src] += json.loads(line)["ms"]
    for src, ms in results.items():
        print(f"{src}: median {statistics.median(ms):.2f} ms over "
              f"{len(ms)} runs, min {min(ms):.2f}, max {max(ms):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
