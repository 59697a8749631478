#!/bin/bash
# zamba2-7b cut to depth 7 (one group of six Mamba2 layers, the shared
# attention block, one tail layer), 3 steps at S=16384, one sequence: on
# four cards over NCCL (hp 2, inner 2: each Mamba2 scan over four sequence
# pieces, the shared block's Ulysses all-to-all over head and its
# contiguous ring over inner), then on one card with the same seed and
# data.  Each run prints its plan, its losses and its median step.
#
#     bash scripts/ssm_nccl.sh
cd "$(dirname "$0")/.." || exit 1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
export PYTHONPATH=src
ARGS="--arch zamba2-7b --layers 7 --seq-len 16384 --global-batch 1 --steps 3"
timeout 600 torchrun --nproc-per-node 4 -m repro_torch.launch.train $ARGS \
    --hp 2 --inner 2 2>&1 | grep -vE "Warning|warn" | tail -25
echo "four cards rc ${PIPESTATUS[0]}"
timeout 600 python -m repro_torch.launch.train $ARGS 2>&1 \
    | grep -E "losses|final|Error" | tail -5
echo "one card rc ${PIPESTATUS[0]}"
