"""Compare the bf16 forward, dq and dk/dv kernels above head dim 128 on
one card.

    python3 scripts/ab_wide_sm90.py [spec.json]
    python3 scripts/ab_wide_sm90.py --d384 [--parent PARENT_CSRC_DIR] [NAME ...]
    python3 scripts/ab_wide_sm90.py --d384-bwd [--parent PARENT_CSRC_DIR] [NAME ...]

Each variant is ``csrc/flash_fwd_sm90_wide.cu``,
``csrc/flash_dq_sm90_wide.cu``, ``csrc/flash_dkv_sm90_wide.cu`` and the
``csrc/sm90_common.cuh`` they include, with textual replacements
(``[[name, {"fwd": {old: new}, "dq": {old: new}, "dkv": {old: new},
"common": {old: new}}], ...]`` in ``spec.json``, or a list of names from
the default list; by default the kept kernels against 32-key stages (three
of them) instead of two 48-key ones, one warpgroup a block, a last output
part of a whole 64-column chunk instead of 32 columns, the forward's
warpgroups issuing their products in turns, dq's not, the q tile on the
grid's fast axis; and for dk/dv the raw scores in the exchange (each
warpgroup computing P itself) instead of P times the softcap's factor,
32-row Q/dO stages (three of them) instead of two 48-row ones, and CUDA's
tanhf and exp2f, with or without a division a score, instead of tanh and
2^x on the special-function unit).
Each is built with the repository's nvcc flags into ``build/ab/<name>/``
(a patched header beside the sources that include it), then checked in a
process of its own against the plain version on every bf16 case above D
128 of ``chip_smoke.py`` phases 2 and 3 (same tolerances), so a variant
that faults or disagrees is reported and left out of the timing without
stopping the others.  A variant named ``nocheck_...`` is a diagnostic
that computes a wrong result by design (``nocheck_no_loads``: no K/V
(dk/dv: Q/dO) tile loaded after the first stages, so its time is the
kernels' without waiting on loads; ``nocheck_no_exp``: dk/dv's P taken as
the raw score, so its time is the kernel's without the tanh and exp); it
is timed unchecked.  The variants that pass are then timed at
gemma2-2b's shape (B=2, L=4096, Hq=8, Hkv=4, D=288, causal, softcap 50,
bf16) in turns (A B C .. C B A; 21 CUDA-event timings a pass after 3
warm-ups).
Prints the card's name and power limit first; exits non-zero if a variant
fails to build, or the kept one fails its check.

With ``--d384``, the bf16 forward at D 384 instead,
``csrc/flash_fwd_sm90_d384.cu`` (``DEFAULT_D384``: the kept kernel, each
warpgroup computing the whole S, against the split contraction with its
partials summed through shared memory; a stage released by an atomic
count; three 32-key stages; three warpgroups of 128 columns and one of
all 384), through ``scripts/ab_narrow_sm90.py``'s ``fwd_ab``: checked on
phase 2's bf16 cases at padded D 384 and timed at head dim 320 at
gemma2-2b's shape with softcap 50 and without, beside SDPA's forward;
``--parent`` adds the parent tree's bf16 FMA ``flash_fwd_wide.cu``.

With ``--d384-bwd``, the bf16 dq and dk/dv at D 384 instead,
``csrc/flash_bwd_sm90_d384.cu`` (``DEFAULT_D384_BWD``: the kept kernels
against dq with each warpgroup computing the whole S and dP, no exchange;
dk/dv with the column half on the grid's slow axis; and the diagnostic
without the staged loads), each built by ``scripts/ab_narrow_sm90.py``'s
``build_variant``, checked in a process of its own on every bf16 case of
phase 3 at padded D 384 (the full and ragged shapes at head dim 320 among
them) and timed in turns at head dim 320 at gemma2-2b's shape, softcap 50
and 0, one call a timing (21 after 3 warm-ups) and back to back (5 x 20),
beside SDPA's backward on repeated K/V (the backend that runs at D 320,
no softcap) timed both ways; ``--parent`` adds the parent tree's wide
``flash_bwd_wide.cu`` (the bf16 FMA pair these kernels replace) under the
new entry points' names.
"""
from __future__ import annotations

import ctypes
import functools
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad  # noqa: E402

# kernel -> (source, library name the wrapper loads, its cached accessor)
KERNELS = {"fwd": ("flash_fwd_sm90_wide", fa._fwd_sm90w_lib),
           "dq": ("flash_dq_sm90_wide", fa._dq_sm90w_lib),
           "dkv": ("flash_dkv_sm90_wide", fa._dkv_sm90w_lib)}
# dk/dv's tanh and 2^x as kept (on the special-function unit), and as
# CUDA's tanhf and exp2f compute them.
DKV_TANH_NEW = ("                const float th =\n"
                "                    1.f - __fdividef(2.f, ex2(x[i] * tin) + "
                "1.f);\n"
                "                p = ex2(outer * th - rs[2 * j + h]);")
DKV_TANH_OLD = ("                const float th = tanhf(x[i] * (a.scale / "
                "a.softcap));\n"
                "                p = exp2f(outer * th - rs[2 * j + h]);")
DKV_TANHF = {DKV_TANH_NEW: DKV_TANH_OLD,
             "p = ex2(fmaf(x[i], lin, -rs[2 * j + h]));":
             "p = exp2f(fmaf(x[i], lin, -rs[2 * j + h]));"}
# dk/dv with the raw scores S^T in the exchange: warpgroup 0 sends them as
# soon as its first product is done, and warpgroup 1 computes P, the
# softcap's factor and the mask itself, from the columns' lse and dsum.
DKV_SCORES = {
    "      float rs[kN / 2];                   // column 2j + h's shift or "
    "dsum\n":
    "      float rs[kN / 2];                   // column 2j + h's shift or "
    "dsum\n      float ls[kN / 2];\n",
    "          rs[2 * j + h] = wg == 1 ? v : (v <= kNegInf / 2 ? 0.f : v) * "
    "kLog2e;\n":
    "          rs[2 * j + h] = wg == 1 ? v : (v <= kNegInf / 2 ? 0.f : v) * "
    "kLog2e;\n          ls[2 * j + h] = (wg == 1 && q0 + c < a.lq) ? "
    "a.lse[static_cast<size_t>(b) * a.lq + q0 + c] : kNegInf;\n",
    "        bar_wait(kRead);\n#pragma unroll\n"
    "        for (int i = 0; i < kN / 4; ++i)\n"
    "          xch[i * kThreads + t] =\n"
    "              make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], "
    "x[4 * i + 3]);\n        bar_arrive(kWritten);\n      } else {\n":
    "      } else {\n",
    "        // P^T, masked, into frag; P^T times the softcap's factor into "
    "x.\n":
    "        bar_wait(kRead);\n#pragma unroll\n"
    "        for (int i = 0; i < kN / 4; ++i)\n"
    "          xch[i * kThreads + t] =\n"
    "              make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], "
    "x[4 * i + 3]);\n        bar_arrive(kWritten);\n",
    "        // dS^T = PF * (dP^T - dsum) * scale into frag.\n"
    "        bar_wait(kWritten);\n#pragma unroll\n"
    "        for (int i = 0; i < kN / 4; ++i) {\n"
    "          const float4 pf = xch[i * kThreads + t];\n"
    "          x[4 * i] = pf.x * (x[4 * i] - rs[2 * i]) * a.scale;\n"
    "          x[4 * i + 1] = pf.y * (x[4 * i + 1] - rs[2 * i + 1]) * "
    "a.scale;\n"
    "          x[4 * i + 2] = pf.z * (x[4 * i + 2] - rs[2 * i]) * a.scale;\n"
    "          x[4 * i + 3] = pf.w * (x[4 * i + 3] - rs[2 * i + 1]) * "
    "a.scale;\n        }\n        bar_arrive(kRead);\n":
    "        float sc[kN];\n        bar_wait(kWritten);\n"
    "#pragma unroll\n        for (int i = 0; i < kN / 4; ++i) {\n"
    "          const float4 v = xch[i * kThreads + t];\n"
    "          sc[4 * i] = v.x; sc[4 * i + 1] = v.y;\n"
    "          sc[4 * i + 2] = v.z; sc[4 * i + 3] = v.w;\n        }\n"
    "        bar_arrive(kRead);\n"
    "        const int* docp =\n"
    "            a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq"
    "\n                     : nullptr;\n"
    "        const bool full = tile_full<kQRows, kTile>(\n"
    "            a, q0, k0, a.packed ? docp[min(q0 + kQRows, a.lq) - 1] : 0);"
    "\n#pragma unroll\n"
    "        for (int j = 0; j < kQRows / 8; ++j)\n#pragma unroll\n"
    "          for (int half = 0; half < 2; ++half)\n#pragma unroll\n"
    "            for (int h = 0; h < 2; ++h) {\n"
    "              const int i = 4 * j + 2 * half + h;\n"
    "              const int row = q0 + 8 * j + 2 * (lane & 3) + h;\n"
    "              const float lse = ls[2 * j + h];\n"
    "              const float shift = (lse <= kNegInf / 2 ? 0.f : lse) * "
    "kLog2e;\n"
    "              float p, f = 1.f;\n"
    "              if (a.softcap != 0.f) {\n"
    "                const float th =\n"
    "                    1.f - __fdividef(2.f, ex2(sc[i] * tin) + 1.f);\n"
    "                p = ex2(outer * th - shift);\n"
    "                f = 1.f - th * th;\n"
    "              } else {\n"
    "                p = ex2(fmaf(sc[i], lin, -shift));\n"
    "              }\n"
    "              float ds = p * f * (x[i] - rs[2 * j + h]) * a.scale;\n"
    "              if (!full) {\n"
    "                const int qlog =\n"
    "                    logical_pos(row, a.q_off_lo, a.q_off_hi, a.q_seg);"
    "\n                const int qdoc =\n"
    "                    (a.packed && row < a.lq) ? docp[row] : kDocAbsent;"
    "\n                if (!visible(a, row, qlog, qdoc, key_a + 8 * half)) "
    "ds = 0.f;\n              }\n"
    "              x[i] = ds;\n            }\n",
}
DEFAULT = [
    ["kept", {}],
    ["keys32", {"fwd": {"kKeys = 48;": "kKeys = 32;",
                        "kStages = 2;": "kStages = 3;"},
                "dq": {"kKeys = 48;": "kKeys = 32;",
                       "kStages = 2;": "kStages = 3;"}}],
    ["one_warpgroup", {"fwd": {"kWarpgroups = 2;": "kWarpgroups = 1;"},
                       "dq": {"kWarpgroups = 2;": "kWarpgroups = 1;"}}],
    ["tail_chunk", {"common": {"kN1 = (D - kN0 + 7) / 8 * 8;":
                               "kN1 = (D - kN0 + 63) / 64 * 64;"}}],
    # The forward's warpgroups taking turns on the tensor cores as dq's do:
    # each issues its products on every tile (P = 0 on one its rows do not
    # see), so that no wgmma sits on a divergent path.
    ["fwd_turns", {"fwd": {
        "constexpr int kKeys = 48;        // keys a stage\n":
        "constexpr int kKeys = 48;        // keys a stage\n"
        "__device__ __forceinline__ void turn_wait(int wg) {\n"
        "  asm volatile(\"bar.sync %0, %1;\\n\" :: \"r\"(3 + wg), "
        "\"r\"(2 * kThreads) : \"memory\");\n}\n"
        "__device__ __forceinline__ void turn_pass(int wg) {\n"
        "  asm volatile(\"bar.arrive %0, %1;\\n\" :: \"r\"(3 + (wg ^ 1)), "
        "\"r\"(2 * kThreads) : \"memory\");\n}\n",
        "    mbar_wait(&bars[kStages], 0);\n":
        "    mbar_wait(&bars[kStages], 0);\n    if (wg == 1) turn_pass(wg);\n",
        "      if (runs) {\n": "      turn_wait(wg);\n      {\n",
        "        wgmma_commit();\n        wgmma_wait_all();\n        pin(sc);":
        "        wgmma_commit();\n        turn_pass(wg);\n"
        "        wgmma_wait_all();\n        pin(sc);",
        "                                tile_full<kTile, kKeys>":
        "                                runs && tile_full<kTile, kKeys>",
        "        // O += P.V (V MN-major: K = the stage's keys).\n":
        "        // O += P.V (V MN-major: K = the stage's keys).\n"
        "        turn_wait(wg);\n",
        "        wgmma_commit();\n        wgmma_wait_all();\n        pin(o);":
        "        wgmma_commit();\n        turn_pass(wg);\n"
        "        wgmma_wait_all();\n        pin(o);",
        "    }\n  }\n\n  // out = O / l":
        "    }\n    if (wg == 0) turn_wait(wg);\n  }\n\n  // out = O / l"}}],
    ["dq_no_turns", {"dq": {"if constexpr (kWarpgroups == 2)\n    asm":
                            "if constexpr (false)\n    asm"}}],
    ["dkv_scores", {"dkv": DKV_SCORES}],
    ["dkv_rows32", {"dkv": {"kQRows = 48;": "kQRows = 32;",
                            "kStages = 2;": "kStages = 3;"}}],
    # dk/dv with CUDA's tanhf and exp2f (as ``p_ds_exp2``) instead of tanh
    # and 2^x on the special-function unit; ``dkv_div`` also divides each
    # score by the softcap, as ``p_ds_exp2`` does, instead of multiplying
    # by a factor taken once.
    ["dkv_tanhf", {"dkv": DKV_TANHF}],
    ["dkv_div", {"dkv": {**DKV_TANHF, DKV_TANH_NEW: DKV_TANH_OLD.replace(
        "x[i] * (a.scale / a.softcap)", "x[i] * a.scale / a.softcap")}}],
    # A diagnostic, wrong by design: dk/dv's warpgroup 0 takes P = S^T
    # (no tanh, no exp), so the time is the kernel's without them.
    ["nocheck_no_exp", {"dkv": {
        "              float p, f = 1.f;\n"
        "              if (a.softcap != 0.f) {\n"
        "                const float th =\n"
        "                    1.f - __fdividef(2.f, ex2(x[i] * tin) + 1.f);\n"
        "                p = ex2(outer * th - rs[2 * j + h]);\n"
        "                f = 1.f - th * th;\n"
        "              } else {\n"
        "                p = ex2(fmaf(x[i], lin, -rs[2 * j + h]));\n"
        "              }\n":
        "              float p = x[i], f = 1.f;\n"}}],
    # The q tile on the grid's fast axis: the blocks on the card at once
    # share fewer K/V heads.
    ["head_major", {
        "fwd": {"const int b = blockIdx.x;\n  const int qb = (gridDim.y - 1 - "
                "blockIdx.y)": "const int b = blockIdx.y;\n  const int qb = "
                "(gridDim.x - 1 - blockIdx.x)",
                "const dim3 grid(a.bh, (a.lq + rows - 1) / rows);":
                "const dim3 grid((a.lq + rows - 1) / rows, a.bh);"},
        "dq": {"const int b = blockIdx.x;\n  const int q0 = (gridDim.y - 1 - "
               "blockIdx.y)": "const int b = blockIdx.y;\n  const int q0 = "
               "(gridDim.x - 1 - blockIdx.x)",
               "const dim3 grid(a.bh, (a.lq + kTile - 1) / kTile);":
               "const dim3 grid((a.lq + kTile - 1) / kTile, a.bh);"}}],
    # A diagnostic, wrong by design: no K/V (dk/dv: Q/dO) tile is loaded
    # after the first kStages, so the products run on stale tiles and the
    # time is what the kernels take without waiting on loads.
    ["nocheck_no_loads", {
        "fwd": {"        if (done % kWarpgroups == kWarpgroups - 1 && "
                "nfar < nk)\n          tma_pair<D, kKeys>(sK, &tm_k, &tm_v, "
                "&bars[s], nfar * kKeys, bkv);": "        (void)done;",
                "      mbar_wait(&bars[s], (it / kStages) & 1);":
                "      if (it < kStages) mbar_wait(&bars[s], 0);"},
        "dq": {"        if (t == 0 && nfar < nk)\n          tma_pair<D, kKeys>"
               "(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, bkv);": "",
               "        mbar_wait(&bars[s], (it / kStages) & 1);":
               "        if (it < kStages) mbar_wait(&bars[s], 0);"},
        "dkv": {"        if (done % 2 == 1 && nfar < steps)\n":
                "        if (false && done)\n",
                "      mbar_wait(&bars[s], (it / kStages) & 1);":
                "      if (it < kStages) mbar_wait(&bars[s], 0);"}}],
]


# The forward at D 384 (``--d384``): csrc/flash_fwd_sm90_d384.cu's variants,
# built, checked and timed by scripts/ab_narrow_sm90.py's ``fwd_ab`` at head
# dim 320 (gemma2-2b's shape otherwise).  ``wgmma_rs_mn`` at N = 128 (three
# or one warpgroup a block own 128 or 256 + 128 of O's columns).
D384 = "flash_fwd_sm90_d384"
RS_MN_128 = {"  } else if constexpr (N == 64) {\n    wgmma_rs_n64(d, a, db);":
             "  } else if constexpr (N == 128) {\n    wgmma_rs_n128(d, a, db);\n"
             "  } else if constexpr (N == 64) {\n    wgmma_rs_n64(d, a, db);"}
# The split contraction: warpgroup w computes S over Q's and K's columns
# of its own O columns only, and the partials are summed through shared
# memory behind a block barrier (in the same order in every warpgroup).
D384_EXCHANGE = {
    '  static constexpr int kBars = kRing + kStages * kStage;\n':
    '  static constexpr int kPartial = kTile * kKeys * 4;        // one S'
    ' partial\n'
    '  static constexpr int kExchange = kRing + kStages * kStage;\n'
    '  static constexpr int kBars = kExchange + kWarpgroups * kPartial;\n',
    '  constexpr int kCols = D / kWarpgroups;       // O columns a warpgroup\n':
    '  constexpr int kCols = D / kWarpgroups;       // O columns a warpgroup\n'
    '  constexpr int kSteps = D / 16 / kWarpgroups; // S k steps a warpgroup\n',
    '  const ScoreFactors f = score_factors(a);\n':
    '  const ScoreFactors f = score_factors(a);\n'
    "  // The warpgroups' partials of S as float4s: thread t of warpgroup w\n"
    '  // holds the i-th four of its accumulator at parts[w * kPart4 + i *\n'
    '  // kThreads + t].\n'
    '  constexpr int kPart4 = L::kPartial / 16;\n'
    '  float4* parts = reinterpret_cast<float4*>(smem + L::kExchange);\n',
    '      // S = Q.K^T (both K-major from shared memory): rows are q rows,\n'
    '      // columns keys; each warpgroup computes all of it.\n'
    '      float sc[kKeys / 2];\n'
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < D / 16; ++kk)\n'
    '        wgmma_ss<kKeys>(sc, desc_k(sQ, kk), desc_k(sK, kk, kKeys *'
    ' 128), kk);\n'
    '      wgmma_commit();\n'
    '      wgmma_wait_all();\n'
    '      pin(sc);\n':
    "      // This warpgroup's partial S = Q[:, cols].K[:, cols]^T (both"
    ' K-major\n'
    '      // from shared memory): rows are q rows, columns keys.\n'
    '      float sc[kKeys / 2];\n'
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < kSteps; ++kk)\n'
    '        wgmma_ss<kKeys>(sc, desc_k(sQ, wg * kSteps + kk),\n'
    '                        desc_k(sK, wg * kSteps + kk, kKeys * 128), kk);\n'
    '      wgmma_commit();\n'
    '      wgmma_wait_all();\n'
    '      pin(sc);\n'
    '      if constexpr (kWarpgroups > 1) {\n'
    "        // S = the partials' sum, taken in the same order in every\n"
    '        // warpgroup, so all hold the same S bit for bit.\n'
    '#pragma unroll\n'
    '        for (int i = 0; i < kKeys / 8; ++i)\n'
    '          parts[wg * kPart4 + i * kThreads + t] = make_float4(\n'
    '              sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);\n'
    '        __syncthreads();             // every partial written\n'
    '#pragma unroll\n'
    '        for (int i = 0; i < kKeys / 8; ++i) {\n'
    '          float4 x = parts[i * kThreads + t];\n'
    '#pragma unroll\n'
    '          for (int w = 1; w < kWarpgroups; ++w) {\n'
    '            const float4 y = parts[w * kPart4 + i * kThreads + t];\n'
    '            x.x += y.x;\n'
    '            x.y += y.y;\n'
    '            x.z += y.z;\n'
    '            x.w += y.w;\n'
    '          }\n'
    '          sc[4 * i] = x.x;\n'
    '          sc[4 * i + 1] = x.y;\n'
    '          sc[4 * i + 2] = x.z;\n'
    '          sc[4 * i + 3] = x.w;\n'
    '        }\n'
    '      }\n',
}
# A stage released by the last warpgroup to count itself in (an atomic add
# in shared memory, as csrc/flash_fwd_sm90_wide.cu does) instead of a block
# barrier, so the warpgroups can drift apart.
D384_COUNT = {
    "  static constexpr int kBytes = kBars + (kStages + 1) * 8 + 1024;  "
    "// + slack\n":
    "  static constexpr int kCounts = kBars + (kStages + 1) * 8;\n"
    "  static constexpr int kBytes = kCounts + kStages * 4 + 1024;\n",
    "  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);\n":
    "  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);\n"
    "  unsigned* counts = reinterpret_cast<unsigned*>(smem + L::kCounts);\n",
    "      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);\n":
    "      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);\n"
    "      for (int i = 0; i < kStages; ++i) counts[i] = 0;\n",
    "      __syncthreads();               // stage s is free\n"
    "      if (tid == 0 && nfar < nk)\n"
    "        tma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, "
    "bkv);\n":
    "      warpgroup_sync(wg);\n"
    "      if (t == 0) {\n"
    "        __threadfence_block();\n"
    "        const unsigned done = atomicAdd(&counts[s], 1u);\n"
    "        if (done % kWarpgroups == kWarpgroups - 1 && nfar < nk)\n"
    "          tma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, "
    "bkv);\n"
    "      }\n"}
DEFAULT_D384 = [
    ["d384_kept", {"source": D384}],
    ["d384_exchange", {"source": D384, **D384_EXCHANGE}],
    ["d384_count", {"source": D384, **D384_COUNT}],
    # 32-key stages, three of them.
    ["d384_stages3", {"source": D384, "kKeys = 48;": "kKeys = 32;",
                      "kStages = 2;": "kStages = 3;"}],
    # Three warpgroups of 128 columns with the split contraction; 32-key
    # stages, so that the three partials fit.
    ["d384_wg3", {"source": D384, "common": RS_MN_128, **D384_EXCHANGE,
                  "kWarpgroups = 2;": "kWarpgroups = 3;",
                  "kKeys = 48;": "kKeys = 32;"}],
    # One warpgroup holding all of O (192 floats a thread), 32-key stages.
    ["d384_wg1", {"source": D384, "common": RS_MN_128,
                  "kWarpgroups = 2;": "kWarpgroups = 1;",
                  "kKeys = 48;": "kKeys = 32;"}],
]


# The dq and dk/dv at D 384 (``--d384-bwd``): csrc/flash_bwd_sm90_d384.cu's
# variants, timed at head dim 320 (gemma2-2b's shape otherwise).
D384_BWD = "flash_bwd_sm90_d384"
D384_BWD_SRC = build.CSRC / f"{D384_BWD}.cu"
DQ_BODY = ("      // S = Q.K^T (warpgroup 0) or dP = dO.V^T (1)",
           "      // dQ[:, cols] += dS.K[:, cols]")


def _span(path: Path, start: str, end: str) -> str:
    """The text of ``path`` from ``start`` up to (not including) ``end``."""
    text = path.read_text()
    i = text.index(start)
    return text[i:text.index(end, i)]


# dq with each warpgroup computing the whole S and dP and forming dS
# itself: 5/3 of the function's tensor work and no exchange, as the D 384
# forward computes S in each warpgroup.
DQ_RECOMPUTE = {_span(D384_BWD_SRC, *DQ_BODY): """\
      // S = Q.K^T and dP = dO.V^T in each warpgroup, and dS from them.
      float sc[kKeys / 2], dp[kKeys / 2];
      uint32_t frag[kKeys / 16][4];       // dS, bf16 pairs
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kKeys>(sc, desc_k(sQ, kk), desc_k(sK, kk, kKeys * 128), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kKeys>(dp, desc_k(sDO, kk), desc_k(sV, kk, kKeys * 128), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);
      const bool full = tile_full<kTile, kKeys>(a, q0, k0, doc_last);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float ds2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * half + h;
            float f;
            float p = p_of(a, sc[i], shift_l2[half], lin, tin, outer, f);
            if (!full && !visible(a, row_a + 8 * half, qlog[half],
                                  qdoc[half], k0 + 8 * j + 2 * (lane & 3) + h))
              p = 0.f;
            ds2[h] = p * f * (dp[i] - dsum[half]) * a.scale;
          }
          frag[j >> 1][(j & 1) * 2 + half] = pack_bf16(ds2[0], ds2[1]);
        }

"""}
# dk/dv with the column half on the grid's slow axis (the two blocks of a
# key tile far apart in the launch order).
DKV_SLOW = {
    "  const int part = blockIdx.x;            // output columns kCols * part\n"
    "  const int bkv = blockIdx.y;\n  const int k0 = blockIdx.z * kTile;":
    "  const int part = blockIdx.z;\n  const int bkv = blockIdx.x;\n"
    "  const int k0 = blockIdx.y * kTile;",
    "dim3(2, bhkv, (lk + kTile - 1) / kTile)":
    "dim3(bhkv, (lk + kTile - 1) / kTile, 2)"}
DEFAULT_D384_BWD = [
    ["bwd384_kept", {"source": D384_BWD}],
    ["bwd384_dq_recompute", {"source": D384_BWD, **DQ_RECOMPUTE}],
    ["bwd384_dkv_slow_axis", {"source": D384_BWD, **DKV_SLOW}],
    # Diagnostics, wrong by design: P taken as the scaled, shifted score
    # (no tanh, no exp2), so the time is the kernels' without the special
    # functions; the first products (S, dP; S^T, dP^T) over half of the 384
    # columns, so the time is the kernels' with half of that work; and no
    # K/V (dk/dv: Q/dO) tile loaded after the first kStages, so the time is
    # the kernels' without waiting on the loads from L2.
    ["bwd384_nocheck_no_exp", {
        "source": D384_BWD,
        "  if (a.softcap != 0.f) {\n"
        "    const float th = 1.f - __fdividef(2.f, ex2(s * tin) + 1.f);\n"
        "    f = 1.f - th * th;\n    return ex2(outer * th - shift);\n  }\n"
        "  f = 1.f;\n  return ex2(fmaf(s, lin, -shift));":
        "  f = 1.f;\n  return fmaf(s, lin, -shift);"}],
    ["bwd384_nocheck_half_depth", {
        "source": D384_BWD,
        "      for (int kk = 0; kk < D / 16; ++kk)\n        wgmma_ss<kKeys>(x,":
        "      for (int kk = 0; kk < D / 32; ++kk)\n        wgmma_ss<kKeys>(x,",
        "      for (int kk = 0; kk < D / 16; ++kk)\n        wgmma_ss<kQRows>(x,":
        "      for (int kk = 0; kk < D / 32; ++kk)\n        wgmma_ss<kQRows>(x,"}],
    ["bwd384_nocheck_no_loads", {
        "source": D384_BWD,
        "      if (t == 0 && release(counts, s) && nfar < nk)\n":
        "      if (false)\n",
        "      if (t == 0 && release(counts, s) && nfar < steps)\n":
        "      if (false)\n",
        "      mbar_wait(&bars[s], (it / kStages) & 1);":
        "      if (it < kStages) mbar_wait(&bars[s], 0);"}],
]


def use_d384_bwd(path) -> None:
    """Route the sm90w wrappers at D 384 to the library at ``path``."""
    fa._bwd_sm90w384_lib.cache_clear()
    build._LOADED[D384_BWD] = ctypes.CDLL(str(path))


def check_d384_bwd(name: str, path) -> None:
    """Every bf16 case of phase 3 at padded D 384 on ``path``'s kernels;
    raises on a disagreement."""
    from repro_torch.kernels.ops import _d_pad

    use_d384_bwd(path)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case, q, k, v, do, kw in cs.bwd_cases(gen):
        if q.dtype == torch.bfloat16 and _d_pad(q.shape[3]) == 384:
            cs.check_bwd(f"{name}:{case}", q, k, v, do, kw)
            torch.cuda.empty_cache()


def d384_bwd_ab(spec: list, parent: Path | None) -> int:
    """Build, check and time the D 384 backward's variants ``spec`` (and,
    with ``parent``, the parent tree's wide FMA pair under the new entry
    names), as ``ab_narrow_sm90.fwd_ab`` does the forward's."""
    import ab_narrow_sm90
    from torch.nn.attention import sdpa_kernel

    jobs = [(name, reps, build.CSRC) for name, reps in spec]
    if parent:
        jobs.append(("bwd384_parent_fma", {"source": "flash_bwd_wide"},
                     parent.resolve()))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: ab_narrow_sm90.build_variant(*job),
                              jobs))
    passed = {}
    for name, path, log in built:
        print(f"{name}: ptxas {cs.ptxas_summary(log)}", flush=True)
        for line in log.splitlines():
            if "wgmma" in line and "serialized" in line:
                print(f"    {line.strip()}")
        if "nocheck_" in name:
            print(f"{name}: not checked (a diagnostic)")
            passed[name] = path
            continue
        proc = subprocess.run([sys.executable, __file__, "--check-d384-bwd",
                               name, str(path)], capture_output=True,
                              text=True, timeout=900)
        cases = proc.stdout.count(" ok\n")
        if proc.returncode == 0:
            print(f"{name}: {cases} cases within tolerance", flush=True)
            passed[name] = path
        else:
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-8:]
            print(f"{name}: FAILED after {cases} cases:\n    "
                  + "\n    ".join(tail), flush=True)
    if not any(name.endswith("kept") for name in passed):
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, hq, hkv, d = cs.BATCH, cs.PROMPT, cs.GEMMA_HQ, cs.GEMMA_HKV, 320
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, l, hq, d), (b, l, hkv, d),
                                 (b, l, hkv, d), (b, l, hq, d)))
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, causal=True)
    dof = _fold_pad(do, qf.shape[2])
    caps = (cs.GEMMA_CAP, 0.0)
    calls = {}                  # (softcap, kernel) -> the call
    for cap in caps:
        pc = p._replace(softcap=cap)
        out, lse = fa._fwd_plain(qf, kf, vf, pc, band=band, doc=doc)
        dsum = (dof.float() * out.float()).sum(dim=-1)
        calls[cap, "dq"] = functools.partial(fa._dq_cuda, qf, kf, vf, dof,
                                             lse, dsum, pc, band, doc)
        calls[cap, "dkv"] = functools.partial(fa._dkv_cuda, qf, kf, vf, dof,
                                              lse, dsum, pc, band, doc)
        del out
    names = list(passed)
    # name -> (way, softcap, kernel) -> milliseconds
    times = {name: {(way, *key): [] for way in ("call", "loop")
                    for key in calls} for name in names}
    for name in [*names, *reversed(names)]:
        use_d384_bwd(passed[name])
        n0 = cs.launch_counts()
        for key, fn in calls.items():
            times[name]["call", *key] += cs.cuda_times(fn, reps=21, warmup=3)
            times[name]["loop", *key] += cs.cuda_loop_times(fn)
        moved = cs.launches_since(n0)
        if (moved["dq_sm90w"], moved["dkv_sm90w"]) != (254, 254):
            print(f"{name}: the timing left the sm90w route: {moved}")
            return 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    backend = cs.sdpa_backend(qt, *(x.detach().repeat_interleave(
        hq // hkv, dim=1).requires_grad_() for x in (kt, vt)))
    with sdpa_kernel([backend]):
        out = sdpa(qt, kt.repeat_interleave(hq // hkv, dim=1),
                   vt.repeat_interleave(hq // hkv, dim=1), is_causal=True)

        def grad():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib = {"call": cs.cuda_times(grad, reps=21, warmup=3),
               "loop": cs.cuda_loop_times(grad)}
    bounds = {"dq": cs.bwd_bound(q, k, 3, torch.bfloat16),
              "dkv": cs.bwd_bound(q, k, 4, torch.bfloat16)}
    for name in names:
        for (way, cap, key), ts in times[name].items():
            med = statistics.median(ts)
            bound, _, flops = bounds[key]
            quart = statistics.quantiles(ts, n=4)
            print(f"{name} {key} softcap {cap:g} ({way}): median {med:.4f} "
                  f"ms over {len(ts)} ({flops / med / 1e9:.1f} TFLOP/s at "
                  f"head dim 320, {100 * bound / med:.2f}% of the "
                  f"{bound:.4f} ms bound), quartiles {quart[0]:.4f}-"
                  f"{quart[2]:.4f} ms, min {min(ts):.4f}")
        for way in ("call", "loop"):
            for cap in caps:
                pair = sum(statistics.median(times[name][way, cap, key])
                           for key in ("dq", "dkv"))
                print(f"{name} pair softcap {cap:g} ({way}): {pair:.4f} ms")
    for way, ts in lib.items():
        print(f"sdpa backward ({backend.name}, repeated kv, no softcap, "
              f"{way}): median {statistics.median(ts):.4f} ms over "
              f"{len(ts)}, min {min(ts):.4f}, max {max(ts):.4f}")
    return 0


def patched(name: str, path: Path, reps: dict) -> str:
    """``path``'s text with the textual replacements ``reps``."""
    text = path.read_text()
    for old, new in reps.items():
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {path.name}")
        text = text.replace(old, new)
    return text


def build_variant(name: str, reps: dict) -> tuple[str, dict, str]:
    """Both sources with the textual replacements ``reps``, built into
    ``build/ab/<name>/<source>.so``; returns (name, {kernel: library
    path}, ptxas log)."""
    out = build.BUILD_DIR.parent / "ab" / name
    out.mkdir(parents=True, exist_ok=True)
    header = out / "sm90_common.cuh"     # found first: beside the sources
    header.unlink(missing_ok=True)
    if "common" in reps:
        header.write_text(patched(name, build.CSRC / header.name,
                                  reps["common"]))
    paths, log = {}, ""
    for kernel, (source, _) in KERNELS.items():
        text = patched(name, build.CSRC / f"{source}.cu",
                       reps.get(kernel, {}))
        cu, so = out / f"{source}.cu", out / f"{source}.so"
        cu.write_text(text)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                               str(build.CSRC), "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{source}:\n"
                               f"{proc.stderr}")
        paths[kernel], log = so, log + proc.stdout + proc.stderr
    return name, paths, log


def use(paths: dict):
    """Route the wrappers' sm90w kernels to these libraries."""
    for kernel, (source, accessor) in KERNELS.items():
        accessor.cache_clear()
        build._LOADED[source] = ctypes.CDLL(str(paths[kernel]))


def check_variant(name: str, paths: dict) -> None:
    """Every bf16 case above D 128 of phases 2 and 3 on ``paths``'
    kernels; raises on a disagreement."""
    use(paths)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case, q, k, v, kw in cs.kernel_cases(gen):
        if q.dtype == torch.bfloat16 and q.shape[3] > 128:
            cs.check_kernel(f"{name}:{case}", q, k, v, kw)
    for case, q, k, v, do, kw in cs.bwd_cases(gen):
        if q.dtype == torch.bfloat16 and q.shape[3] > 128:
            cs.check_bwd(f"{name}:{case}", q, k, v, do, kw)
            torch.cuda.empty_cache()


def gemma_operands():
    """gemma2-2b's folded bf16 operands, its plain (out, lse) and dsum."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, hq, hkv, d = cs.BATCH, cs.PROMPT, cs.GEMMA_HQ, cs.GEMMA_HKV, \
        cs.GEMMA_D
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, l, hq, d), (b, l, hkv, d),
                                 (b, l, hkv, d), (b, l, hq, d)))
    qf, kf, vf, p, band, doc = _fold_chunk_args(
        q, k, v, causal=True, softcap=cs.GEMMA_CAP)
    dof = _fold_pad(do, qf.shape[2])
    out, lse = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    dsum = (dof.float() * out.float()).sum(dim=-1)
    return (q, k), (qf, kf, vf, dof, lse, dsum, p, band, doc)


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_wide_sm90: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--check"]:        # a child: one variant's check
        name, *paths = sys.argv[2:]
        check_variant(name, dict(zip(KERNELS, paths)))
        return 0
    if sys.argv[1:2] == ["--check-d384-bwd"]:   # a child: one variant's
        check_d384_bwd(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] in (["--d384"], ["--d384-bwd"]):
        import ab_narrow_sm90

        mode, args = sys.argv[1], sys.argv[2:]
        parent = None
        if args[:1] == ["--parent"]:
            parent, args = Path(args[1]), args[2:]
        default = DEFAULT_D384 if mode == "--d384" else DEFAULT_D384_BWD
        named = dict((name, reps) for name, reps in default)
        spec = [[v, named[v]] for v in args] or default
        print(cs.smi_line(), flush=True)
        if mode == "--d384-bwd":
            return d384_bwd_ab(spec, parent)
        return ab_narrow_sm90.fwd_ab("d384", spec, parent)
    spec = json.loads(Path(sys.argv[1]).read_text()) if len(sys.argv) > 1 \
        else DEFAULT
    named = dict((name, reps) for name, reps in DEFAULT)
    spec = [[v, named[v]] if isinstance(v, str) else v for v in spec]
    print(cs.smi_line(), flush=True)
    with ThreadPoolExecutor(len(spec)) as pool:
        built = list(pool.map(lambda v: build_variant(*v), spec))
    passed = {}
    for name, paths, log in built:
        print(f"{name}: ptxas {cs.ptxas_summary(log)}")
        for line in log.splitlines():
            if "wgmma" in line and "serialized" in line:
                print(f"    {line.strip()}")
        if name.startswith("nocheck_"):
            print(f"{name}: not checked (a diagnostic)")
            passed[name] = paths
            continue
        proc = subprocess.run(
            [sys.executable, __file__, "--check", name,
             *(str(paths[kernel]) for kernel in KERNELS)],
            capture_output=True, text=True, timeout=300)
        cases = proc.stdout.count(" ok\n")
        if proc.returncode == 0:
            print(f"{name}: {cases} cases within tolerance")
            passed[name] = paths
        else:
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-6:]
            print(f"{name}: FAILED after {cases} cases:\n    "
                  + "\n    ".join(tail))
    if "kept" not in passed and any(name == "kept" for name, _ in spec):
        return 1

    (q, k), (qf, kf, vf, dof, lse, dsum, p, band, doc) = gemma_operands()
    names = list(passed)
    times = {name: {key: [] for key in KERNELS} for name in names}
    for name in [*names, *reversed(names)]:
        use(passed[name])
        n0 = cs.launch_counts()
        times[name]["fwd"] += cs.cuda_times(
            lambda: fa._fwd(qf, kf, vf, p, band=band, doc=doc), reps=21,
            warmup=3)
        times[name]["dq"] += cs.cuda_times(
            lambda: fa._dq_cuda(qf, kf, vf, dof, lse, dsum, p, band, doc),
            reps=21, warmup=3)
        times[name]["dkv"] += cs.cuda_times(
            lambda: fa._dkv_cuda(qf, kf, vf, dof, lse, dsum, p, band, doc),
            reps=21, warmup=3)
        moved = cs.launches_since(n0)
        if [moved[f"{key}_sm90w"] for key in KERNELS] != [24] * 3:
            print(f"{name}: the timing left the sm90w route: {moved}")
            return 1
    bounds = {"fwd": cs.fwd_bound(q, k, torch.bfloat16),
              "dq": cs.bwd_bound(q, k, 3, torch.bfloat16),
              "dkv": cs.bwd_bound(q, k, 4, torch.bfloat16)}
    for name in names:
        for key, ts in times[name].items():
            med = statistics.median(ts)
            bound, _, flops = bounds[key]
            quart = statistics.quantiles(ts, n=4)
            print(f"{name} {key}: median {med:.4f} ms over {len(ts)} "
                  f"({flops / med / 1e9:.1f} TFLOP/s, "
                  f"{100 * bound / med:.2f}% of the {bound:.4f} ms bound), "
                  f"quartiles {quart[0]:.4f}-{quart[2]:.4f} ms, "
                  f"min {min(ts):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
