"""Compare the bf16 kernels at head dims 16 and 32 on one card.

    python3 scripts/ab_narrow_sm90.py [--parent PARENT_CSRC_DIR] [spec.json | NAME ...]
    python3 scripts/ab_narrow_sm90.py --fwd [--parent PARENT_CSRC_DIR] [NAME ...]
    python3 scripts/ab_narrow_sm90.py --header-from OTHER_CSRC_DIR

Each variant is ``csrc/flash_bwd_sm90_narrow.cu`` with textual
replacements (``[[name, {old: new}], ...]`` in ``spec.json``, or names
from the default list): by default the kept kernels against one
64-column chunk a row with the 128-byte swizzle instead of rows of D * 2
bytes with the 64- or 32-byte swizzle (``wide_rows``); 128 q rows a dk/dv
step (one N = 128 product for S^T) and 128 keys a dq step, each with two
blocks an SM; three blocks an SM instead of four, and five or six (which
spill); dk/dv's column stats loaded a step ahead instead of at the start
of their own step; three stages instead of two; and the products of
consecutive steps overlapped (``dq_overlap``, ``dkv_overlap``: the next
step's first products issued right after this step's second ones, one
wait for both, one block barrier a step), with three stages and at three
blocks an SM.  Beside them:

- ``sm90_d32``: ``csrc/flash_bwd_sm90.cu`` (the D 64 / 128 kernels) taken
  to D 16 / 32 as it is (64-row steps, ``p_ds_exp2``'s tanhf, exp2f and
  a division a score, stats in shared memory as two arrays);
- with ``--parent``, ``parent_fma``: PARENT_CSRC_DIR's ``flash_bwd.cu``,
  the fp32 FMA pair this route replaced (for example the parent commit's
  sources, unpacked with ``git archive`` into a git-ignored directory);
- diagnostics named ``nocheck_...``, wrong by design and timed unchecked:
  ``nocheck_no_exp`` takes P as the scaled, shifted score (no exp2), so
  its time is the kernels' without the special-function work;
  ``nocheck_no_loads`` loads no tile after the first stages, so its time
  is the kernels' without waiting on loads.

Every variant is built with the repository's nvcc flags into
``build/ab_narrow/<name>/`` under the ``sm90n`` route's entry-point
names, and held in a process of its own against the plain version on
every bf16 case of ``chip_smoke.py`` phase 3 whose padded head dim is 16
or 32, the timing shape among them (same tolerances), so a variant that
faults or disagrees is reported and left out of the timing.  The variants that
pass are timed at qwen3-1.7b's training shape at D = 32 (B=2, L=4096,
Hq=16, Hkv=8, causal, bf16) in turns (A B C .. C B A), each pass two
ways: 21 CUDA-event timings of one call each after 3 warm-ups (the way
``chip_smoke.py`` times, which counts the host's time to launch), and 5
timings of 20 calls back to back, divided by 20 (the kernels' own time
while the host keeps ahead); beside SDPA's backward alone on the same
inputs, timed both ways (``enable_gqa``; one forward, then
``autograd.grad`` with ``retain_graph``).  Prints the card's name and power limit first; exits
non-zero if a variant fails to build or the kept one fails its check.

With ``--fwd``, the same for the forward, ``csrc/flash_fwd_sm90_narrow.cu``
(``DEFAULT_FWD``: the kept kernel against 128-key steps, with two or three
stages, at three blocks an SM; three, four and six blocks an SM instead
of five; three or four stages instead of two; every second exponential
of the softmax as a polynomial on the FMA pipe, ``fwd_poly``; and the
diagnostic without the exp2), each checked on every bf16 case of
``chip_smoke.py`` phase 2 at padded D 16 / 32 and timed at the same
shape beside SDPA's forward (``enable_gqa``); ``--parent`` adds the
parent tree's FMA ``flash_fwd.cu`` under the sm90n forward's names.
Every variant is built with the source tree's headers beside it, patched
by the replacements under ``"common"`` (``sm90_common.cuh``) and
``"narrow"`` (``sm90_narrow.cuh``).  ``fwd_ab`` also serves
``scripts/ab_wide_sm90.py --d384``.

With ``--header-from``, every bf16 source of OTHER_CSRC_DIR (for example
the parent commit's; each includes ``sm90_common.cuh``) is built twice
instead, from this tree and from that one, and the script says, per
source, whether the two builds' SASS (``cuobjdump -sass``) and registers
are the same; it exits non-zero if any differs.
"""
from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels.ops import _d_pad, _fold_chunk_args, _fold_pad  # noqa: E402

SOURCE = "flash_bwd_sm90_narrow"
# Entry points of the sm90n route (and of the sm90w route at D 384), and the
# names other sources give them.
RENAME = {"flash_fwd": ["-Dflash_fwd=flash_fwd_sm90n",
                        "-Dflash_fwd_error_string=flash_fwd_sm90n_error_string"],
          "flash_fwd_wide": ["-Dflash_fwd_wide=flash_fwd_sm90w384",
                             "-Dflash_fwd_wide_error_string="
                             "flash_fwd_sm90w384_error_string"],
          "flash_bwd_sm90": ["-Dflash_bwd_dq_sm90=flash_bwd_dq_sm90n",
                             "-Dflash_bwd_dkv_sm90=flash_bwd_dkv_sm90n",
                             "-Dflash_bwd_sm90_error_string="
                             "flash_bwd_sm90n_error_string"],
          "flash_bwd": ["-Dflash_bwd_dq=flash_bwd_dq_sm90n",
                        "-Dflash_bwd_dkv=flash_bwd_dkv_sm90n",
                        "-Dflash_bwd_error_string="
                        "flash_bwd_sm90n_error_string"],
          "flash_bwd_wide": ["-Dflash_bwd_dq_wide=flash_bwd_dq_sm90w384",
                             "-Dflash_bwd_dkv_wide=flash_bwd_dkv_sm90w384",
                             "-Dflash_bwd_wide_error_string="
                             "flash_bwd_sm90w384_error_string"]}
# The D 64 / 128 source taken to D 16 / 32 as it is.
SM90_D32 = {
    "wgmma_rs<D>(": "wgmma_rs_mn<D>(",
    "(d != 64 && d != 128)": "(d != 16 && d != 32)",
    "return d == 128 ? launch<128>(which, a, maps, bhkv, st)\n"
    "                  : launch<64>(which, a, maps, bhkv, st);":
    "return d == 32 ? launch<32>(which, a, maps, bhkv, st)\n"
    "                 : launch<16>(which, a, maps, bhkv, st);"}
# dq with the products of consecutive steps overlapped: step it + 1's S and
# dP issued right after step it's dQ += dS.K, one wait for both, and step
# it - 1's stage refilled after that wait (``DQ_OVERLAP``).
DQ_OVERLAP_OLD = (
    '    mbar_wait(&bars[kStages], 0);\n'
    '\n'
    '    for (int it = 0; kt < nk; ++it) {\n'
    '      const int s = it % kStages;\n'
    '      const int k0 = kt * kKeys;\n'
    '      const uint32_t sK = sQ + L::kRing + L::kStage * s;\n'
    '      const uint32_t sV = sK + L::kTileBytes;\n'
    '      const int nfar =\n'
    '          far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)\n'
    '                   : nk;\n'
    '      mbar_wait(&bars[s], (it / kStages) & 1);\n'
    '\n'
    '      // S = Q.K^T and dP = dO.V^T: rows are q rows, columns keys.\n'
    '      float sc[kN], dp[kN];\n'
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < D / 16; ++kk)\n'
    '        wgmma_ss<kKeys>(sc, ndesc_k<D>(sQ, kk), ndesc_k<D>(sK, kk), kk);\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < D / 16; ++kk)\n'
    '        wgmma_ss<kKeys>(dp, ndesc_k<D>(sDO, kk), ndesc_k<D>(sV, kk), kk);\n'
    '      wgmma_commit();\n'
    '      wgmma_wait_all();\n'
    '      pin(sc);\n'
    '      pin(dp);\n'
    '\n'
    '      const bool full = tile_full<kTile, kKeys>(a, q0, k0, doc_last);\n'
    '      uint32_t dsa[kKeys / 16][4];\n'
    '      if (a.softcap != 0.f) {\n'
    '        if (full)\n'
    '          dq_scores<true, false, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,\n'
    '                                        row_a, qlog, qdoc, lane);\n'
    '        else\n'
    '          dq_scores<true, true, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,\n'
    '                                       row_a, qlog, qdoc, lane);\n'
    '      } else {\n'
    '        if (full)\n'
    '          dq_scores<false, false, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,\n'
    '                                         row_a, qlog, qdoc, lane);\n'
    '        else\n'
    '          dq_scores<false, true, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,\n'
    '                                        row_a, qlog, qdoc, lane);\n'
    '      }\n'
    '\n'
    "      // dQ += dS.K (B MN-major: K = the step's keys).\n"
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < kKeys / 16; ++kk)\n'
    '        wgmma_rs_mn<D>(dq, dsa[kk], ndesc_mn<D, kKeys>(sK, kk));\n'
    '      wgmma_commit();\n'
    '      wgmma_wait_all();\n'
    '      pin(dq);\n'
    '      __syncthreads();               // stage s is free\n'
    '      if (tid == 0 && nfar < nk)\n'
    '        ntma_pair<D, kKeys>(sK, &tm_k, &tm_v, &bars[s], nfar * kKeys, bkv);\n'
    '      far = nfar;\n'
    '      kt = next_k_tile<kTile, kKeys>(a, q0, doc_first, kt, nk);\n'
    '    }\n'
    '  }\n')
DQ_OVERLAP_NEW = (
    '    mbar_wait(&bars[kStages], 0);\n'
    '\n'
    "    // The products of consecutive steps overlap: step it + 1's S and dP\n"
    "    // are issued right after step it's dQ += dS.K, and one wait covers\n"
    '    // both.  dS stays in its registers until that wait.\n'
    '    float sc[kN], dp[kN];\n'
    '    uint32_t dsa[kKeys / 16][4];\n'
    '    mbar_wait(&bars[0], 0);\n'
    '    wgmma_fence();\n'
    '#pragma unroll\n'
    '    for (int kk = 0; kk < D / 16; ++kk)\n'
    '      wgmma_ss<kKeys>(sc, ndesc_k<D>(sQ, kk), ndesc_k<D>(sQ + L::kRing, kk),\n'
    '                      kk);\n'
    '#pragma unroll\n'
    '    for (int kk = 0; kk < D / 16; ++kk)\n'
    '      wgmma_ss<kKeys>(dp, ndesc_k<D>(sDO, kk),\n'
    '                      ndesc_k<D>(sQ + L::kRing + L::kTileBytes, kk), kk);\n'
    '    wgmma_commit();\n'
    '    for (int it = 0; kt < nk; ++it) {\n'
    '      const int s = it % kStages;\n'
    '      const int k0 = kt * kKeys;\n'
    '      const uint32_t sK = sQ + L::kRing + L::kStage * s;\n'
    '      const int kn = next_k_tile<kTile, kKeys>(a, q0, doc_first, kt, nk);\n'
    "      wgmma_wait_all();              // step it's S, dP; step it - 1's dQ\n"
    '      pin(sc);\n'
    '      pin(dp);\n'
    '      pin(dq);\n'
    '      pin_u(dsa);\n'
    "      __syncthreads();               // step it - 1's stage is free\n"
    '      if (it > 0) {\n'
    '        const int nfar =\n'
    '            far < nk ? next_k_tile<kTile, kKeys>(a, q0, doc_first, far, nk)\n'
    '                     : nk;\n'
    '        if (tid == 0 && nfar < nk)\n'
    '          ntma_pair<D, kKeys>(sQ + L::kRing + L::kStage *\n'
    '                                                  ((it - 1) % kStages),\n'
    '                              &tm_k, &tm_v, &bars[(it - 1) % kStages],\n'
    '                              nfar * kKeys, bkv);\n'
    '        far = nfar;\n'
    '      }\n'
    '\n'
    '      const bool full = tile_full<kTile, kKeys>(a, q0, k0, doc_last);\n'
    '      if (a.softcap != 0.f) {\n'
    '        if (full)\n'
    '          dq_scores<true, false, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,\n'
    '                                        row_a, qlog, qdoc, lane);\n'
    '        else\n'
    '          dq_scores<true, true, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,\n'
    '                                       row_a, qlog, qdoc, lane);\n'
    '      } else {\n'
    '        if (full)\n'
    '          dq_scores<false, false, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,\n'
    '                                         row_a, qlog, qdoc, lane);\n'
    '        else\n'
    '          dq_scores<false, true, kKeys>(a, f, sc, dp, shift, dsc, dsa, k0,\n'
    '                                        row_a, qlog, qdoc, lane);\n'
    '      }\n'
    '\n'
    "      // dQ += dS.K (B MN-major: K = the step's keys), then the next step's\n"
    '      // S = Q.K^T and dP = dO.V^T.\n'
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < kKeys / 16; ++kk)\n'
    '        wgmma_rs_mn<D>(dq, dsa[kk], ndesc_mn<D, kKeys>(sK, kk));\n'
    '      wgmma_commit();\n'
    '      pin_u(dsa);\n'
    '      if (kn < nk) {\n'
    '        const int s1 = (it + 1) % kStages;\n'
    '        const uint32_t sK1 = sQ + L::kRing + L::kStage * s1;\n'
    '        mbar_wait(&bars[s1], ((it + 1) / kStages) & 1);\n'
    '        wgmma_fence();\n'
    '#pragma unroll\n'
    '        for (int kk = 0; kk < D / 16; ++kk)\n'
    '          wgmma_ss<kKeys>(sc, ndesc_k<D>(sQ, kk), ndesc_k<D>(sK1, kk), kk);\n'
    '#pragma unroll\n'
    '        for (int kk = 0; kk < D / 16; ++kk)\n'
    '          wgmma_ss<kKeys>(dp, ndesc_k<D>(sDO, kk),\n'
    '                          ndesc_k<D>(sK1 + L::kTileBytes, kk), kk);\n'
    '        wgmma_commit();\n'
    '      }\n'
    '      kt = kn;\n'
    '    }\n'
    '    wgmma_wait_all();\n'
    '    pin(dq);\n'
    '  }\n')
PIN_U_OLD = (
    '// The shift of a row in log2 units: lse * log2(e), 0 for a row that sees\n'
    '// no key.')
PIN_U_NEW = (
    '// Keeps the compiler from moving or reusing the registers of an A\n'
    '// fragment that a product still reads.\n'
    'template <int N>\n'
    '__device__ __forceinline__ void pin_u(uint32_t (&x)[N][4]) {\n'
    '#pragma unroll\n'
    '  for (int i = 0; i < N; ++i)\n'
    '#pragma unroll\n'
    '    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j]) :: "memory");\n'
    '}\n'
    '\n'
    '// The shift of a row in log2 units: lse * log2(e), 0 for a row that sees\n'
    '// no key.')
DQ_OVERLAP = {PIN_U_OLD: PIN_U_NEW, DQ_OVERLAP_OLD: DQ_OVERLAP_NEW}
# dk/dv with the products of consecutive steps overlapped as dq's: step
# it + 1's S^T and dP^T (and its column stats, double-buffered) issued
# right after step it's dV and dK products (``DKV_OVERLAP``).
DKV_OVERLAP_OLD = (
    '    mbar_wait(&bars[kStages], 0);\n'
    '\n'
    '    for (int it = 0; g < steps; ++it) {\n'
    '      const int s = it % kStages;\n'
    '      const int b = bkv * a.group + g / nq;\n'
    '      const int q0 = (g % nq) * kQRows;\n'
    '      const uint32_t sQ = sK + L::kRing + L::kStage * s;\n'
    '      const uint32_t sDO = sQ + L::kTileBytes;\n'
    "      // Thread tid < kQRows loads column tid's lse and dsum.\n"
    '      float lse_v, dsum_v;\n'
    '      load_stats(a, g, nq, bkv, tid, lse_v, dsum_v);\n'
    '      const int gn = next_q_step<kQRows>(a, k0, bkv, g, nq);\n'
    '      const int nfar =\n'
    '          far < steps ? next_q_step<kQRows>(a, k0, bkv, far, nq) : steps;\n'
    '      mbar_wait(&bars[s], (it / kStages) & 1);\n'
    '\n'
    '      // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns q rows.\n'
    '      float st[kN], dpt[kN];\n'
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < D / 16; ++kk)\n'
    '        wgmma_ss<kQRows>(st, ndesc_k<D>(sK, kk), ndesc_k<D>(sQ, kk), kk);\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < D / 16; ++kk)\n'
    '        wgmma_ss<kQRows>(dpt, ndesc_k<D>(sV, kk), ndesc_k<D>(sDO, kk), kk);\n'
    '      wgmma_commit();\n'
    '      if (tid < kQRows)\n'
    '        stat_w[tid] = make_float2(shift_l2(lse_v), dsum_v * a.scale);\n'
    '      __syncthreads();\n'
    '      wgmma_wait_all();\n'
    '      pin(st);\n'
    '      pin(dpt);\n'
    '\n'
    '      const int* docp =\n'
    '          a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq\n'
    '                   : nullptr;\n'
    '      const bool full = tile_full<kQRows, kTile>(\n'
    '          a, q0, k0, a.packed ? docp[min(q0 + kQRows, a.lq) - 1] : 0);\n'
    '      uint32_t pa[kQRows / 16][4], dsa[kQRows / 16][4];\n'
    '      if (a.softcap != 0.f) {\n'
    '        if (full)\n'
    '          dkv_scores<true, false, kQRows>(a, f, st, dpt, stat, pa, dsa, q0,\n'
    '                                          key_a, docp, lane);\n'
    '        else\n'
    '          dkv_scores<true, true, kQRows>(a, f, st, dpt, stat, pa, dsa, q0,\n'
    '                                         key_a, docp, lane);\n'
    '      } else {\n'
    '        if (full)\n'
    '          dkv_scores<false, false, kQRows>(a, f, st, dpt, stat, pa, dsa, q0,\n'
    '                                           key_a, docp, lane);\n'
    '        else\n'
    '          dkv_scores<false, true, kQRows>(a, f, st, dpt, stat, pa, dsa, q0,\n'
    '                                          key_a, docp, lane);\n'
    '      }\n'
    '\n'
    "      // dV += P^T.dO and dK += dS^T.Q (B MN-major: K = the step's q rows).\n"
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < kQRows / 16; ++kk)\n'
    '        wgmma_rs_mn<D>(dv, pa[kk], ndesc_mn<D, kQRows>(sDO, kk));\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < kQRows / 16; ++kk)\n'
    '        wgmma_rs_mn<D>(dk, dsa[kk], ndesc_mn<D, kQRows>(sQ, kk));\n'
    '      wgmma_commit();\n'
    '      wgmma_wait_all();\n'
    '      pin(dv);\n'
    '      pin(dk);\n'
    '      __syncthreads();               // stage s and the stats are free\n'
    '      if (tid == 0 && nfar < steps)\n'
    '        ntma_pair<D, kQRows>(sQ, &tm_q, &tm_do, &bars[s],\n'
    '                            (nfar % nq) * kQRows, bkv * a.group + nfar / nq);\n'
    '      far = nfar;\n'
    '      g = gn;\n'
    '    }\n'
    '  }\n')
DKV_OVERLAP_NEW = (
    '    mbar_wait(&bars[kStages], 0);\n'
    '\n'
    "    // The products of consecutive steps overlap: step it + 1's S^T and\n"
    "    // dP^T are issued right after step it's dV and dK products, and one\n"
    '    // wait covers them all.  P^T and dS^T stay in their registers until\n'
    '    // that wait; the column stats are double-buffered.\n'
    '    float st[kN], dpt[kN];\n'
    '    uint32_t pa[kQRows / 16][4], dsa[kQRows / 16][4];\n'
    '    {\n'
    '      float lse_v, dsum_v;\n'
    '      load_stats(a, g, nq, bkv, tid, lse_v, dsum_v);\n'
    '      mbar_wait(&bars[0], 0);\n'
    '      const uint32_t sQ = sK + L::kRing;\n'
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < D / 16; ++kk)\n'
    '        wgmma_ss<kQRows>(st, ndesc_k<D>(sK, kk), ndesc_k<D>(sQ, kk), kk);\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < D / 16; ++kk)\n'
    '        wgmma_ss<kQRows>(dpt, ndesc_k<D>(sV, kk),\n'
    '                         ndesc_k<D>(sQ + L::kTileBytes, kk), kk);\n'
    '      wgmma_commit();\n'
    '      if (tid < kQRows)\n'
    '        stat_w[tid] = make_float2(shift_l2(lse_v), dsum_v * a.scale);\n'
    '    }\n'
    '    for (int it = 0; g < steps; ++it) {\n'
    '      const int s = it % kStages;\n'
    '      const int b = bkv * a.group + g / nq;\n'
    '      const int q0 = (g % nq) * kQRows;\n'
    '      const uint32_t sQ = sK + L::kRing + L::kStage * s;\n'
    '      const uint32_t sDO = sQ + L::kTileBytes;\n'
    '      const int gn = next_q_step<kQRows>(a, k0, bkv, g, nq);\n'
    "      wgmma_wait_all();      // step it's S^T, dP^T; step it - 1's dV, dK\n"
    '      pin(st);\n'
    '      pin(dpt);\n'
    '      pin(dv);\n'
    '      pin(dk);\n'
    '      pin_u(pa);\n'
    '      pin_u(dsa);\n'
    "      __syncthreads();       // step it's stats; step it - 1's stage free\n"
    '      if (it > 0) {\n'
    '        const int nfar =\n'
    '            far < steps ? next_q_step<kQRows>(a, k0, bkv, far, nq) : steps;\n'
    '        const int sf = (it - 1) % kStages;\n'
    '        if (tid == 0 && nfar < steps)\n'
    '          ntma_pair<D, kQRows>(sK + L::kRing + L::kStage * sf, &tm_q,\n'
    '                               &tm_do, &bars[sf], (nfar % nq) * kQRows,\n'
    '                               bkv * a.group + nfar / nq);\n'
    '        far = nfar;\n'
    '      }\n'
    '\n'
    '      const int* docp =\n'
    '          a.packed ? a.doc + static_cast<size_t>(b / a.q_mult) * a.lq\n'
    '                   : nullptr;\n'
    '      const bool full = tile_full<kQRows, kTile>(\n'
    '          a, q0, k0, a.packed ? docp[min(q0 + kQRows, a.lq) - 1] : 0);\n'
    '      const float4* cur = stat + (it & 1) * (kQRows / 2);\n'
    '      if (a.softcap != 0.f) {\n'
    '        if (full)\n'
    '          dkv_scores<true, false, kQRows>(a, f, st, dpt, cur, pa, dsa, q0,\n'
    '                                          key_a, docp, lane);\n'
    '        else\n'
    '          dkv_scores<true, true, kQRows>(a, f, st, dpt, cur, pa, dsa, q0,\n'
    '                                         key_a, docp, lane);\n'
    '      } else {\n'
    '        if (full)\n'
    '          dkv_scores<false, false, kQRows>(a, f, st, dpt, cur, pa, dsa, q0,\n'
    '                                           key_a, docp, lane);\n'
    '        else\n'
    '          dkv_scores<false, true, kQRows>(a, f, st, dpt, cur, pa, dsa, q0,\n'
    '                                          key_a, docp, lane);\n'
    '      }\n'
    '\n'
    "      // dV += P^T.dO and dK += dS^T.Q (B MN-major: K = the step's q rows),\n"
    "      // then the next step's S^T and dP^T and its stats.\n"
    '      wgmma_fence();\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < kQRows / 16; ++kk)\n'
    '        wgmma_rs_mn<D>(dv, pa[kk], ndesc_mn<D, kQRows>(sDO, kk));\n'
    '#pragma unroll\n'
    '      for (int kk = 0; kk < kQRows / 16; ++kk)\n'
    '        wgmma_rs_mn<D>(dk, dsa[kk], ndesc_mn<D, kQRows>(sQ, kk));\n'
    '      wgmma_commit();\n'
    '      pin_u(pa);\n'
    '      pin_u(dsa);\n'
    '      if (gn < steps) {\n'
    '        float lse_v, dsum_v;\n'
    '        load_stats(a, gn, nq, bkv, tid, lse_v, dsum_v);\n'
    '        const int s1 = (it + 1) % kStages;\n'
    '        const uint32_t sQ1 = sK + L::kRing + L::kStage * s1;\n'
    '        mbar_wait(&bars[s1], ((it + 1) / kStages) & 1);\n'
    '        wgmma_fence();\n'
    '#pragma unroll\n'
    '        for (int kk = 0; kk < D / 16; ++kk)\n'
    '          wgmma_ss<kQRows>(st, ndesc_k<D>(sK, kk), ndesc_k<D>(sQ1, kk), kk);\n'
    '#pragma unroll\n'
    '        for (int kk = 0; kk < D / 16; ++kk)\n'
    '          wgmma_ss<kQRows>(dpt, ndesc_k<D>(sV, kk),\n'
    '                           ndesc_k<D>(sQ1 + L::kTileBytes, kk), kk);\n'
    '        wgmma_commit();\n'
    '        if (tid < kQRows)\n'
    '          stat_w[((it + 1) & 1) * kQRows + tid] =\n'
    '              make_float2(shift_l2(lse_v), dsum_v * a.scale);\n'
    '      }\n'
    '      g = gn;\n'
    '    }\n'
    '    wgmma_wait_all();\n'
    '    pin(dv);\n'
    '    pin(dk);\n'
    '  }\n')
DKV_OVERLAP = {PIN_U_OLD: PIN_U_NEW, DKV_OVERLAP_OLD: DKV_OVERLAP_NEW,
               "  static constexpr int kBars = kStats + R * 8;":
               "  static constexpr int kBars = kStats + 2 * R * 8;"}
# S^T or S over 128 q rows or keys (one m64n128k16 product, A and B
# K-major from shared memory), for the 128-row variants.
_D128 = ", ".join(f'"+f"(d[{i}])' for i in range(64))
WGMMA_SS_N128 = (
    "\n__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], "
    "uint64_t da,\n    uint64_t db, int scale_d) {\n"
    "  asm volatile(\n"
    '      "{\\n.reg .pred p;\\n"\n'
    '      "setp.ne.b32 p, %66, 0;\\n"\n'
    '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "\n'
    '      "{' + ", ".join(f"%{i}" for i in range(64)) + '}, "\n'
    '      "%64, %65, p, 1, 1, 0, 0;\\n}\\n"\n'
    f"      : {_D128}\n"
    '      : "l"(da), "l"(db), "r"(scale_d));\n}\n')
# The two kernels' launch bounds, for variants with another block count.
DQ_BOUNDS = ("__launch_bounds__(kThreads, kMinBlocks)\n"
             "flash_dq_sm90n_kernel")
DKV_BOUNDS = ("__launch_bounds__(kThreads, kMinBlocks)\n"
              "flash_dkv_sm90n_kernel")
DEFAULT = [
    ["kept", {}],
    # sm90_common.cuh's layout: one 64-column chunk a row with the 128-byte
    # swizzle, zeros past D.
    ["wide_rows", {"narrow": {
                       "  return 2 * D;": "  return 128;",
                       '  static_assert(rb == 64 || rb == 32, "rows of 64 or '
                       '32 bytes");\n  constexpr uint64_t layout = rb == 64 '
                       '? 2 : 3;': "  constexpr uint64_t layout = 1;"},
                   "  const int cols = d;": "  const int cols = 64;",
                   "      d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : "
                   "CU_TENSOR_MAP_SWIZZLE_32B;":
                   "      CU_TENSOR_MAP_SWIZZLE_128B;"}],
    ["q128", {"namespace {\n\nconstexpr int kQRows = 64;":
              f"namespace {{\n{WGMMA_SS_N128}\nconstexpr int kQRows = 128;",
              "wgmma_ss<kQRows>(": "wgmma_ss_n128(",
              DKV_BOUNDS: DKV_BOUNDS.replace("kMinBlocks", "2")}],
    ["k128", {"namespace {\n": f"namespace {{\n{WGMMA_SS_N128}",
              "kKeys = 64;": "kKeys = 128;",
              "wgmma_ss<kKeys>(": "wgmma_ss_n128(",
              DQ_BOUNDS: DQ_BOUNDS.replace("kMinBlocks", "2")}],
    ["blocks3", {"kMinBlocks = 4;": "kMinBlocks = 3;"}],
    ["dq5", {DQ_BOUNDS: DQ_BOUNDS.replace("kMinBlocks", "5")}],
    ["dq6", {DQ_BOUNDS: DQ_BOUNDS.replace("kMinBlocks", "6")}],
    ["dkv5", {DKV_BOUNDS: DKV_BOUNDS.replace("kMinBlocks", "5")}],
    # dk/dv's column stats loaded a step ahead, into two registers a thread
    # that live across the step.
    ["stats_ahead", {
        "    mbar_wait(&bars[kStages], 0);\n\n    for (int it = 0; g < steps;":
        "    float lse_n, dsum_n;\n"
        "    load_stats(a, g, nq, bkv, tid, lse_n, dsum_n);\n"
        "    mbar_wait(&bars[kStages], 0);\n\n    for (int it = 0; g < steps;",
        "      float lse_v, dsum_v;\n"
        "      load_stats(a, g, nq, bkv, tid, lse_v, dsum_v);\n"
        "      const int gn = next_q_step<kQRows>(a, k0, bkv, g, nq);\n":
        "      const float lse_v = lse_n, dsum_v = dsum_n;\n"
        "      const int gn = next_q_step<kQRows>(a, k0, bkv, g, nq);\n"
        "      load_stats(a, gn, nq, bkv, tid, lse_n, dsum_n);\n"}],
    ["stages3", {"kStages = 2;": "kStages = 3;"}],
    ["dq_overlap", DQ_OVERLAP],
    ["dkv_overlap", DKV_OVERLAP],
    ["overlap3", {**DQ_OVERLAP, **DKV_OVERLAP, "kStages = 2;": "kStages = 3;"}],
    ["overlap3_b3", {**DQ_OVERLAP, **DKV_OVERLAP,
                     "kStages = 2;": "kStages = 3;",
                     "kMinBlocks = 4;": "kMinBlocks = 3;"}],
    ["sm90_d32", {"source": "flash_bwd_sm90", **SM90_D32}],
    ["nocheck_no_exp", {"    p = ex2(fmaf(s, f.lin, -shift));":
                        "    p = fmaf(s, f.lin, -shift);"}],
    ["nocheck_no_loads", {
        "      if (tid == 0 && nfar < steps)\n        ntma_pair<D, kQRows>":
        "      if (false)\n        ntma_pair<D, kQRows>",
        "      if (tid == 0 && nfar < nk)\n        ntma_pair<D, kKeys>":
        "      if (false)\n        ntma_pair<D, kKeys>",
        "      mbar_wait(&bars[s], (it / kStages) & 1);":
        "      if (it < kStages) mbar_wait(&bars[s], 0);"}],
]
SHAPE = (cs.BATCH, cs.PROMPT, 16, 8, 32)     # B, L, Hq, Hkv, D


def patched(name: str, path: Path, reps: dict) -> str:
    """``path``'s text with the textual replacements ``reps``."""
    text = path.read_text()
    for old, new in reps.items():
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {path.name}")
        text = text.replace(old, new)
    return text


def build_variant(name: str, reps: dict, csrc: Path = build.CSRC):
    """The variant's source built into ``build/ab_narrow/<name>/``, with
    ``csrc``'s headers beside it (``sm90_common.cuh`` patched by the
    replacements under ``"common"``, ``sm90_narrow.cuh`` by those under
    ``"narrow"``), so the includes find them first; returns (name, library
    path, ptxas log)."""
    reps = dict(reps)
    source = reps.pop("source", SOURCE)
    headers = {"sm90_common.cuh": reps.pop("common", {}),
               "sm90_narrow.cuh": reps.pop("narrow", {})}
    out = build.BUILD_DIR.parent / "ab_narrow" / name
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(
            patched(name, header, headers.get(header.name, {})))
    cu, so = out / f"{source}.cu", out / f"{source}.so"
    cu.write_text(patched(name, csrc / f"{source}.cu", reps))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                           *RENAME.get(source, []), "-I", str(csrc), "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, so, proc.stdout + proc.stderr


def use(path) -> None:
    """Route the sm90n wrappers to the library at ``path``."""
    fa._bwd_sm90n_lib.cache_clear()
    build._LOADED[SOURCE] = ctypes.CDLL(str(path))


def operands():
    """qwen3-1.7b's training shape at D = 32: the unfolded bf16 q, k, v,
    do and the folded call's arguments from the plain forward."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, hq, hkv, d = SHAPE
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, l, hq, d), (b, l, hkv, d),
                                 (b, l, hkv, d), (b, l, hq, d)))
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, causal=True)
    dof = _fold_pad(do, qf.shape[2])
    out, lse = fa._fwd_plain(qf, kf, vf, p, band=band, doc=doc)
    dsum = (dof.float() * out.float()).sum(dim=-1)
    return (q, k, v, do), (qf, kf, vf, dof, lse, dsum, p, band, doc)


def check_variant(name: str, path) -> None:
    """Every bf16 case of phase 3 at padded D 16 / 32, the timing shape
    among them; raises on a disagreement."""
    use(path)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case, q, k, v, do, kw in cs.bwd_cases(gen):
        if q.dtype == torch.bfloat16 and _d_pad(q.shape[3]) in (16, 32):
            cs.check_bwd(f"{name}:{case}", q, k, v, do, kw)


def sdpa_bwd_ms(q, k, v, do) -> tuple[list, list]:
    """SDPA's backward alone on the unfolded operands (``enable_gqa``):
    (one call a timing, back to back)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    def grad():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    return cs.cuda_times(grad, reps=21, warmup=3), cs.cuda_loop_times(grad)


# ---------------------------------------------------------------------------
# The forward (``--fwd``): csrc/flash_fwd_sm90_narrow.cu's variants, and
# csrc/flash_fwd_sm90_d384.cu's for scripts/ab_wide_sm90.py ``--d384``
# ---------------------------------------------------------------------------

# S over 128 keys (one m64n128k16 product, A = Q from registers, B = K
# K-major from shared memory), for ``fwd_k128``.
WGMMA_RS_N128_KMAJOR = (
    "\n__device__ __forceinline__ void wgmma_rs_n128_kmajor(float (&d)[64], "
    "const uint32_t (&a)[4],\n    uint64_t db, int scale_d) {\n"
    "  asm volatile(\n"
    '      "{\\n.reg .pred p;\\n"\n'
    '      "setp.ne.b32 p, %69, 0;\\n"\n'
    '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "\n'
    '      "{' + ", ".join(f"%{i}" for i in range(64)) + '}, "\n'
    '      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\\n}\\n"\n'
    f"      : {_D128}\n"
    '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), '
    '"r"(scale_d));\n}\n')
# 2^x on the FMA pipe: x rounded to an integer n by adding 1.5 * 2^23, a
# degree-5 polynomial (Taylor's) for 2^(x - n) on |x - n| <= 1/2 (relative
# error about 2.4e-6), n added to the exponent; 0 below -126, as
# ex2.approx.ftz gives.  ``fwd_poly`` computes every second exponential of
# the softmax with it (FlashAttention-4's way round the special-function
# unit).
EX2_POLY = (
    "// 2^x on the FMA pipe, for fwd_poly.\n"
    "__device__ __forceinline__ float ex2_poly(float x) {\n"
    "  const float xc = fmaxf(x, -127.f);\n"
    "  const float t = xc + 12582912.f;\n"
    "  const float f = xc - (t - 12582912.f);\n"
    "  float p = fmaf(f, 1.3333558e-3f, 9.6181291e-3f);\n"
    "  p = fmaf(p, f, 5.5504109e-2f);\n"
    "  p = fmaf(p, f, 2.4022651e-1f);\n"
    "  p = fmaf(p, f, 6.9314718e-1f);\n"
    "  p = fmaf(p, f, 1.f);\n"
    "  const float r =\n"
    "      __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));\n"
    "  return x < -126.f ? 0.f : r;\n"
    "}\n\n")
P0_EX2 = ("      const float p0 = ex2(fmaf(sc[4 * j + 2 * half], g, "
          "-shift[half]));\n")
P1_EX2 = ("      const float p1 = ex2(fmaf(sc[4 * j + 2 * half + 1], g, "
          "-shift[half]));\n")
SOFTMAX_EX2 = "template <bool kCap, bool kMask, int NJ, class A>\n"
FWD = "flash_fwd_sm90_narrow"
FWD_BOUNDS = "kMinBlocks = 5;"
K128 = {"namespace {\n\nconstexpr int kKeys = 64;":
        f"namespace {{\n{WGMMA_RS_N128_KMAJOR}\nconstexpr int kKeys = 128;",
        "wgmma_rs_n64_kmajor(": "wgmma_rs_n128_kmajor(",
        FWD_BOUNDS: "kMinBlocks = 3;"}
DEFAULT_FWD = [
    ["fwd_kept", {"source": FWD}],
    ["fwd_k128", {"source": FWD, **K128}],
    ["fwd_k128_stages3", {"source": FWD, **K128, "kStages = 2;": "kStages = 3;"}],
    ["fwd_blocks3", {"source": FWD, FWD_BOUNDS: "kMinBlocks = 3;"}],
    ["fwd_blocks4", {"source": FWD, FWD_BOUNDS: "kMinBlocks = 4;"}],
    ["fwd_blocks6", {"source": FWD, FWD_BOUNDS: "kMinBlocks = 6;"}],
    ["fwd_stages3", {"source": FWD, "kStages = 2;": "kStages = 3;"}],
    ["fwd_stages4", {"source": FWD, "kStages = 2;": "kStages = 4;"}],
    ["fwd_poly", {"source": FWD, "common": {
        SOFTMAX_EX2: EX2_POLY + SOFTMAX_EX2,
        P1_EX2: P1_EX2.replace("= ex2(", "= ex2_poly(")}}],
    ["fwd_nocheck_no_exp", {"source": FWD, "common": {
        P0_EX2: P0_EX2.replace("= ex2(", "= ("),
        P1_EX2: P1_EX2.replace("= ex2(", "= (")}}],
]


def fwd_targets() -> dict:
    """target -> what a forward A/B run needs: the source, the library name
    the wrapper loads and its cached accessor, the padded head dims of
    phase 2's bf16 cases that check a variant, the route, the timing shape
    (B, L, Hq, Hkv, D; causal), its softcaps and the parent's source."""
    return {
        "narrow": dict(source=FWD, accessor=fa._fwd_sm90n_lib, pads=(16, 32),
                       route="sm90n", shape=SHAPE, caps=(0.0,),
                       parent="flash_fwd"),
        "d384": dict(source="flash_fwd_sm90_d384",
                     accessor=fa._fwd_sm90w384_lib, pads=(384,),
                     route="sm90w",
                     shape=(cs.BATCH, cs.PROMPT, cs.GEMMA_HQ, cs.GEMMA_HKV,
                            320), caps=(cs.GEMMA_CAP, 0.0),
                     parent="flash_fwd_wide")}


def use_fwd(target: str, path) -> None:
    """Route the target's forward wrapper to the library at ``path``."""
    tg = fwd_targets()[target]
    tg["accessor"].cache_clear()
    build._LOADED[tg["source"]] = ctypes.CDLL(str(path))


def check_fwd_variant(target: str, name: str, path) -> None:
    """Every bf16 case of phase 2 at the target's padded head dims, the
    timing shapes among them; raises on a disagreement."""
    use_fwd(target, path)
    pads = fwd_targets()[target]["pads"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case, q, k, v, kw in cs.kernel_cases(gen):
        if q.dtype == torch.bfloat16 and _d_pad(q.shape[3]) in pads:
            cs.check_kernel(f"{name}:{case}", q, k, v, kw)


def fwd_ab(target: str, spec: list, parent: Path | None) -> int:
    """Build, check and time the target's forward variants ``spec`` (and,
    with ``parent``, the parent tree's FMA forward under the target's entry
    names) as ``main`` does the backward's: each checked in a child
    process, those that pass timed in turns at the target's shape, one call
    a timing (21 after 3 warm-ups) and back to back (5 x 20), at each
    softcap, beside SDPA's forward on the same inputs (``enable_gqa`` at
    D 32; at head dim 320 the backend that runs there, on repeated K/V,
    without the softcap)."""
    from torch.nn.attention import sdpa_kernel

    tg = fwd_targets()[target]
    jobs = [(name, reps, build.CSRC) for name, reps in spec]
    if parent:
        jobs.append((f"{target}_parent_fma", {"source": tg["parent"]},
                     parent.resolve()))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build_variant(*job), jobs))
    passed = {}
    for name, path, log in built:
        print(f"{name}: ptxas {cs.ptxas_summary(log)}", flush=True)
        if "nocheck_" in name:
            print(f"{name}: not checked (a diagnostic)")
            passed[name] = path
            continue
        proc = subprocess.run([sys.executable, __file__, "--check-fwd",
                               target, name, str(path)],
                              capture_output=True, text=True, timeout=600)
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
    b, l, hq, hkv, d = tg["shape"]
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, l, hq, d), (b, l, hkv, d), (b, l, hkv, d)))
    qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, causal=True)
    names = list(passed)
    # name -> (way, softcap) -> milliseconds
    times = {name: {(way, cap): [] for way in ("call", "loop")
                    for cap in tg["caps"]} for name in names}
    for name in [*names, *reversed(names)]:
        use_fwd(target, passed[name])
        n0 = cs.launch_counts()
        for cap in tg["caps"]:
            pc = p._replace(softcap=cap)

            def call():
                return fa._fwd(qf, kf, vf, pc, band=band, doc=doc)

            times[name]["call", cap] += cs.cuda_times(call, reps=21,
                                                      warmup=3)
            times[name]["loop", cap] += cs.cuda_loop_times(call)
        moved = cs.launches_since(n0)[f"fwd_{tg['route']}"]
        if moved != 127 * len(tg["caps"]):
            print(f"{name}: the timing left the {tg['route']} route "
                  f"({moved} launches on it)")
            return 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if target == "narrow":
        def lib_call():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        backend, how = None, "enable_gqa"
    else:
        kt, vt = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))
        backend = cs.sdpa_backend(*(x.clone().requires_grad_()
                                    for x in (qt, kt, vt)))
        how = f"{backend.name}, repeated kv, no softcap"

        def lib_call():
            with sdpa_kernel([backend]):
                return sdpa(qt, kt, vt, is_causal=True)
    lib = {"call": cs.cuda_times(lib_call, reps=21, warmup=3),
           "loop": cs.cuda_loop_times(lib_call)}
    bound, _, flops = cs.fwd_bound(q, k, torch.bfloat16)
    floor = cs.exp2_floor_ms(q)
    for name in names:
        for (way, cap), ts in times[name].items():
            med = statistics.median(ts)
            quart = statistics.quantiles(ts, n=4)
            print(f"{name} softcap {cap:g} ({way}): median {med:.4f} ms over "
                  f"{len(ts)} ({flops / med / 1e9:.1f} TFLOP/s, "
                  f"{100 * bound / med:.2f}% of the {bound:.4f} ms bound, "
                  f"{100 * floor / med:.2f}% of the {floor:.4f} ms exp2 "
                  f"floor), quartiles {quart[0]:.4f}-{quart[2]:.4f} ms, "
                  f"min {min(ts):.4f}")
    for way, ts in lib.items():
        print(f"sdpa forward ({how}, {way}): median "
              f"{statistics.median(ts):.4f} ms over {len(ts)}, min "
              f"{min(ts):.4f}, max {max(ts):.4f}")
    return 0


# The sources of another tree that include sm90_common.cuh, against which
# this tree's are compared: every bf16 source.  The fp32 sources include
# it through tf32x3.cuh, whose interface may differ between the trees:
# ``scripts/ab_flash_bwd_tf32x3.py --header-from`` compares them, each
# tree's source with that tree's headers.
HEADER_USERS = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_fwd_sm90_wide",
                "flash_dq_sm90_wide", "flash_dkv_sm90_wide",
                "flash_fwd_sm90_d384", "flash_bwd_sm90_d384",
                "flash_fwd_sm90_narrow", "flash_bwd_sm90_narrow")


def header_check(other: Path) -> int:
    """Each of ``HEADER_USERS`` built from this tree (source and headers)
    and from ``other`` (its source against its ``sm90_common.cuh``); 0 if
    every pair has the same SASS and registers."""
    import ab_flash_bwd_tf32x3
    import ab_flash_fwd

    jobs = [(f"hdr_{tag}_{src}", source, header) for src in HEADER_USERS
            for tag, source, header in (
                ("this", build.CSRC / f"{src}.cu", None),
                ("other", other / f"{src}.cu", other / "sm90_common.cuh"))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip((name for name, _, _ in jobs), pool.map(
            lambda job: ab_flash_fwd.build_variant(
                job[0], {}, source=job[1], header=job[2]), jobs)))
    same = True
    for src in HEADER_USERS:
        (_, so_a, log_a), (_, so_b, log_b) = (built[f"hdr_{tag}_{src}"]
                                              for tag in ("this", "other"))
        sass_a = ab_flash_bwd_tf32x3.sass_of(so_a)
        sass_b = ab_flash_bwd_tf32x3.sass_of(so_b)
        diff = sum(a != b for a, b in zip(sass_a, sass_b)) \
            + abs(len(sass_a) - len(sass_b))
        regs_a, regs_b = cs.ptxas_summary(log_a), cs.ptxas_summary(log_b)
        same = same and diff == 0 and regs_a == regs_b
        print(f"{src}: SASS {len(sass_a)} / {len(sass_b)} lines, {diff} "
              f"different; registers {'the same' if regs_a == regs_b else 'DIFFERENT'}: "
              f"{[(name, regs, spills) for name, regs, spills in regs_a]}",
              flush=True)
    return 0 if same else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_narrow_sm90: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--check"]:        # a child: one variant's check
        check_variant(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--check-fwd"]:    # a child: a forward variant's
        check_fwd_variant(*sys.argv[2:5])
        return 0
    if sys.argv[1:2] == ["--header-from"]:
        print(cs.smi_line(), flush=True)
        return header_check(Path(sys.argv[2]).resolve())
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--fwd", action="store_true")
    ap.add_argument("spec", nargs="*")
    args = ap.parse_args()
    if args.fwd:
        named = dict((name, reps) for name, reps in DEFAULT_FWD)
        spec = [[v, named[v]] for v in args.spec] or DEFAULT_FWD
        print(cs.smi_line(), flush=True)
        return fwd_ab("narrow", spec, args.parent)
    named = dict((name, reps) for name, reps in DEFAULT)
    if len(args.spec) == 1 and args.spec[0].endswith(".json"):
        spec = json.loads(Path(args.spec[0]).read_text())
    else:
        spec = args.spec or [name for name, _ in DEFAULT]
    spec = [[v, named[v]] if isinstance(v, str) else v for v in spec]
    print(cs.smi_line(), flush=True)
    jobs = [(name, reps, build.CSRC) for name, reps in spec]
    if args.parent:
        jobs.append(("parent_fma", {"source": "flash_bwd"},
                     args.parent.resolve()))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build_variant(*job), jobs))
    passed = {}
    for name, path, log in built:
        print(f"{name}: ptxas {cs.ptxas_summary(log)}", flush=True)
        for line in log.splitlines():
            if "wgmma" in line and "serialized" in line:
                print(f"    {line.strip()}")
        if name.startswith("nocheck_"):
            print(f"{name}: not checked (a diagnostic)")
            passed[name] = path
            continue
        proc = subprocess.run([sys.executable, __file__, "--check", name,
                               str(path)], capture_output=True, text=True,
                              timeout=600)
        cases = proc.stdout.count(" ok\n")
        if proc.returncode == 0:
            print(f"{name}: {cases} cases within tolerance", flush=True)
            passed[name] = path
        else:
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-8:]
            print(f"{name}: FAILED after {cases} cases:\n    "
                  + "\n    ".join(tail), flush=True)
    if "kept" not in passed and any(name == "kept" for name, _ in spec):
        return 1

    (q, k, v, do), (qf, kf, vf, dof, lse, dsum, p, band, doc) = operands()
    names = list(passed)
    calls = {"dq": lambda: fa._dq_cuda(qf, kf, vf, dof, lse, dsum, p, band,
                                       doc),
             "dkv": lambda: fa._dkv_cuda(qf, kf, vf, dof, lse, dsum, p,
                                         band, doc)}
    # name -> (way, kernel) -> milliseconds
    times = {name: {(way, key): [] for way in ("call", "loop")
                    for key in calls} for name in names}
    for name in [*names, *reversed(names)]:
        use(passed[name])
        n0 = cs.launch_counts()
        for key, fn in calls.items():
            times[name]["call", key] += cs.cuda_times(fn, reps=21, warmup=3)
            times[name]["loop", key] += cs.cuda_loop_times(fn)
        moved = cs.launches_since(n0)
        if (moved["dq_sm90n"], moved["dkv_sm90n"]) != (127, 127):
            print(f"{name}: the timing left the sm90n route: {moved}")
            return 1
    lib = dict(zip(("call", "loop"), sdpa_bwd_ms(q, k, v, do)))
    bounds = {"dq": cs.bwd_bound(q, k, 3, torch.bfloat16),
              "dkv": cs.bwd_bound(q, k, 4, torch.bfloat16)}
    for name in names:
        for (way, key), ts in times[name].items():
            med = statistics.median(ts)
            bound, _, flops = bounds[key]
            quart = statistics.quantiles(ts, n=4)
            print(f"{name} {key} ({way}): median {med:.4f} ms over "
                  f"{len(ts)} ({flops / med / 1e9:.1f} TFLOP/s, "
                  f"{100 * bound / med:.2f}% of the {bound:.4f} ms bound), "
                  f"quartiles {quart[0]:.4f}-{quart[2]:.4f} ms, "
                  f"min {min(ts):.4f}")
        for way in ("call", "loop"):
            pair = sum(statistics.median(times[name][way, key])
                       for key in calls)
            print(f"{name} pair ({way}): {pair:.4f} ms")
    for way, ts in lib.items():
        print(f"sdpa backward (enable_gqa, {way}): median "
              f"{statistics.median(ts):.4f} ms over {len(ts)}, min "
              f"{min(ts):.4f}, max {max(ts):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
