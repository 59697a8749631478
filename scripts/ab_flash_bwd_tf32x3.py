"""Compare variants of the fp32 3xTF32 backward kernels on one card, in one
process.

    python3 scripts/ab_flash_bwd_tf32x3.py [spec.json]
    python3 scripts/ab_flash_bwd_tf32x3.py --header-from OTHER_CSRC_DIR
    python3 scripts/ab_flash_bwd_tf32x3.py --wide [--parent OTHER_CSRC_DIR] [NAME ...]

Each variant is ``src/repro_torch/kernels/csrc/flash_bwd_tf32x3.cu`` with
textual replacements (``[[name, {old: new}], ...]`` in ``spec.json``).  By
default the kept kernels run against six design choices undone:

- hi rounded by ``cvt.rna.tf32.f32`` instead of two integer instructions,
- or by three fp32 instructions (Veltkamp's split, on the fp32 pipe),
- lo rounded to nearest instead of truncated,
- the products summed straight into the long-lived accumulators instead
  of a partial sum a tile added in fp32,
- the dq block's keys split two ways (256 threads) instead of four (512),
- dk/dv's partial sums over two k steps instead of four.

(The split and the products live in ``csrc/tf32x3.cuh``; a patch of
``"header"`` entries, ``{old: new}``, edits a copy of it beside the
variant's source.)

With ``--header-from``, every source that includes ``tf32x3.cuh`` (the
two fp32 backward and the two fp32 forward sources) is built beside
OTHER_CSRC_DIR's copy built with that tree's headers (for example the
parent commit's, unpacked with ``git archive``), and the script says
whether the two builds' SASS (``cuobjdump -sass``) is the same (a source
the other tree lacks is skipped).  Then both tf32x3 backward builds are
checked and timed as variants.

Each is built with the repository's nvcc flags into ``build/ab/<name>/``
and held against the plain version on every fp32 backward case of
``chip_smoke.py`` phase 3 up to D 128 (same tolerances; a variant that
misses one is reported, not dropped).  Then its dq and dk/dv kernels are
timed at B=2, L=4096, Hq=16, Hkv=8, D=128, causal, fp32 in turns (A B C ..
C B A; 21 CUDA-event timings each pass, after 3 warm-ups).

With ``--wide``, the same for ``csrc/flash_bwd_tf32x3_wide.cu`` (the
``tf32x3w`` route, fp32 above D 128): the kept pair and two diagnostics
(``DEFAULT_WIDE``: no wait for the staged loads, no stage loaded after
the first), or the variants NAMEd, also those of ``MEASURED_WIDE``, the
designs measured and not kept: ``one_chain`` (the first products
in one partial sum instead of two interleaved ones), ``no_k_sums`` (the
first products summed straight over all D columns in one accumulator, as
the D <= 128 kernels sum their 16 k steps), ``stages16`` (16-row stages
at every width, as at D 384), ``unroll2`` / ``unroll4`` (the first
products' k loop unrolled 2 / 4 times at every width instead of 4 at D 384
and 2 below), ``div_softcap`` (s / cap and s_c / cap by IEEE division, as
the retired ``p_ds`` formed them), ``lds64`` (the first products'
fragments as 8-byte pairs), ``bulk_loads`` (one ``cp.async.bulk`` a row
on an mbarrier, issued by one warp, instead of ``cp.async`` by every
thread), ``imad_hi`` (the split's rounding add on the FMA pipe), and two
more diagnostics
(no first products, no second products).  Diagnostics are named
``nocheck_...``: wrong by design, they are timed unchecked.  With
``--parent``, OTHER_CSRC_DIR's ``flash_bwd_tf32x3_wide.cu`` or, where it
has none, its ``flash_bwd_wide.cu`` (the fp32 FMA pair the route
replaced) under the new entry names.  Each is
checked in a child process on every fp32 case of phase 3 above D 128 (so
a fault stays contained), then timed at gemma2-2b's shape (B=2, L=4096,
Hq=8, Hkv=4, causal) at D 288 and at head dim 320 (padded 384), softcap
50 and 0, in turns, one call at a time (21 timings after 3 warm-ups) and
back to back (5 x 20 calls), beside SDPA's backward on the same inputs
(repeated K/V, the backend that runs there, no softcap), both ways.
ptxas's registers and spills for every instantiation, and any line of it
about ``mma`` or a warning, are printed.  About 5 minutes for four
variants.

Prints the card's name and power limit first; exits non-zero if a
variant fails to build or the first (kept) one disagrees with the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ops import _fold_chunk_args, _fold_pad  # noqa: E402

SOURCE = "flash_bwd_tf32x3"
WIDE = "flash_bwd_tf32x3_wide"
HEADER = "tf32x3.cuh"
# The sources ``--header-from`` compares: every one that includes HEADER.
SASS_SOURCES = (SOURCE, WIDE, "flash_fwd_tf32x3", "flash_fwd_tf32x3_wide")
DEFAULT = [
    ["kept", {}],
    ["cvt_rna", {"header": {
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;":
        '  uint32_t r;\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
        '  return r;'}}],
    ["hi_on_fp32_pipe", {"header": {
        "  hi = tf32_rna(x);\n":
        "  const float big = __fmul_rn(x, 8193.f);\n"
        "  hi = __float_as_uint(__fadd_rn(__fsub_rn(x, big), big));\n"}}],
    ["lo_rna", {"header": {
        "  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;":
        "  lo = tf32_rna(x - __uint_as_float(hi));"}}],
    ["no_tile_sums", {"header": {"mma3(part, a[n],": "mma3(out[c], a[n],",
                                 "    add_to(out[c], part);\n": ""}}],
    ["dq_keys_2way", {"constexpr int kDqKeySplit = 4;":
                      "constexpr int kDqKeySplit = 2;"}],
    ["dkv_sums_2steps", {"constexpr int kDkvSumSteps = 4;":
                         "constexpr int kDkvSumSteps = 2;"}],
]
# The wide pair's variants (``--wide``).
# (``first_product`` and ``load_rows`` live in ``tf32x3.cuh``: their
# patches go under ``"header"``.)
ONE_CHAIN = {"          mma3(part[e][n], fa, sb[off], sb[off + 4]);":
             "          mma3(part[0][n], fa, sb[off], sb[off + 4]);"}
# The first products' fragments as 8-byte pairs: in each k step's 8
# columns logical k = t is physical column 2t and t + 4 is 2t + 1 (for A
# and B alike), instead of ``load_a``'s 4-byte loads of t and t + 4.
LDS64 = {
    r"""        const FragA fa = load_a<S>(sa, ra + g, 8 * (ks + e) + t);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int off = (rb + 8 * n + g) * S + 8 * (ks + e) + t;
          mma3(part[e][n], fa, sb[off], sb[off + 4]);
        }""":
    r"""        const int col = 8 * (ks + e) + 2 * t;
        const float2 a0 =
            *reinterpret_cast<const float2*>(sa + (ra + g) * S + col);
        const float2 a1 =
            *reinterpret_cast<const float2*>(sa + (ra + g + 8) * S + col);
        const FragA fa = split_a(a0.x, a1.x, a0.y, a1.y);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const float2 b = *reinterpret_cast<const float2*>(
              sb + (rb + 8 * n + g) * S + col);
          mma3(part[e][n], fa, b.x, b.y);
        }""",
}
# The stages' and fixed tiles' loads as one bulk copy a row
# (``cp.async.bulk`` on an mbarrier, by warp 0; rows past the end copy
# the last row) instead of ``cp.async`` by every thread.
BULK_LOADS = {
    r"""// ---------------------------------------------------------------------------
// dq
""":
    r"""// Rows row0 .. row0 + R - 1 by warp 0, one bulk copy a row, completing
// on ``bar``.
template <int D, int R>
__device__ __forceinline__ void bulk_rows(float* dst, const float* src,
                                          int row0, int rows, uint64_t* bar,
                                          int lane) {
  for (int r = lane; r < R; r += 32) {
    const int row = min(row0 + r, rows - 1);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst + r * (D + 4))),
           "l"(src + static_cast<size_t>(row) * D), "r"(D * 4),
           "r"(smem_u32(bar))
        : "memory");
  }
}

// The three mbarriers of a block (the two stages', then the fixed tiles'),
// kept in the padding of the first fixed tile's first rows (16 bytes a row
// past column D, which no load writes and no fragment reads).
template <int D>
__device__ __forceinline__ uint64_t* bar_of(float* fixed, int i) {
  return reinterpret_cast<uint64_t*>(fixed + i * (D + 4) + D);
}

// Thread 0 initialises the block's three mbarriers (one arrival each).
template <int D>
__device__ __forceinline__ void init_bars(float* fixed, int tid) {
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(bar_of<D>(fixed, i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Two R-row tiles, ``s0``'s rows at dst and ``s1``'s after it (R * (D + 4)
// floats on), by warp 0, completing on ``bar``.
template <int D, int R>
__device__ __forceinline__ void load_pair(float* dst, const float* s0,
                                          const float* s1, int row0,
                                          int rows, uint64_t* bar,
                                          int lane) {
  if (lane == 0) mbar_expect_tx(bar, 2 * R * D * 4);
  __syncwarp();
  bulk_rows<D, R>(dst, s0, row0, rows, bar, lane);
  bulk_rows<D, R>(dst + R * (D + 4), s1, row0, rows, bar, lane);
}

// ---------------------------------------------------------------------------
// dq
""",
    r"""    const size_t qbase = static_cast<size_t>(b) * a.lq * D;
    load_rows<D, kRows, kBlockW>(sQ, a.q + qbase, q0, a.lq, tid);
    load_rows<D, kRows, kBlockW>(sDO, a.dout + qbase, q0, a.lq, tid);
    load_rows<D, KT, kBlockW>(ring, kp, kt * KT, a.lk, tid);
    load_rows<D, KT, kBlockW>(ring + W::kStage, vp, kt * KT, a.lk, tid);
    cp_async_commit();
""":
    r"""    init_bars<D>(sQ, tid);
    if (warp == 0) {
      const size_t qbase = static_cast<size_t>(b) * a.lq * D;
      load_pair<D, kRows>(sQ, a.q + qbase, a.dout + qbase, q0, a.lq,
                          bar_of<D>(sQ, 2), lane);
      load_pair<D, KT>(ring, kp, vp, kt * KT, a.lk, bar_of<D>(sQ, 0), lane);
    }
""",
    r"""
    for (int it = 0; kt < nk; ++it) {
      cp_async_wait<0>();
      __syncthreads();        // tile kt has landed; step it - 1 is done
""":
    r"""
    mbar_wait(bar_of<D>(sQ, 2), 0);
    for (int it = 0; kt < nk; ++it) {
      mbar_wait(bar_of<D>(sQ, it & 1), (it >> 1) & 1);   // tile kt landed
      __syncthreads();        // step it - 1 is done: the other stage is free
""",
    r"""      if (kn < nk) {
        float* next = ring + 2 * ((it + 1) & 1) * W::kStage;
        load_rows<D, KT, kBlockW>(next, kp, kn * KT, a.lk, tid);
        load_rows<D, KT, kBlockW>(next + W::kStage, vp, kn * KT, a.lk, tid);
      }
      cp_async_commit();
""":
    r"""      if (warp == 0 && kn < nk)
        load_pair<D, KT>(ring + 2 * ((it + 1) & 1) * W::kStage, kp, vp,
                         kn * KT, a.lk, bar_of<D>(sQ, (it + 1) & 1), lane);
""",
    r"""    }
  }
  cp_async_wait<0>();

  float* dqp = a.dq + static_cast<size_t>(b) * a.lq * D + (D / 4) * cw;
""":
    r"""    }
  }

  float* dqp = a.dq + static_cast<size_t>(b) * a.lq * D + (D / 4) * cw;
""",
    r"""    const size_t kbase = static_cast<size_t>(bkv) * a.lk * D;
    load_rows<D, kRows, kBlockW>(sK, a.k + kbase, k0, a.lk, tid);
    load_rows<D, kRows, kBlockW>(sV, a.v + kbase, k0, a.lk, tid);
    {
""":
    r"""    init_bars<D>(sK, tid);
    if (warp == 0) {
      const size_t kbase = static_cast<size_t>(bkv) * a.lk * D;
""",
    r"""      load_rows<D, QR, kBlockW>(ring, a.q + base, (gs % nq) * QR, a.lq,
                                tid);
      load_rows<D, QR, kBlockW>(ring + W::kStage, a.dout + base,
                                (gs % nq) * QR, a.lq, tid);
    }
    cp_async_commit();
    int gn = next_q_step<QR, kRows>(a, k0, bkv, gs, nq);
""":
    r"""      load_pair<D, kRows>(sK, a.k + kbase, a.v + kbase, k0, a.lk,
                          bar_of<D>(sK, 2), lane);
      load_pair<D, QR>(ring, a.q + base, a.dout + base, (gs % nq) * QR,
                       a.lq, bar_of<D>(sK, 0), lane);
    }
    int gn = next_q_step<QR, kRows>(a, k0, bkv, gs, nq);
    mbar_wait(bar_of<D>(sK, 2), 0);
""",
    r"""      cp_async_wait<0>();
      __syncthreads();        // step gs has landed; step it - 1 is done
""":
    r"""      mbar_wait(bar_of<D>(sK, it & 1), (it >> 1) & 1);   // step gs landed
      __syncthreads();        // step it - 1 is done: the other stage is free
""",
    r"""      if (gn < steps) {
        float* next = ring + 2 * ((it + 1) & 1) * W::kStage;
""":
    r"""      if (warp == 0 && gn < steps) {
""",
    r"""        load_rows<D, QR, kBlockW>(next, a.q + base, (gn % nq) * QR, a.lq,
                                  tid);
        load_rows<D, QR, kBlockW>(next + W::kStage, a.dout + base,
                                  (gn % nq) * QR, a.lq, tid);
      }
      cp_async_commit();

""":
    r"""        load_pair<D, QR>(ring + 2 * ((it + 1) & 1) * W::kStage, a.q + base,
                         a.dout + base, (gn % nq) * QR, a.lq,
                         bar_of<D>(sK, (it + 1) & 1), lane);
      }

""",
    r"""    }
  }
  cp_async_wait<0>();

  float* out = (kind ? a.dk : a.dv) + static_cast<size_t>(bkv) * a.lk * D +
""":
    r"""    }
  }

  float* out = (kind ? a.dk : a.dv) + static_cast<size_t>(bkv) * a.lk * D +
""",
}
# Designs measured against the kept pair and not kept, and two
# diagnostics: PERF.md section 6 gives their times.  They run only
# when NAMEd.
MEASURED_WIDE = [
    ["wide_one_chain", {"header": ONE_CHAIN}],
    ["wide_no_k_sums", {"header": {**ONE_CHAIN, "constexpr int kSumK = 16;":
                                   "constexpr int kSumK = 48;"}}],
    ["wide_stages16", {
        "  static constexpr int kR = D == 384 ? 16 : 32;":
        "  static constexpr int kR = 16;"}],
    ["wide_unroll2", {"header": {"#pragma unroll(NN == 1 ? 4 : 2)":
                                 "#pragma unroll 2"}}],
    ["wide_unroll4", {"header": {"#pragma unroll(NN == 1 ? 4 : 2)":
                                 "#pragma unroll 4"}}],
    # P and F as the retired ``p_ds`` formed them: s / cap and s_c / cap by
    # IEEE division.
    ["wide_div_softcap", {"header": {
        "  t = a.softcap != 0.f ? tanhf(s * inv_cap) : 0.f;\n"
        "  return a.softcap != 0.f ? a.softcap * t : s;\n":
        "  if (a.softcap == 0.f) {\n    t = 0.f;\n    return s;\n  }\n"
        "  const float sc = a.softcap * tanhf(s / a.softcap);\n"
        "  t = sc / a.softcap;\n  return sc;\n"}}],
    ["wide_lds64", {"header": LDS64}],
    ["wide_bulk_loads", BULK_LOADS],
    # hi's rounding add as an integer multiply-add (the FMA pipe) instead
    # of an add on the ALU pipe: the multiplier is 1, from %laneid / 32 + 1
    # so that the compiler cannot fold it.
    ["wide_imad_hi", {"header": {
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;":
        "  uint32_t one;\n"
        "  asm(\"{ .reg .u32 l; mov.u32 l, %%laneid; shr.u32 l, l, 5; "
        "add.u32 %0, l, 1; }\" : \"=r\"(one));\n"
        "  return (__float_as_uint(x) * one + 0x1000u) & 0xffffe000u;"}}],
    # Diagnostics, wrong by design and timed unchecked: no first products
    # (S and dP, or S^T and dP^T, taken as 0), so the time is the kernels'
    # without them; no second products (the exchange still read).
    ["wide_nocheck_no_first", {"header": {
        "  for (int c0 = 0; c0 < KS; c0 += kSumK) {":
        "  for (int c0 = 0; c0 < 0; c0 += kSumK) {"}}],
    ["wide_nocheck_no_second", {
        "      tile_product<NB, S, NJ>(dq, dsa, sK + 2 * t * S + (D / 4) * cw + g);":
        "      dq[0][0] += __uint_as_float(dsa[NJ - 1].hi[0]);",
        "      tile_product<NB, S, NJ>(acc, fa,\n"
        "                              (kind ? sQ : sDO) + 2 * t * S + (D / 2) * qh + g);":
        "      acc[0][0] += __uint_as_float(fa[NJ - 1].hi[0]);"}],
]
# ``--wide`` with no NAME: the kept pair and the diagnostics of the open
# question on its loads (PERF.md section 7), wrong by design and timed
# unchecked: no wait for the staged loads; no stage loaded after the
# first, so the time is the kernels' without waiting on loads.
DEFAULT_WIDE = [
    ["wide_kept", {}],
    ["wide_nocheck_no_wait", {
        "      cp_async_wait<0>();\n      __syncthreads();        // tile kt":
        "      __syncthreads();        // tile kt",
        "      cp_async_wait<0>();\n      __syncthreads();        // step gs":
        "      __syncthreads();        // step gs"}],
    ["wide_nocheck_no_loads", {
        "      if (kn < nk) {\n        float* next":
        "      if (false) {\n        float* next",
        "      if (gn < steps) {\n        float* next":
        "      if (false) {\n        float* next"}],
]
# The FMA pair of an older tree under the tf32x3w route's entry names.
PARENT_RENAME = ["-Dflash_bwd_dq_wide=flash_bwd_dq_tf32x3w",
                 "-Dflash_bwd_dkv_wide=flash_bwd_dkv_tf32x3w",
                 "-Dflash_bwd_wide_error_string="
                 "flash_bwd_tf32x3w_error_string"]


def patched(name: str, path: Path, reps: dict) -> str:
    """``path``'s text with the textual replacements ``reps``."""
    text = path.read_text()
    for old, new in reps.items():
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {path.name}")
        text = text.replace(old, new)
    return text


def build_variant(name: str, reps: dict, source: str = SOURCE,
                  csrc: Path = build.CSRC,
                  defines: tuple = ()) -> tuple[str, Path, str]:
    """``csrc/<source>.cu`` with the textual replacements ``reps`` (those
    under ``"header"`` go to ``tf32x3.cuh``), built with ``csrc``'s
    headers copied beside it into ``build/ab/<name>/``; returns (name,
    library path, ptxas log)."""
    reps = dict(reps)
    header_reps = reps.pop("header", {})
    out = build.BUILD_DIR.parent / "ab" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(
            patched(name, header, header_reps if header.name == HEADER
                    else {}))
    cu, so = out / f"{source}.cu", out / f"{source}.so"
    cu.write_text(patched(name, csrc / f"{source}.cu", reps))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, so, proc.stdout + proc.stderr


def sass_of(so: Path) -> list[str]:
    """The function names and instructions of ``so``'s device code, with
    the anonymous namespace's per-translation-unit tag taken out of the
    names (it differs between any two builds of a changed file)."""
    proc = subprocess.run(
        [str(Path(build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
        capture_output=True, text=True, check=True)
    return [re.sub(r"_GLOBAL__N__\w*?_cu_[0-9a-f]{8}", "_GLOBAL__N__",
                   line.strip())
            for line in proc.stdout.splitlines()
            if "Function :" in line or "/*" in line]


def report_ptxas(name: str, log: str) -> None:
    """Registers and spills per instantiation, and ptxas's lines about
    ``mma`` (a serialised product would show there)."""
    print(f"{name}: ptxas {cs.ptxas_summary(log)}", flush=True)
    for line in log.splitlines():
        if "mma" in line.lower() or "warning" in line.lower():
            print(f"    {line.strip()}")


def use(lib: ctypes.CDLL, source: str = SOURCE):
    """Route the wrapper's tf32x3 (or, for ``WIDE``, tf32x3w) backward to
    ``lib``."""
    accessor = fa._bwd_tf32x3_lib if source == SOURCE else fa._bwd_tf32x3w_lib
    accessor.cache_clear()
    build._LOADED[source] = lib


def compare_sass(other: Path) -> None:
    """SASS of this tree's and ``other``'s builds of every source that
    includes ``tf32x3.cuh`` (the fp32 backward and forward sources), each
    with its own tree's headers; a source the other tree lacks is named
    and skipped."""
    sources = [s for s in SASS_SOURCES if (other / f"{s}.cu").exists()]
    for source in sorted(set(SASS_SOURCES) - set(sources)):
        print(f"{source}: not in {other}, not compared")
    jobs = [(f"sass_{tag}_{source}", {}, source, csrc)
            for source in sources
            for tag, csrc in (("this", build.CSRC), ("other", other))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build_variant(*job), jobs))
    for i, source in enumerate(sources):
        builds = built[2 * i:2 * i + 2]
        sass = [sass_of(so) for _, so, _ in builds]
        diff = [pair for pair in zip(*sass) if pair[0] != pair[1]]
        regs = [cs.ptxas_summary(log) for _, _, log in builds]
        print(f"{source}: SASS of the two builds {len(sass[0])} and "
              f"{len(sass[1])} lines, {len(diff)} of them different; "
              f"registers the same: {regs[0] == regs[1]}"
              + "".join(f"\n    {a}\n    {b}" for a, b in diff[:4]),
              flush=True)


def narrow_ab(spec: list, other: Path | None) -> int:
    """The D <= 128 kernels' variants ``spec`` (with ``other``: this
    tree's source against the other tree's), checked and timed."""
    jobs = [(name, reps, SOURCE, build.CSRC) for name, reps in spec]
    if other is not None:
        compare_sass(other)
        jobs = [("kept", {}, SOURCE, build.CSRC),
                ("other_tree", {}, SOURCE, other)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build_variant(*job), jobs))
    libs = {}
    for name, so, log in built:
        report_ptxas(name, log)
        libs[name] = ctypes.CDLL(str(so))

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [c for c in cs.bwd_cases(gen) if c[1].dtype == torch.float32
             and c[1].shape[3] <= 128]
    failed = {name: [] for name in libs}
    for name, lib in libs.items():
        use(lib)
        for case, q, k, v, do, kw in cases:
            try:
                cs.check_bwd(f"{name}:{case}", q, k, v, do, kw)
            except RuntimeError:
                failed[name].append(case)
        print(f"{name}: {len(cases) - len(failed[name])} of {len(cases)} "
              f"fp32 cases within tolerance; missed: {failed[name] or 'none'}",
              flush=True)
    _, q, k, v, do, kw = next(c for c in cases if c[0] == "train-full-fp32")
    del cases
    first = jobs[0][0]
    use(libs[first])
    _, _, (qf, kf, vf, dof, lse, dsum, p, band, doc) = cs.check_bwd(
        "timing-input", q, k, v, do, kw)
    times = {(name, key): [] for name in libs for key in ("dq", "dkv")}
    for name in [*libs, *reversed(libs)]:
        use(libs[name])
        for key, fn in (("dq", fa._dq_cuda), ("dkv", fa._dkv_cuda)):
            times[name, key] += cs.cuda_times(
                lambda: fn(qf, kf, vf, dof, lse, dsum, p, band, doc),
                reps=21, warmup=3)
    for (name, key), ts in times.items():
        _, _, flops = cs.bwd_bound(q, k, 3 if key == "dq" else 4,
                                   torch.float32)
        med = statistics.median(ts)
        quart = statistics.quantiles(ts, n=4)
        print(f"{name} {key}: median {med:.4f} ms over {len(ts)} "
              f"({flops / med / 1e9:.1f} TFLOP/s of fp32 work), quartiles "
              f"{quart[0]:.4f}-{quart[2]:.4f} ms, min {min(ts):.4f}")
    return 1 if failed[first] else 0


def check_wide(name: str, path: str) -> None:
    """Every fp32 case of phase 3 above D 128 on ``path``'s tf32x3w
    kernels; raises on a disagreement."""
    use(ctypes.CDLL(path), WIDE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case, q, k, v, do, kw in cs.bwd_cases(gen):
        if q.dtype == torch.float32 and q.shape[3] > 128:
            cs.check_bwd(f"{name}:{case}", q, k, v, do, kw)
            torch.cuda.empty_cache()


def wide_ab(spec: list, parent: Path | None) -> int:
    """Build, check and time the tf32x3w pair's variants ``spec`` (and,
    with ``parent``, that tree's tf32x3w pair, or its FMA pair under the
    new names where it has none)."""
    jobs = [(name, reps, WIDE, build.CSRC, ()) for name, reps in spec]
    if parent and (parent / f"{WIDE}.cu").exists():
        jobs.append(("wide_parent", {}, WIDE, parent.resolve(), ()))
    elif parent:
        jobs.append(("wide_parent_fma", {}, "flash_bwd_wide",
                     parent.resolve(), tuple(PARENT_RENAME)))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build_variant(*job), jobs))
    passed = {}
    for name, path, log in built:
        report_ptxas(name, log)
        if "nocheck_" in name:
            print(f"{name}: not checked (a diagnostic)")
            passed[name] = path
            continue
        proc = subprocess.run([sys.executable, __file__, "--check-wide",
                               name, str(path)], capture_output=True,
                              text=True, timeout=900)
        cases = proc.stdout.count(" ok\n")
        if proc.returncode == 0:
            print(f"{name}: {cases} cases within tolerance", flush=True)
            for line in proc.stdout.splitlines():
                if "gemma2" in line or "d320" in line:
                    print(f"    {line.strip()}")
            passed[name] = path
        else:
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-8:]
            print(f"{name}: FAILED after {cases} cases:\n    "
                  + "\n    ".join(tail), flush=True)
    if spec[0][0] not in passed:
        return 1
    from torch.nn.attention import sdpa_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, hq, hkv = cs.BATCH, cs.PROMPT, cs.GEMMA_HQ, cs.GEMMA_HKV
    calls, bounds, lib = {}, {}, {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for d in (cs.GEMMA_D, 320):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((b, l, hq, d), (b, l, hkv, d),
                                     (b, l, hkv, d), (b, l, hq, d)))
        qf, kf, vf, p, band, doc = _fold_chunk_args(q, k, v, causal=True)
        dof = _fold_pad(do, qf.shape[2])
        for cap in (cs.GEMMA_CAP, 0.0):
            pc = p._replace(softcap=cap)
            out, lse = fa._fwd_plain(qf, kf, vf, pc, band=band, doc=doc)
            dsum = (dof.float() * out.float()).sum(dim=-1)
            for key, fn in (("dq", fa._dq_cuda), ("dkv", fa._dkv_cuda)):
                calls[d, cap, key] = functools.partial(
                    fn, qf, kf, vf, dof, lse, dsum, pc, band, doc)
            del out
        for key, n in (("dq", 3), ("dkv", 4)):
            bounds[d, key] = cs.bwd_bound(q, k, n, torch.float32,
                                          cs.PEAK_TF32_FLOPS, 3)
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

            lib[d] = (backend.name, cs.cuda_times(grad, reps=21, warmup=3),
                      cs.cuda_loop_times(grad))
        del out, grad, qt, kt, vt, dot
        torch.cuda.empty_cache()
    names = list(passed)
    # name -> (way, d, softcap, kernel) -> milliseconds
    times = {name: {(way, *key): [] for way in ("call", "loop")
                    for key in calls} for name in names}
    for name in [*names, *reversed(names)]:
        use(ctypes.CDLL(str(passed[name])), WIDE)
        n0 = cs.launch_counts()
        for key, fn in calls.items():
            times[name]["call", *key] += cs.cuda_times(fn, reps=21, warmup=3)
            times[name]["loop", *key] += cs.cuda_loop_times(fn)
        moved = cs.launches_since(n0)
        want = 4 * 127
        if (moved["dq_tf32x3w"], moved["dkv_tf32x3w"]) != (want, want):
            print(f"{name}: the timing left the tf32x3w route: {moved}")
            return 1
    for name in names:
        for (way, d, cap, key), ts in times[name].items():
            med = statistics.median(ts)
            bound, _, flops = bounds[d, key]
            quart = statistics.quantiles(ts, n=4)
            print(f"{name} {key} D {d} softcap {cap:g} ({way}): median "
                  f"{med:.4f} ms over {len(ts)} ({3 * flops / med / 1e9:.1f} "
                  f"TFLOP/s of TF32 issued, {100 * bound / med:.2f}% of the "
                  f"{bound:.4f} ms bound), quartiles {quart[0]:.4f}-"
                  f"{quart[2]:.4f} ms, min {min(ts):.4f}")
        for way in ("call", "loop"):
            for d in (cs.GEMMA_D, 320):
                for cap in (cs.GEMMA_CAP, 0.0):
                    pair = sum(statistics.median(times[name][way, d, cap, key])
                               for key in ("dq", "dkv"))
                    print(f"{name} pair D {d} softcap {cap:g} ({way}): "
                          f"{pair:.4f} ms")
    for d, (backend, call, loop) in lib.items():
        print(f"sdpa backward D {d} ({backend}, repeated kv, no softcap): "
              f"median {statistics.median(call):.4f} ms over {len(call)}, "
              f"min {min(call):.4f}, max {max(call):.4f}; back to back "
              f"{statistics.median(loop):.4f}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_flash_bwd_tf32x3: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--check-wide"]:    # a child: one variant's check
        check_wide(*sys.argv[2:4])
        return 0
    print(cs.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:2] == ["--wide"]:
        args, parent = sys.argv[2:], None
        if args[:1] == ["--parent"]:
            parent, args = Path(args[1]), args[2:]
        named = dict(DEFAULT_WIDE + MEASURED_WIDE)
        spec = [[v, named[v]] for v in args] or DEFAULT_WIDE
        return wide_ab(spec, parent)
    if sys.argv[1:2] == ["--header-from"]:
        return narrow_ab([], Path(sys.argv[2]).resolve())
    spec = json.loads(Path(sys.argv[1]).read_text()) \
        if len(sys.argv) > 1 else DEFAULT
    return narrow_ab(spec, None)


if __name__ == "__main__":
    sys.exit(main())
