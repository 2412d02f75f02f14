"""Where the time of kernels E, D, F, G and H goes: ablations of a kernel's
first version and of the choices of its redesign, timed on the main path's
own launch.

    python3 bwd_ablation.py [--kernel bwd|fwd|rowsum|segsum|rowscan]
                            [--first-version PATH] [--out FILE]

Measurement only; nothing of the port imports it. Needs one CUDA card and
nvcc.

`--kernel bwd` (the default), kernel E. It builds the flagship scene of
chip_smoke.py, captures the arguments
of the one `composite_bwd` call of a full-width training step, and times on
them (CUDA events, kernel launches only: the output buffer is made once,
outside the timing, and so is the g . accum that the first version was
handed and the shipped kernel forms itself) scratch copies of two sources,
each copy with a few lines replaced (`PATCHES` below; a replacement that
does not find its lines raises):

  * the first version of the kernel (one pixel a thread, 256 threads a
    tile), read from `--first-version`: the file
    street_gaussians_ns_tpu_torch/csrc/composite_bwd.cu of the last commit
    before the redesign, with that commit's common.cuh beside it (default:
    where `git archive <that commit> | tar -x -C build/torch_kernels/parent`
    puts them). As it was and with one part of its work removed at a time:
    the reduction over the tile's pixels, the staging loads after a tile's
    first batch, the block barriers, all three (wrong gradients by design,
    right timing); with its tiles issued heaviest first; and with per-CTA
    clocks, from which the per-SM busy spans are read. Without the file
    these variants are left out and the report says so;
  * the shipped kernel (csrc/composite_bwd.cu) at 1, 2 and 4 pixels a
    thread, with and without the fused multiply-adds of its gradient
    terms and the fast division in place of two IEEE ones, and with its
    tiles issued heaviest first;
  * the wrapper's pieces: the zero fill of the gradient stream, g . accum,
    the visited counts, the sort that makes the heaviest-first order.

Every variant that is meant to be right is held against the shipped
kernel's output (1e-4 of the largest gradient; the rank row exact).

`--kernel fwd`, kernel D, on the arguments of the full render of one
full-width eval frame (6,600 tiles), scratch copies of:

  * the first version (one pixel a thread, 256 threads a tile, pairs
    staged 256 at a time in one shared-memory row per feature), from
    `--first-version` (default: street_gaussians_ns_tpu_torch/csrc/
    composite_fwd.cu under build/torch_kernels/parent, where a `git
    archive` of any commit before kernel D's redesign puts it): as it
    was; with a pair's features in one 12-float slot fetched by three
    16-byte loads (the loads' share); with the pixel's step branch-free
    and the warp leaving a batch by vote (the branches' share); with
    batches of 64 and of 128 pairs (the batch granularity); with per-CTA
    clocks (the tail);
  * the shipped kernel at 1, 2 and 4 pixels a thread, with batches of 32,
    128 and 256 pairs, held to 20 and 24 resident CTAs an SM
    (`__launch_bounds__`), without the fused multiply-adds of its colour sums,
    without its per-pair warp exit, with one or both of two warp-wide
    shortcuts it does not have (leave a pair far from every live pixel of
    the warp before its exps, one that none of them considers before the
    updates), and with per-CTA clocks.

Every variant is held against the shipped kernel: n_contrib and T_final
bit for bit, accum at atol 2e-5. The report adds the pairs each tile
needed (from the shipped kernel's `evals`), the pairs a tile walks at each
batch size, and the per-SM busy spans of both versions.

`--kernel segsum`, kernel G, on per-rank segments of the full-width
training step's gradient rows (`captured_segments`):
its first version (a thread per segment; `segsum.cu` beside
`--first-version`'s default) and the shipped kernel (4 warps over 128
segments) as it is, with 8 warps over 256 segments (built for 3 and for 5
blocks an SM), groups of 64 and 256 segments, 2 warps over 64, built for
6 and 8 blocks an SM (`__launch_bounds__`), 2 and 10 rows a pass, 2 and
8 pairs a lane, and with per-CTA clocks (the per-SM busy spans); the
groups' spans. Every variant is held
to the plain version at rtol 1e-4 + atol 1e-5 of the largest |sum|.

`--kernel rowscan`, kernel H, at the three shapes of chip_smoke.py's
row_scan_path: its first version (the three-launch tree; `scan_rows.cu`
beside `--first-version`'s default) and the shipped kernel as it is, with
16 elements a thread (twice the tiles), with 1, 2 and 8 look-back rounds
kept, built for 1 and 3 blocks an SM, without its look-back (every tile
taking the identity as its prefix: wrong by design, the streaming floor),
and with per-tile counters of the look-back (its clock cycles, rounds,
the distance to the INCLUSIVE met, the re-polls of a round that met an
EMPTY, the first round's cycles, the cycles from the ticket to the
look-back). int32 and max are held bit for bit to the shipped kernel,
the float32 sum at rtol 1e-5 of the column's largest against float64.

`--kernel rowsum`, kernel F, on the arguments of the rank sum of the
full-width training step's backward: its first version (a thread per
output rank; `ranksum.cu` beside `--first-version`'s default) and the
shipped kernel as it is, with 10 rows a pass instead of 5, with 2 and 8
pairs a thread, without its memset (the kernel alone) and without its
kernel (the memset alone); each timed on the host's clock and behind a
busy card. The variants that are meant to be right are held to the
plain version at rtol 1e-4 + atol 1e-5 of the largest |sum|.

The times of all variants are taken in turns, `--rounds` times over, and
the median is reported. One JSON object per line on stdout; with
`--out FILE` the whole report is also written to FILE.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from street_gaussians_ns_tpu_torch.ops import (_cuda, composite, scan,
                                               segreduce)

OUT_DIR = _cuda.BUILD_DIR / "ablation"
SHIPPED = _cuda.CSRC / "composite_bwd.cu"
FIRST_VERSION = (_cuda.BUILD_DIR / "parent" / "street_gaussians_ns_tpu_torch"
                 / "csrc" / "composite_bwd.cu")
FWD_SHIPPED = _cuda.CSRC / "composite_fwd.cu"
FWD_FIRST_VERSION = FIRST_VERSION.with_name("composite_fwd.cu")
F_SHIPPED = _cuda.CSRC / "ranksum.cu"
F_FIRST_VERSION = FIRST_VERSION.with_name("ranksum.cu")
G_SHIPPED = _cuda.CSRC / "segsum.cu"
G_FIRST_VERSION = FIRST_VERSION.with_name("segsum.cu")
H_SHIPPED = _cuda.CSRC / "scan_rows.cu"
H_FIRST_VERSION = FIRST_VERSION.with_name("scan_rows.cu")

# Both sources get this behind their include: the tile order and the clock
# buffer reach a patched kernel through two device globals, so that the
# entry point keeps its arguments.
PRELUDE = """
__device__ const int* abl_order;
__device__ long long* abl_clk;
SG_EXPORT int abl_set(const int* order, long long* clk) {
  cudaMemcpyToSymbol(abl_order, &order, sizeof(order));
  cudaMemcpyToSymbol(abl_clk, &clk, sizeof(clk));
  return sg_last_error();
}
"""

FOLD = """        fold<NG, H0, 16>(g, lane & 16);
        fold<H0, H1, 8>(g, lane & 8);
        fold<H1, H2, 4>(g, lane & 4);
        fold<H2, 1, 2>(g, lane & 2);
        g[0] += __shfl_xor_sync(FULL, g[0], 1);
        if (my_row >= 0) red[warp][my_row][j] = g[0];
"""
NO_FOLD = """        {
          float s = 0.0f;
#pragma unroll
          for (int f = 0; f < NG; ++f) s += g[f];
          lane_acc += s;
        }
"""
CLOCK_END = """  __syncthreads();
  if (tid == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    abl_clk[3 * (long long)blockIdx.x + 0] = clk_start;
    abl_clk[3 * (long long)blockIdx.x + 1] = clock64();
    abl_clk[3 * (long long)blockIdx.x + 2] = smid;
  }
}

template <int NC>
void launch("""
ORDER = [("  const int t = blockIdx.x;\n",
          "  const int t = abl_order[blockIdx.x];\n")]

# switch -> [(lines of the source, what replaces them)]. "nobar" is not a
# replacement of one place: see `patched`.
PATCHES = {
    # The first version.
    "nofold": [
        ("  unsigned int nev = 0, ncontrib = 0;\n",
         "  unsigned int nev = 0, ncontrib = 0;\n  float lane_acc = 0.0f;\n"),
        (FOLD, NO_FOLD),
        ("        float s = red[0][f][tid];\n#pragma unroll\n"
         "        for (int w = 1; w < WARPS; ++w) s += red[w][f][tid];\n",
         "        const float s = lane_acc;\n")],
    "nostage": [
        ("    if (tid < nb) {\n      const long long p = start + b0 + tid;\n"
         "      const float* src",
         "    if (tid < nb && b0 == 0) {\n"
         "      const long long p = start + b0 + tid;\n"
         "      const float* src")],
    "clock": [
        ("  constexpr int NG = 6 + NC;\n",
         "  const long long clk_start = clock64();\n"
         "  constexpr int NG = 6 + NC;\n"),
        ("}\n\ntemplate <int NC>\nvoid launch(", CLOCK_END)],
    "order": ORDER,
    # The shipped kernel.
    "ppt1": [("constexpr int PPT = 4; ", "constexpr int PPT = 1; ")],
    "ppt2": [("constexpr int PPT = 4; ", "constexpr int PPT = 2; ")],
    "ppt4": [],
    "nofma": [("  return __fmaf_rn(a, b, c);\n", "  return a * b + c;\n")],
    "div": [
        ("          const float raw =\n"
         "              muladd(gc, T[k], -__fdividef(gs + gt_tfin[k], om));\n",
         "          const float raw = gc * T[k] - gs / om - gt_tfin[k] / om;\n"
         )],
}

# name -> (first version?, switches, right results?)
VARIANTS = {
    "v1": (True, (), True),
    "v1-nofold": (True, ("nofold",), False),
    "v1-nostage": (True, ("nostage",), False),
    "v1-nobar": (True, ("nobar",), False),
    "v1-nofold-nostage-nobar": (True, ("nofold", "nostage", "nobar"), False),
    "v1-order": (True, ("order",), True),
    "v1-clock": (True, ("clock",), True),
    "v2-ppt1": (False, ("ppt1",), True),
    "v2-ppt2": (False, ("ppt2",), True),
    "v2-ppt4": (False, ("ppt4",), True),
    "v2-ppt4-nofma": (False, ("ppt4", "nofma"), True),
    "v2-ppt4-div": (False, ("ppt4", "div"), True),
    "v2-ppt4-nofma-div": (False, ("ppt4", "nofma", "div"), True),
    "v2-ppt1+order": (False, ("ppt1", "order"), True),
    "v2-ppt2+order": (False, ("ppt2", "order"), True),
    "v2-ppt4+order": (False, ("ppt4", "order"), True),
}

VP, INT = ctypes.c_void_p, ctypes.c_int
# Both versions' entry point: feat, tile_start, tile_count, num_tiles, ntx,
# nc, tile0, tin, g_accum, g_t, tfin, ncon, (g . accum | accum), gpair,
# evals, stream.
ARGTYPES = [VP, VP, VP, INT, INT, INT, INT, VP, VP, VP, VP, VP, VP, VP, VP,
            VP]

# Kernel D. The first version's batch loop, one pixel a thread, and the
# same step branch-free: every lane evaluates every pair of the batch
# until its warp votes that all of its pixels are done.
V1_STEP = """    if (!done) {
      for (int j = 0; j < nb; ++j) {
        float dx, dy, falloff;
        const float sigma = sg_sigma(sm[0][j], sm[1][j], sm[2][j], sm[3][j],
                                     sm[4][j], px, py, dx, dy);
        ++nev;
        if (sigma < SG_SIGMA_MIN) continue;
        const float alpha = sg_alpha(sm[5][j], sigma, falloff);
        if (alpha < SG_ALPHA_THRESH) continue;
        const float next_T = T * (1.0f - alpha);
        if (next_T <= SG_T_EPS) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] += sm[6 + c][j] * w;
        T = next_T;
        last = b0 + j + 1;
      }
    }
"""
V1_STEP_NOBRANCH = """    for (int j = 0; j < nb; ++j) {
      if (__all_sync(0xffffffffu, done)) break;
      float dx, dy, falloff;
      const float sigma = sg_sigma(sm[0][j], sm[1][j], sm[2][j], sm[3][j],
                                   sm[4][j], px, py, dx, dy);
      const float alpha = sg_alpha(sm[5][j], sigma, falloff);
      const bool live = !done;
      nev += live;
      const bool considered = live && !(sigma < SG_SIGMA_MIN) &&
                              !(alpha < SG_ALPHA_THRESH);
      const float next_T = T * (1.0f - alpha);
      const bool ends = considered && next_T <= SG_T_EPS;
      const bool c = considered && !ends;
      const float w = c ? alpha * T : 0.0f;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) acc[ch] += sm[6 + ch][j] * w;
      T = c ? next_T : T;
      last = c ? b0 + j + 1 : last;
      done = done || ends;
    }
"""
V1_LOADS = """        const float sigma = sg_sigma(sm[0][j], sm[1][j], sm[2][j], sm[3][j],
                                     sm[4][j], px, py, dx, dy);
"""
V1_LOADS_SLOT = """        const float4 f0 = *reinterpret_cast<const float4*>(&sm[j][0]);
        const float4 f1 = *reinterpret_cast<const float4*>(&sm[j][4]);
        const float4 f2 = *reinterpret_cast<const float4*>(&sm[j][8]);
        const float col[4] = {f1.z, f1.w, f2.x, f2.y};
        const float sigma = sg_sigma(f0.x, f0.y, f0.z, f0.w, f1.x, px, py, dx,
                                     dy);
"""
# The shipped kernel's step with one of two warp-wide shortcuts: a pair
# whose sigma exceeds 6 at every live pixel of the warp (at opacity <= 1,
# alpha < 1/255 there) is left before its exps; a pair that no live pixel
# of the warp considers is left before the updates.
SIGMA_ALPHA = """#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float dx, dy, falloff;
        sigma[k] = sg_sigma(f0.x, f0.y, f0.z, f0.w, f1.x, px, py[k], dx, dy);
        alpha[k] = sg_alpha(f1.y, sigma[k], falloff);
      }
"""
SIGMA_FAR_ALPHA = """      bool far = f1.y <= 1.0f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float dx, dy;
        sigma[k] = sg_sigma(f0.x, f0.y, f0.z, f0.w, f1.x, px, py[k], dx, dy);
        far = far && (done[k] || sigma[k] > 6.0f);
      }
      if (__all_sync(FULL, far)) {
#pragma unroll
        for (int k = 0; k < PPT; ++k)
          if (COUNT) nev[k] += !done[k];
        continue;
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float falloff;
        alpha[k] = sg_alpha(f1.y, sigma[k], falloff);
      }
"""
SKIP_NONE = """      {
        bool any = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k)
          any = any || (!done[k] && !(sigma[k] < SG_SIGMA_MIN) &&
                        !(alpha[k] < SG_ALPHA_THRESH));
        if (!__any_sync(FULL, any)) {
#pragma unroll
          for (int k = 0; k < PPT; ++k)
            if (COUNT) nev[k] += !done[k];
          continue;
        }
      }
"""
FWD_CLOCK_END = CLOCK_END.replace(
    "template <int NC>\nvoid launch(",
    "template <int NC, bool TIN, bool COUNT>\nvoid launch_mode(")

FWD_PATCHES = {
    # The first version.
    "slot": [
        ("  __shared__ float sm[6 + NC][BATCH];\n",
         "  __shared__ __align__(16) float sm[BATCH][12];\n"),
        ("sm[f][tid] = __ldg(src + f * K);", "sm[tid][f] = __ldg(src + f * K);"),
        (V1_LOADS, V1_LOADS_SLOT),
        ("sg_alpha(sm[5][j], sigma, falloff)", "sg_alpha(f1.y, sigma, falloff)"),
        ("acc[c] += sm[6 + c][j] * w;", "acc[c] += col[c] * w;")],
    "nobranch": [(V1_STEP, V1_STEP_NOBRANCH)],
    "v1batch64": [("constexpr int BATCH = PIX;\n", "constexpr int BATCH = 64;\n")],
    "v1batch128": [("constexpr int BATCH = PIX;\n",
                    "constexpr int BATCH = 128;\n")],
    "v1clock": [
        ("  __shared__ float sm[6 + NC][BATCH];\n",
         "  const long long clk_start = clock64();\n"
         "  __shared__ float sm[6 + NC][BATCH];\n"),
        ("}\n\ntemplate <int NC>\nvoid launch(", CLOCK_END)],
    # The shipped kernel.
    "ppt1": [("constexpr int PPT = 4; ", "constexpr int PPT = 1; ")],
    "ppt2": [("constexpr int PPT = 4; ", "constexpr int PPT = 2; ")],
    "ppt4": [],
    "batch32": [("constexpr int BATCH = 64;\n", "constexpr int BATCH = 32;\n")],
    "batch128": [("constexpr int BATCH = 64;\n",
                  "constexpr int BATCH = 128;\n")],
    "batch256": [("constexpr int BATCH = 64;\n",
                  "constexpr int BATCH = 256;\n")],
    "nofma": [("  return __fmaf_rn(a, b, c);\n", "  return a * b + c;\n")],
    "noexit": [("      if (__all_sync(FULL, all_done)) break;\n", "")],
    "occ20": [("__global__ void __launch_bounds__(THREADS)\n",
               "__global__ void __launch_bounds__(THREADS, 20)\n")],
    "occ24": [("__global__ void __launch_bounds__(THREADS)\n",
               "__global__ void __launch_bounds__(THREADS, 24)\n")],
    "far": [(SIGMA_ALPHA, SIGMA_FAR_ALPHA)],
    "skip": [("      all_done = true;\n", SKIP_NONE + "      all_done = true;\n")],
    "clock": [
        ("  constexpr int NG = 6 + NC;\n",
         "  const long long clk_start = clock64();\n"
         "  constexpr int NG = 6 + NC;\n"),
        ("}\n\ntemplate <int NC, bool TIN, bool COUNT>\nvoid launch_mode(",
         FWD_CLOCK_END)],
}

# name -> (first version?, switches, right results?)
FWD_VARIANTS = {
    "v1": (True, (), True),
    "v1-slot": (True, ("slot",), True),
    "v1-nobranch": (True, ("nobranch",), True),
    "v1-batch64": (True, ("v1batch64",), True),
    "v1-batch128": (True, ("v1batch128",), True),
    "v1-clock": (True, ("v1clock",), True),
    "v2-ppt1": (False, ("ppt1",), True),
    "v2-ppt2": (False, ("ppt2",), True),
    "v2-ppt4": (False, ("ppt4",), True),
    "v2-batch32": (False, ("batch32",), True),
    "v2-batch128": (False, ("batch128",), True),
    "v2-batch256": (False, ("batch256",), True),
    "v2-nofma": (False, ("nofma",), True),
    "v2-noexit": (False, ("noexit",), True),
    "v2-occ20": (False, ("occ20",), True),
    "v2-occ24": (False, ("occ24",), True),
    "v2-far": (False, ("far",), True),
    "v2-skip": (False, ("skip",), True),
    "v2-far-skip": (False, ("far", "skip"), True),
    "v2-clock": (False, ("clock",), True),
}

# Both versions' entry point: feat, tile_start, tile_count, num_tiles, ntx,
# nc, tile0, tin, mark_done, accum, tfin, ncon, evals, stream.
FWD_ARGTYPES = [VP, VP, VP, INT, INT, INT, INT, VP, INT, VP, VP, VP, VP, VP]

# Kernel F.
F_PATCHES = {
    "rows10": [("constexpr int ROWS = 5; ", "constexpr int ROWS = 10; ")],
    "items2": [("constexpr int ITEMS = 4; ", "constexpr int ITEMS = 2; ")],
    "items8": [("constexpr int ITEMS = 4; ", "constexpr int ITEMS = 8; ")],
    "nomemset": [("""  const cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * (size_t)ng * (size_t)num_out, s);
""", "  const cudaError_t err = cudaSuccess;\n")],
    "nokernel": [("  if (p_len == 0) return 0;\n",
                  "  if (p_len >= 0) return 0;\n")],
}
F_VARIANTS = {
    "v1": (True, (), True),
    "v2": (False, (), True),
    "v2-rows10": (False, ("rows10",), True),
    "v2-items2": (False, ("items2",), True),
    "v2-items8": (False, ("items8",), True),
    "v2-nomemset": (False, ("nomemset",), False),
    "v2-memset-only": (False, ("nokernel",), False),
}
# Both versions' entry point: rows, ranks, out, ng, p_len, num_out, stream.
F_ARGTYPES = [VP, VP, VP, INT, ctypes.c_longlong, INT, VP]
# Kernel G.
G_CLOCK_START = "  const int nseg = (int)min((long long)GROUP, num_seg - g0);\n"
G_PATCHES = {
    "t64": [("constexpr int THREADS = 128;\n", "constexpr int THREADS = 64;\n")],
    "t256": [("constexpr int THREADS = 128;\n",
              "constexpr int THREADS = 256;\n")],
    "group64": [("constexpr int GROUP = 128; ", "constexpr int GROUP = 64; ")],
    "group256": [("constexpr int GROUP = 128; ",
                  "constexpr int GROUP = 256; ")],
    "mb3": [("constexpr int MIN_BLOCKS = 5; ",
             "constexpr int MIN_BLOCKS = 3; ")],
    "mb6": [("constexpr int MIN_BLOCKS = 5; ",
             "constexpr int MIN_BLOCKS = 6; ")],
    "mb8": [("constexpr int MIN_BLOCKS = 5; ",
             "constexpr int MIN_BLOCKS = 8; ")],
    "rows2": [("constexpr int ROWS = 5; ", "constexpr int ROWS = 2; ")],
    "rows10": [("constexpr int ROWS = 5; ", "constexpr int ROWS = 10; ")],
    "items2": [("constexpr int ITEMS = 4; ", "constexpr int ITEMS = 2; ")],
    "items8": [("constexpr int ITEMS = 4; ", "constexpr int ITEMS = 8; ")],
    "clock": [
        (G_CLOCK_START,
         G_CLOCK_START + "  const long long clk_start = clock64();\n"),
        ("      }\n    }\n  }\n}\n\n}  // namespace",
         "      }\n    }\n  }\n" + CLOCK_END.split("\n\ntemplate")[0]
         + "\n\n}  // namespace")],
}
# The shipped kernel: 4 warps over 128 segments, up to 102 registers.
G_VARIANTS = {
    "v1": (True, (), True),
    "v2": (False, (), True),
    "v2-t256-group256-mb3": (False, ("t256", "group256", "mb3"), True),
    "v2-t256-group256": (False, ("t256", "group256"), True),
    "v2-group64": (False, ("group64",), True),
    "v2-group256": (False, ("group256",), True),
    "v2-t64-group64": (False, ("t64", "group64"), True),
    "v2-mb6": (False, ("mb6",), True),
    "v2-mb8": (False, ("mb8",), True),
    "v2-rows2": (False, ("rows2",), True),
    "v2-rows10": (False, ("rows10",), True),
    "v2-items2": (False, ("items2",), True),
    "v2-items8": (False, ("items8",), True),
    "v2-clock": (False, ("clock",), True),
}
# Both versions' entry point: rows, starts, ends, out, nrows, p_len,
# num_seg, stream.
G_ARGTYPES = [VP, VP, VP, VP, INT, ctypes.c_longlong, INT, VP]

# Kernel H. "stats" writes, per tile, the look-back's clock cycles, its
# rounds (re-polls included) and how far back column 0 met an INCLUSIVE.
H_PATCHES = {
    "pt16": [("constexpr int PER_THREAD = 32; ",
              "constexpr int PER_THREAD = 16; ")],
    "win1": [("constexpr int WINDOWS = 4; ", "constexpr int WINDOWS = 1; ")],
    "win2": [("constexpr int WINDOWS = 4; ", "constexpr int WINDOWS = 2; ")],
    "win8": [("constexpr int WINDOWS = 4; ", "constexpr int WINDOWS = 8; ")],
    "lb1": [("constexpr int MIN_BLOCKS = 4; ",
             "constexpr int MIN_BLOCKS = 1; ")],
    "lb3": [("constexpr int MIN_BLOCKS = 4; ",
             "constexpr int MIN_BLOCKS = 3; ")],
    "nolookback": [("    if (tile > 0) {\n      // The whole block looks back",
                    "    if (false) {\n      // The whole block looks back")],
    "stats": [
        ("  unsigned tile = 0, tag = 0;\n",
         "  unsigned tile = 0, tag = 0;\n"
         "  const long long abl_start = clock64();\n"),
        ("      unsigned todo = (1u << C) - 1u;\n",
         "      unsigned todo = (1u << C) - 1u;\n"
         "      const long long abl_t0 = clock64();\n"
         "      long long abl_first = -1;\n"
         "      int abl_rounds = 0, abl_empty = 0;\n"),
        ("        const int slot = w < WINDOWS ? w : WINDOWS - 1;\n",
         "        const int slot = w < WINDOWS ? w : WINDOWS - 1;\n"
         "        ++abl_rounds;\n"),
        ("          if (!__syncthreads_or(empty)) break;\n",
         "          if (!__syncthreads_or(empty)) break;\n"
         "          ++abl_empty;\n"),
        ("        // A column already settled keeps",
         "        if (abl_first < 0) abl_first = clock64() - abl_t0;\n"
         "        // A column already settled keeps"),
        ("      if (warp == 0 && lane < C) {\n        // Forward from",
         "      if (tid == 0) {\n"
         "        long long* r = abl_clk + H_STATS * (long long)tile;\n"
         "        r[0] = clock64() - abl_t0;\n"
         "        r[1] = abl_rounds;\n"
         "        r[2] = 1 + s_near[0];\n"
         "        r[3] = abl_empty;\n"
         "        r[4] = abl_first;\n"
         "        r[5] = abl_t0 - abl_start;\n"
         "      }\n"
         "      if (warp == 0 && lane < C) {\n        // Forward from"),
        ("constexpr int MAX_C = 16;\n",
         "constexpr int MAX_C = 16;\nconstexpr int H_STATS = 6;\n")],
}
# The per-tile fields the "stats" variant writes.
H_STATS = ("lookback_cycles", "rounds", "distance", "empty_repolls",
           "first_round_cycles", "cycles_to_lookback")
H_VARIANTS = {
    "v1": (True, (), True),
    "v2": (False, (), True),
    "v2-pt16": (False, ("pt16",), True),
    "v2-win1": (False, ("win1",), True),
    "v2-win2": (False, ("win2",), True),
    "v2-win8": (False, ("win8",), True),
    "v2-lb1": (False, ("lb1",), True),
    "v2-lb3": (False, ("lb3",), True),
    "v2-nolookback": (False, ("nolookback",), False),
    "v2-stats": (False, ("stats",), True),
}
# The shipped entry point: x, out, scratch, scratch_words, m, c, dtype, op,
# stream; the first version's had no scratch_words and took a scratch of
# its own layout (H_V1_ARGTYPES).
H_ARGTYPES = [VP, VP, VP, ctypes.c_longlong, ctypes.c_longlong, INT, INT,
              INT, VP]
H_V1_ARGTYPES = [VP, VP, VP, ctypes.c_longlong, INT, INT, INT, VP]
MODES = {
    "bwd": (VARIANTS, PATCHES, SHIPPED, "sg_composite_bwd", ARGTYPES),
    "fwd": (FWD_VARIANTS, FWD_PATCHES, FWD_SHIPPED, "sg_composite_fwd",
            FWD_ARGTYPES),
    "rowsum": (F_VARIANTS, F_PATCHES, F_SHIPPED, "sg_rank_rowsum",
               F_ARGTYPES),
    "segsum": (G_VARIANTS, G_PATCHES, G_SHIPPED, "sg_segment_rowsum",
               G_ARGTYPES),
    "rowscan": (H_VARIANTS, H_PATCHES, H_SHIPPED, "sg_scan_rows",
                H_ARGTYPES),
}


def emit(what: str, **fields) -> dict:
    rec = {"what": what, **fields}
    print(json.dumps(rec), flush=True)
    return rec


def replace_once(text: str, old: str, new: str, where: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"{where}: expected these lines once, found them "
                         f"{text.count(old)} times:\n{old}")
    return text.replace(old, new)


def patched(source: Path, switches, patches=None) -> str:
    """The source with the prelude behind its include and the switches'
    lines replaced (`patches`: PATCHES, kernel E's, or FWD_PATCHES)."""
    patches = PATCHES if patches is None else patches
    text = replace_once(source.read_text(), '#include "common.cuh"\n',
                        '#include "common.cuh"\n' + PRELUDE, str(source))
    for sw in switches:
        if sw == "nobar":
            # The three block barriers of the batch loop become warp
            # barriers; the two before the loop stay.
            head, loop, body = text.partition(
                "  for (int b0 = 0; b0 < nmax; b0 += BATCH) {\n")
            if not loop or body.count("__syncthreads();") != 3:
                raise ValueError(f"{source}: nobar: the batch loop's three "
                                 f"barriers not found")
            text = head + loop + body.replace("__syncthreads();",
                                              "__syncwarp();")
            continue
        for old, new in patches[sw]:
            text = replace_once(text, old, new, f"{source}: {sw}")
    return text


BUILD_LOGS: dict = {}          # variant -> its nvcc log


def build_all(first_version: Path | None, kernel: str = "bwd") -> dict:
    """One nvcc per variant of `kernel` (a key of MODES), all started
    together. Returns name -> (ctypes library, ptxas summary); a variant
    that fails to build is reported and left out."""
    variants, patches, shipped, entry, argtypes = MODES[kernel]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (v1, switches, _) in variants.items():
        if v1 and first_version is None:
            continue
        source = first_version if v1 else shipped
        stem = f"{kernel}-{name}"
        cu = OUT_DIR / f"{stem}.cu"
        cu.write_text(patched(source, switches, patches))
        out = OUT_DIR / f"{stem}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(source.parent),
               "-o", str(out), str(cu)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            emit("build_failed", variant=name, log=log[-4000:])
            continue
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)]
        BUILD_LOGS[name] = log
        lib = ctypes.CDLL(str(out))
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = INT
        lib.abl_set.argtypes = [VP, VP]
        lib.abl_set.restype = INT
        libs[name] = (lib, dict(registers=regs, spill_store_bytes=spills,
                                smem_bytes_max=max(smem, default=0)))
    return libs


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def captured_backward(seed: int, kernel: str = "composite_bwd"):
    """The arguments of the full-width training step's composite_bwd (or
    rank_rowsum)."""
    chip_smoke.phase_device()
    store, tracks, cfg, rcfg, cam0, _ = chip_smoke.phase_main(seed)
    del store
    state, batch, _, _ = chip_smoke.phase_train(seed, tracks, cfg, rcfg,
                                                cam0)
    calls, _, _ = chip_smoke.capture_train(state, tracks, cfg, rcfg, cam0,
                                           batch)
    (args, _), = calls[kernel]
    return args


def in_turns(runs: dict, rounds: int, timer) -> tuple:
    """Every run timed by `timer(run)` once a round, the runs in turns,
    `rounds` times over. Returns (medians, all times) by name."""
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name, run in runs.items():
            times[name].append(timer(run))
    return {n: statistics.median(v) for n, v in times.items()}, times


def busy_spans(run, clk: torch.Tensor, reps: int) -> dict:
    """One launch of a clock variant (which writes each CTA's start and
    end clock and its SM into clk); the per-SM busy spans, in SM cycles."""
    run()
    torch.cuda.synchronize()
    wall_ms = time_ms(run, reps)
    c = clk.cpu()
    dur = (c[:, 1] - c[:, 0]).double()
    spans = []
    for sm in torch.unique(c[:, 2]).tolist():
        m = c[:, 2] == sm
        spans.append(float(c[m, 1].max() - c[m, 0].min()))
    spans_t = torch.tensor(spans)
    return dict(
        sms=len(spans), wall_ms=wall_ms,
        span_cycles=dict(min=float(spans_t.min()),
                         mean=float(spans_t.mean()),
                         max=float(spans_t.max())),
        mean_span_over_longest=float(spans_t.mean() / spans_t.max()),
        cta_cycles=dict(sum=float(dur.sum()), mean=float(dur.mean()),
                        max=float(dur.max())),
        mean_ctas_resident_per_sm=float(dur.sum() / spans_t.sum()),
        longest_cta_over_longest_span=float(dur.max() / spans_t.max()))


def heaviest_first(nvis: torch.Tensor) -> torch.Tensor:
    """(T,) int32 permutation of the tiles, most visited pairs first."""
    return torch.sort(nvis, descending=True,
                      stable=True).indices.to(torch.int32)


def captured_forward(seed: int):
    """The arguments of the full render of one full-width eval frame's
    composite_fwd."""
    chip_smoke.phase_device()
    store, tracks, cfg, rcfg, cam0, _ = chip_smoke.phase_main(seed)
    calls = chip_smoke.capture(store, tracks, cfg, rcfg, cam0)
    args, _ = calls["composite_fwd"][0]
    return args


def main_fwd(args, report: list) -> None:
    first_version = args.first_version or FWD_FIRST_VERSION
    if not first_version.exists():
        report.append(emit("first_version_missing", path=str(first_version),
                           left_out=[k for k, v in FWD_VARIANTS.items()
                                     if v[0]]))
        first_version = None
    libs = build_all(first_version, "fwd")
    feat, ts, tc, ntx, nc = captured_forward(args.seed)
    # The launched instantiation's ptxas line (no t_in, no counting).
    report.append(emit("build", variants={
        k: dict(v[1], launched={
            n: e for n, e in chip_smoke.ptxas_entries(BUILD_LOGS[k]).items()
            if f"ILi{nc}ELb0E" in n and "ELb1EE" not in n})
        for k, v in libs.items()}))
    dev = feat.device
    num_tiles = ts.numel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    clk = torch.zeros((num_tiles, 3), dtype=torch.int64, device=dev)
    accum = torch.empty((num_tiles, composite.PIX, nc), dtype=torch.float32,
                        device=dev)
    tfin = torch.empty((num_tiles, composite.PIX), dtype=torch.float32,
                       device=dev)
    ncon = torch.empty((num_tiles, composite.PIX), dtype=torch.int32,
                       device=dev)

    def runner(name):
        lib, _ = libs[name]
        rc = lib.abl_set(None, clk.data_ptr())
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        a = (feat.data_ptr(), ts.data_ptr(), tc.data_ptr(), num_tiles, ntx,
             nc, 0, None, 0, accum.data_ptr(), tfin.data_ptr(),
             ncon.data_ptr(), None, stream)

        def run():
            rc = lib.sg_composite_fwd(*a)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return run

    runs = {name: runner(name) for name in libs}

    # Agreement with the shipped kernel: n_contrib and T_final bit for
    # bit, accum at atol 2e-5 (the colour sums' rounding differs).
    evals = torch.zeros((2 + num_tiles,), dtype=torch.int64, device=dev)
    want = composite.composite_fwd(feat, ts, tc, ntx, nc, evals=evals)
    agree = {}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        err = float((accum - want[0]).abs().max())
        same = (torch.equal(tfin, want[1]), torch.equal(ncon, want[2]))
        agree[name] = dict(accum_max_abs_err=err, t_final_equal=same[0],
                           n_contrib_equal=same[1])
        if err > 2e-5 or not all(same):
            raise AssertionError(f"{name} disagrees with the shipped "
                                 f"kernel: {agree[name]}")
    report.append(emit("agreement", variants=agree))

    ms, times = in_turns(runs, args.rounds, lambda r: time_ms(r, args.reps))
    report.append(emit("kernel_ms", reps=args.reps, rounds=args.rounds,
                       median=ms, all=times))

    # What the tiles need, and what a CTA that leaves only at a batch's end
    # walks at each batch size.
    need = evals[2:].to(torch.int64)
    count = tc.to(torch.int64)
    walked = {b: int(torch.minimum(count, (need + b - 1) // b * b).sum())
              for b in (32, 64, 128, 256)}
    report.append(emit(
        "pairs_needed_per_tile", **chip_smoke.visited_histogram(need),
        evaluations=int(evals[0]), needed=int(evals[1]),
        in_stream=int(count.sum()), walked_by_batch=walked,
        tiles_over_1024=int((need > 1024).sum()),
        tiles_unsaturated_over_1024=int(((need == count) & (count > 1024))
                                        .sum()),
        max_count=int(count.max())))

    # The tail: per-SM busy spans, in SM cycles.
    for name in ("v1-clock", "v2-clock"):
        if name in runs:
            report.append(emit("tail", variant=name,
                               **busy_spans(runs[name], clk, args.reps)))


def main_rowsum(args, report: list) -> None:
    first_version = args.first_version or F_FIRST_VERSION
    if not first_version.exists():
        report.append(emit("first_version_missing", path=str(first_version),
                           left_out=["v1"]))
        first_version = None
    libs = build_all(first_version, "rowsum")
    report.append(emit("build", variants={k: v[1] for k, v in libs.items()}))
    rows11, ranks, n_out = captured_backward(args.seed, "rank_rowsum")
    ng, p_len = rows11.shape[0] - 1, rows11.shape[1]
    out = torch.empty((ng, n_out), dtype=torch.float32, device=rows11.device)
    stream = torch.cuda.current_stream(rows11.device).cuda_stream

    def runner(name):
        lib, _ = libs[name]
        a = (rows11.data_ptr(), ranks.data_ptr(), out.data_ptr(), ng, p_len,
             n_out, stream)

        def run():
            rc = lib.sg_rank_rowsum(*a)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return run

    runs = {name: runner(name) for name in libs}
    want = segreduce.rank_rowsum_plain(rows11, ranks, n_out)
    top = float(want.abs().max())
    agree = {}
    for name, run in runs.items():
        if not F_VARIANTS[name][2]:
            continue
        run()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        rel = float(((out - want).abs()
                     / (1e-4 * want.abs() + 1e-5 * top)).max())
        agree[name] = dict(max_abs_err=err, of_tolerance=rel)
        if rel > 1.0:
            raise AssertionError(f"{name} disagrees with the plain version: "
                                 f"{agree[name]} (largest |sum| {top})")
    report.append(emit("agreement", largest_sum=top, variants=agree))
    _in_turns_both(
        runs, args, report,
        bound_ms=chip_smoke.bound(4 * ((ng + 1) * p_len + ng * n_out))[0],
        shape=[ng + 1, p_len, n_out])


def captured_segments(seed: int):
    """Kernel G's arguments at full width, made from the training step's
    rank_rowsum arguments (`chip_smoke.rank_segments`)."""
    return chip_smoke.rank_segments(*captured_backward(seed, "rank_rowsum"))


def _in_turns_both(runs, args, report, **fields):
    """Times on the host's clock and behind a busy card, in turns."""
    ms, host = in_turns(runs, args.rounds, lambda r: time_ms(r, args.reps))
    ms_q, queued = in_turns(runs, args.rounds,
                            lambda r: chip_smoke.time_ms_queued(r, args.reps))
    report.append(emit("kernel_ms", reps=args.reps, rounds=args.rounds,
                       median=ms, median_behind_a_busy_card=ms_q, all=host,
                       all_behind_a_busy_card=queued, **fields))


def main_segsum(args, report: list) -> None:
    first_version = args.first_version or G_FIRST_VERSION
    if not first_version.exists():
        report.append(emit("first_version_missing", path=str(first_version),
                           left_out=["v1"]))
        first_version = None
    libs = build_all(first_version, "segsum")
    report.append(emit("build", variants={k: v[1] for k, v in libs.items()}))
    rows, starts, ends = captured_segments(args.seed)
    c, p_len = rows.shape
    n_seg = starts.shape[0]
    out = torch.empty((c, n_seg), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    blocks = -(-n_seg // 64)          # the most any variant launches
    clk = torch.zeros((blocks, 3), dtype=torch.int64, device=rows.device)

    def runner(name):
        lib, _ = libs[name]
        rc = lib.abl_set(None, clk.data_ptr())
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        a = (rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
             out.data_ptr(), c, p_len, n_seg, stream)

        def run():
            rc = lib.sg_segment_rowsum(*a)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return run

    runs = {name: runner(name) for name in libs}
    want = segreduce.segment_rowsum_plain(rows, starts, ends)
    top = float(want.abs().max())
    agree = {}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        rel = float(((out - want).abs()
                     / (1e-4 * want.abs() + 1e-5 * top)).max())
        agree[name] = dict(max_abs_err=err, of_tolerance=rel)
        if rel > 1.0:
            raise AssertionError(f"{name} disagrees with the plain version: "
                                 f"{agree[name]} (largest |sum| {top})")
    report.append(emit("agreement", largest_sum=top, variants=agree))
    lens = (ends - starts).to(torch.int64)
    covered = int(lens.sum())
    _in_turns_both(runs, args, report, shape=[c, p_len, n_seg],
                   bound_ms=chip_smoke.bound(
                       4 * (c * covered + 2 * n_seg + c * n_seg))[0])
    # The groups' spans (pairs a block walks) and their windows of 128
    # pairs at the shipped group size.
    g = int(re.search(r"constexpr int GROUP = (\d+);",
                      G_SHIPPED.read_text()).group(1))
    nz = lens > 0
    lo = torch.where(nz, starts.to(torch.int64), torch.full_like(lens, 1 << 40))
    hi = torch.where(nz, ends.to(torch.int64), torch.full_like(lens, -1))
    pad = (-n_seg) % g
    lo = torch.cat([lo, lo.new_full((pad,), 1 << 40)]).view(-1, g).amin(1)
    hi = torch.cat([hi, hi.new_full((pad,), -1)]).view(-1, g).amax(1)
    span = (hi - lo).clamp(min=0)
    report.append(emit("spans", groups=int(span.numel()),
                       **chip_smoke.quantiles(span.double()),
                       windows=int(((span + 127) // 128).sum()),
                       empty_groups=int((span == 0).sum())))
    if "v2-clock" in runs:
        report.append(emit("tail", variant="v2-clock",
                           **busy_spans(runs["v2-clock"], clk[:-(-n_seg // g)],
                                        args.reps)))


def main_rowscan(args, report: list) -> None:
    first_version = args.first_version or H_FIRST_VERSION
    if not first_version.exists():
        report.append(emit("first_version_missing", path=str(first_version),
                           left_out=["v1"]))
        first_version = None
    libs = build_all(first_version, "rowscan")
    if "v1" in libs:
        libs["v1"][0].sg_scan_rows.argtypes = H_V1_ARGTYPES
    report.append(emit("build", variants={k: v[1] for k, v in libs.items()}))
    chip_smoke.phase_device()
    calls, _ = chip_smoke.phase_row_scans(args.seed)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for op, x in calls["scan_rows"]:
        m, c = x.shape
        dtype = 0 if x.dtype == torch.int32 else 1
        opc = 0 if op == "add" else 1
        out = torch.empty_like(x)
        rows_per_tile = 256 * (32 // c)
        tiles = -(-m // (256 * (16 // c)))        # the most any variant has
        scratch = torch.zeros(2 + 16 * tiles, dtype=torch.int64, device=dev)
        # The first version's scratch: its three-level tree of totals.
        v1_scratch = torch.empty(2 * tiles * c, dtype=x.dtype, device=dev)
        clk = torch.zeros((tiles, len(H_STATS)), dtype=torch.int64,
                          device=dev)

        def runner(name, x=x, out=out, scratch=scratch, clk=clk,
                   v1_scratch=v1_scratch, m=m, c=c, dtype=dtype, opc=opc):
            lib, _ = libs[name]
            rc = lib.abl_set(None, clk.data_ptr())
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            if name == "v1":
                a = (x.data_ptr(), out.data_ptr(), v1_scratch.data_ptr(), m,
                     c, dtype, opc, stream)
            else:
                a = (x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     scratch.numel(), m, c, dtype, opc, stream)

            def run():
                rc = lib.sg_scan_rows(*a)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            return run

        runs = {name: runner(name) for name in libs}
        want = (scan.cummax_rows(x) if op == "max" else scan.cumsum_rows(x))
        exact = x.dtype == torch.int32 or op == "max"
        # The float32 sum against float64 (torch.cumsum along dim 0 takes
        # about a second here: once per shape).
        ref = want.double() if exact else torch.cumsum(x.double(), 0)
        top = ref.abs().amax(dim=0, keepdim=True)
        agree = {}
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            if not H_VARIANTS[name][2]:
                continue
            same = torch.equal(out, want)
            rel = float(((out.double() - ref).abs() / (1e-5 * top + 1e-6))
                        .max())
            agree[name] = dict(bit_equal_to_shipped=same, of_tolerance=rel)
            if (exact and not same) or rel > 1.0:
                raise AssertionError(f"{name} disagrees: {agree[name]}")
        del ref, top
        report.append(emit("agreement", shape=[m, c], op=op,
                           variants=agree))
        _in_turns_both(runs, args, report, shape=[m, c], op=op,
                       dtype=str(x.dtype),
                       bound_ms=chip_smoke.bound(2 * 4 * x.numel())[0])
        if "v2-stats" in runs:
            clk.zero_()
            runs["v2-stats"]()
            torch.cuda.synchronize()
            n = -(-m // rows_per_tile)
            st = clk[1:n].double().cpu()
            report.append(emit(
                "lookback", shape=[m, c], op=op, tiles=n,
                **{f: chip_smoke.quantiles(st[:, i])
                   for i, f in enumerate(H_STATS)},
                tiles_past_one_round=int((st[:, 2] > 32).sum())))
        del out, scratch, v1_scratch, clk


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(MODES), default="bwd",
                    help="kernel E (bwd), D (fwd), F (rowsum), G (segsum) "
                         "or H (rowscan)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--first-version", type=Path, default=None,
                    help="the kernel's source as it stood before its "
                         "redesign")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the whole report to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_ablation: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    report = []
    {"fwd": main_fwd, "rowsum": main_rowsum, "segsum": main_segsum,
     "rowscan": main_rowscan, "bwd": main_bwd}[args.kernel](args, report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))


def main_bwd(args, report: list) -> None:
    first_version = args.first_version or FIRST_VERSION
    if not first_version.exists():
        report.append(emit("first_version_missing", path=str(first_version),
                           left_out=[k for k, v in VARIANTS.items() if v[0]]))
        first_version = None
    libs = build_all(first_version)
    report.append(emit("build", variants={k: v[1] for k, v in libs.items()}))

    feat, ts, tc, ntx, nc, g_accum, g_t, tfin, ncon, accum = \
        captured_backward(args.seed)
    dev = feat.device
    num_tiles = ts.numel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gdotacc = torch.sum(g_accum * accum, dim=-1)
    nvis = composite.visited_counts(ncon, tc)
    order = heaviest_first(nvis)
    clk = torch.zeros((num_tiles, 3), dtype=torch.int64, device=dev)
    gpair = torch.zeros_like(feat)

    def runner(name):
        lib, _ = libs[name]
        rc = lib.abl_set(order.data_ptr(), clk.data_ptr())
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        last = gdotacc if VARIANTS[name][0] else accum
        a = (feat.data_ptr(), ts.data_ptr(), tc.data_ptr(), num_tiles, ntx,
             nc, 0, None, g_accum.data_ptr(), g_t.data_ptr(),
             tfin.data_ptr(), ncon.data_ptr(), last.data_ptr(),
             gpair.data_ptr(), None, stream)

        def run():
            rc = lib.sg_composite_bwd(*a)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return run

    runs = {name: runner(name) for name in libs}

    # Agreement with the shipped kernel, where a variant is meant to agree.
    want = composite.composite_bwd(feat, ts, tc, ntx, nc, g_accum, g_t, tfin,
                                   ncon, accum)
    top = float(want[:, :10].abs().max())
    agree = {}
    for name, run in runs.items():
        if not VARIANTS[name][2]:
            continue
        gpair.zero_()
        run()
        torch.cuda.synchronize()
        err = float((gpair[:, :10] - want[:, :10]).abs().max())
        rank_ok = bool(torch.equal(gpair[:, 10:], want[:, 10:]))
        agree[name] = dict(max_abs_err=err, of_largest=err / top,
                           rank_row_exact=rank_ok)
        if err > 1e-4 * top or not rank_ok:
            raise AssertionError(f"{name} disagrees with the shipped "
                                 f"kernel: {agree[name]} (largest gradient "
                                 f"{top})")
    report.append(emit("agreement", largest_grad=top, variants=agree))

    # Times, in turns.
    ms, times = in_turns(runs, args.rounds, lambda r: time_ms(r, args.reps))
    report.append(emit("kernel_ms", reps=args.reps, rounds=args.rounds,
                       median=ms, all=times))

    # The wrapper's pieces.
    wrapper = {
        "zeros_like(feat)": lambda: torch.zeros_like(feat),
        "empty_like(feat)": lambda: torch.empty_like(feat),
        "gdotacc": lambda: torch.sum(g_accum * accum, dim=-1),
        "visited_counts": lambda: composite.visited_counts(ncon, tc),
        "heaviest_first(sort)": lambda: heaviest_first(nvis),
        "argsort(int32, unstable)": lambda: torch.argsort(
            nvis, descending=True).to(torch.int32),
        "sort(uint8 key = count / 8)": lambda: torch.sort(
            (nvis.clamp(max=2047) >> 3).to(torch.uint8), descending=True,
            stable=True).indices.to(torch.int32),
    }
    report.append(emit("wrapper_ms", ms={
        k: statistics.median(time_ms(fn, args.reps)
                             for _ in range(args.rounds))
        for k, fn in wrapper.items()}, stream_bytes=feat.numel() * 4))

    # The tail: per-SM busy spans of the first version, in SM cycles.
    if "v1-clock" in runs:
        report.append(emit("tail", **busy_spans(runs["v1-clock"], clk,
                                                args.reps)))

    # Visited pairs a tile.
    report.append(emit("visited_pairs_per_tile",
                       **chip_smoke.visited_histogram(nvis)))


if __name__ == "__main__":
    main()
