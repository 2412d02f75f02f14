"""Where kernel E's time goes: ablations of its first version and the
choices of its redesign, timed on the train path's own backward.

    python3 bwd_ablation.py [--first-version PATH] [--out FILE]

Measurement only; nothing of the port imports it. Needs one CUDA card and
nvcc. It builds the flagship scene of chip_smoke.py, captures the arguments
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
kernel's output (1e-4 of the largest gradient; the rank row exact). The
times of all variants are taken in turns, `--rounds` times over, and the
median is reported. One JSON object per line on stdout; with `--out FILE`
the whole report is also written to FILE.
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
from street_gaussians_ns_tpu_torch.ops import _cuda, composite

OUT_DIR = _cuda.BUILD_DIR / "ablation"
SHIPPED = _cuda.CSRC / "composite_bwd.cu"
FIRST_VERSION = (_cuda.BUILD_DIR / "parent" / "street_gaussians_ns_tpu_torch"
                 / "csrc" / "composite_bwd.cu")

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


def emit(what: str, **fields) -> dict:
    rec = {"what": what, **fields}
    print(json.dumps(rec), flush=True)
    return rec


def replace_once(text: str, old: str, new: str, where: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"{where}: expected these lines once, found them "
                         f"{text.count(old)} times:\n{old}")
    return text.replace(old, new)


def patched(source: Path, switches) -> str:
    """The source with the prelude behind its include and the switches'
    lines replaced."""
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
        for old, new in PATCHES[sw]:
            text = replace_once(text, old, new, f"{source}: {sw}")
    return text


def build_all(first_version: Path | None) -> dict:
    """One nvcc per variant, all started together. Returns name ->
    (ctypes library, ptxas summary); a variant that fails to build is
    reported and left out."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (v1, switches, _) in VARIANTS.items():
        if v1 and first_version is None:
            continue
        source = first_version if v1 else SHIPPED
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(patched(source, switches))
        out = OUT_DIR / f"{name}.so"
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
        lib = ctypes.CDLL(str(out))
        lib.sg_composite_bwd.argtypes = ARGTYPES
        lib.sg_composite_bwd.restype = INT
        lib.abl_set.argtypes = [VP, VP]
        lib.abl_set.restype = INT
        libs[name] = (lib, dict(registers=regs, spill_store_bytes=spills,
                                smem_bytes_max=max(smem)))
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


def captured_backward(seed: int):
    """The arguments of the full-width training step's composite_bwd."""
    chip_smoke.phase_device()
    store, tracks, cfg, rcfg, cam0, _ = chip_smoke.phase_main(seed)
    del store
    state, batch, _ = chip_smoke.phase_train(seed, tracks, cfg, rcfg, cam0)
    calls, _, _ = chip_smoke.capture_train(state, tracks, cfg, rcfg, cam0,
                                           batch)
    (args, _), = calls["composite_bwd"]
    return args


def heaviest_first(nvis: torch.Tensor) -> torch.Tensor:
    """(T,) int32 permutation of the tiles, most visited pairs first."""
    return torch.sort(nvis, descending=True,
                      stable=True).indices.to(torch.int32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--first-version", type=Path, default=FIRST_VERSION,
                    help="composite_bwd.cu as it stood before the redesign")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the whole report to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_ablation: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    report = []
    first_version = args.first_version
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
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, run in runs.items():
            times[name].append(time_ms(run, args.reps))
    ms = {name: statistics.median(v) for name, v in times.items()}
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
        runs["v1-clock"]()
        torch.cuda.synchronize()
        wall_ms = time_ms(runs["v1-clock"], args.reps)
        c = clk.cpu()
        dur = (c[:, 1] - c[:, 0]).double()
        spans = []
        for sm in torch.unique(c[:, 2]).tolist():
            m = c[:, 2] == sm
            spans.append(float(c[m, 1].max() - c[m, 0].min()))
        spans_t = torch.tensor(spans)
        report.append(emit(
            "tail", sms=len(spans), wall_ms=wall_ms,
            span_cycles=dict(min=float(spans_t.min()),
                             mean=float(spans_t.mean()),
                             max=float(spans_t.max())),
            mean_span_over_longest=float(spans_t.mean() / spans_t.max()),
            cta_cycles=dict(sum=float(dur.sum()), mean=float(dur.mean()),
                            max=float(dur.max())),
            mean_ctas_resident_per_sm=float(dur.sum() / spans_t.sum()),
            longest_cta_over_longest_span=float(dur.max() / spans_t.max())))

    # Visited pairs a tile.
    report.append(emit("visited_pairs_per_tile",
                       **chip_smoke.visited_histogram(nvis)))

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
