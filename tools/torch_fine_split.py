#!/usr/bin/env python3
"""Where kernels B8 (fine phase search) and B7 (pi/2 unwrap and derotation) spend their time.

    PYTHONPATH=. python3 tools/torch_fine_split.py [LABEL=CSRC ...]

Builds ``csrc/phase.cu`` (with ``csrc/grid.cuh``) of the port ("new"), and
the whole sources of each other directory given (an older commit's
``csrc/``, unpacked with ``git archive``; a bare path is labelled "old"),
in several variants, each into a library of its own under
``build/fine_split/``, all ``nvcc`` at once:

- ``whole``: the sources as they are;
- B8 ``no window sums``: each position reads one distance per offset
  instead of summing its window;
- B8 ``no distance``: the rotated sample's real part in place of its
  distance to the constellation (the angle addition stays);
- B8 ``no fill``: no distance table is filled (the sums read what is there);
- B8 ``run 4``, ``run 16`` and ``gen run 4``, ``gen run 16``: the longest
  run of positions per thread (8 on every kind, as built) changed; ``staging
  not unrolled``: the staging loop without its unroll by 4;
- B7 ``no look-back``: every tile takes 0 as its predecessors' sum (the
  single pass without its scan across CTAs: the apply alone);
- B7 ``three launches``: the counts, the scan of the tile totals and the
  apply in three launches, each with the single pass's 16-byte accesses
  (the phase read twice);
- B7 ``items 8`` (consecutive samples per thread, 4 as built), ``256
  threads`` per CTA (512 as built), ``ticket first`` (the tile loaded only
  once its ticket is back, not the launch index's tile while it comes),
  ``backoff`` (a 100 ns sleep between reads of a status word not yet
  published), ``4 CTAs per SM`` (the launch bounds' register bound for 4
  resident CTAs of 512 threads, 3 as built).

Each variant's ``qtt_bps_fine`` and ``qtt_unwrap_derotate`` (the same C
signatures in every state of B8 and B7) is timed on 2 x 2^20
samples: B8 at the twostage chain's shape (8 offsets, N = 14, around a
coarse phase from 16 angles) on 64-QAM, cross 32-QAM and 32-APSK, and B7 on
the twostage phase of 64-QAM. Device times with the host hidden behind a
spacer kernel, in two rounds (variants in order, then reversed), the lesser
printed beside both; every line ends with the card's name and power limit.
Before timing, every whole build's B8 is held against the plain fine stage
off near-ties, and the new B7 (single pass and three launches) against its
own B6 rotating by the plain unwrap, bit for bit (an older B7 is reported).
"""
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.phase_cuda import (HALF_PI, INV_HALF_PI, _grid_args, bps_fine_plain,
                                            quarter_unwrap)
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.workload import apsk_const

SPACER_CYCLES = 200_000_000
OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "fine_split"
L = 2 ** 20
B, N, A1, N1 = 8, 14, 16, 60          # the twostage chain's fine and coarse stages
TIES = {"sq": (1e-5, 1e-3), "x32": (1e-5, 1e-3), "apsk": (1e-6, 2e-2)}   # chip_smoke.py
# B7's three-launch form, made from the single pass's kernel text (see three_launches)
SCAN3 = r'''
__global__ void unwrap_scan3(int ntiles, unsigned long long* __restrict__ scratch) {
    __shared__ int warp_sum[32];
    unsigned long long* t = scratch + gridDim.x + (long long)blockIdx.x * ntiles;
    const int per = (ntiles + blockDim.x - 1) / blockDim.x;
    const int first = threadIdx.x * per;
    int own = 0;
    for (int q = 0; q < per; ++q)
        if (first + q < ntiles) own += (int)(unsigned)t[first + q];
    int run = block_exclusive_scan(own, warp_sum, nullptr);
    for (int q = 0; q < per; ++q) {
        if (first + q < ntiles) {
            const int v = (int)(unsigned)t[first + q];
            t[first + q] = (unsigned)run;
            run += v;
        }
    }
}
'''
LAUNCH = ("unwrap_kernel<<<grid, kUnwrapThreads, 0, (cudaStream_t)stream>>>(\n"
          "        er, ei, ph, L, phase, half_pi, inv_half_pi, ntiles, scratch, outr, outi);")
LAUNCH3 = ("unwrap_count3<<<grid, kUnwrapThreads, 0, (cudaStream_t)stream>>>(\n"
           "        er, ei, ph, L, phase, half_pi, inv_half_pi, ntiles, scratch, outr, outi);\n"
           "    unwrap_scan3<<<rows, 1024, 0, (cudaStream_t)stream>>>(ntiles, scratch);\n"
           "    unwrap_apply3<<<grid, kUnwrapThreads, 0, (cudaStream_t)stream>>>(\n"
           "        er, ei, ph, L, phase, half_pi, inv_half_pi, ntiles, scratch, outr, outi);")
B7_BOUNDS = "__global__ void __launch_bounds__(kUnwrapThreads)\n    unwrap_kernel("
TICKET = "    if (threadIdx.x == 0) shared_int = (int)atomicAdd(scratch + blockIdx.y, 1ull);\n"
T_LINE = "    const int t = shared_int;"
PREFETCH = "    load(blockIdx.x);\n"
RELOAD = "    if (t != (int)blockIdx.x) load(t);"
PUBLISH = "    if (threadIdx.x < 32) {"
APPLY = "    int M = shared_int + in_tile;"


def three_launches(text):
    """phase.cu with B7 in three launches: a count kernel and an apply kernel cut from the
    single pass (tile = blockIdx.x; the count publishes the tile total and stops, the apply
    reads its scanned offset), and SCAN3 between them."""
    start = text.index("__global__ void __launch_bounds__(kUnwrapThreads)\n    unwrap_kernel(")
    end = text.index("\n}\n", start) + 3
    kernel = text[start:end].replace(TICKET, "").replace(T_LINE, "    const int t = blockIdx.x;")
    pub = kernel.index(PUBLISH)
    count = (kernel[:pub].replace("unwrap_kernel(", "unwrap_count3(")
             + "    if (threadIdx.x == 0) status[t] = (unsigned)total;\n}\n")
    apply = (kernel[:pub].replace("unwrap_kernel(", "unwrap_apply3(")
             + "    int M = (int)(unsigned)status[t] + in_tile;"
             + kernel[kernel.index(APPLY) + len(APPLY):])
    for needle in (TICKET, T_LINE, PUBLISH, APPLY, LAUNCH):
        if needle not in text:
            raise RuntimeError("three launches: %r is not in phase.cu" % needle[:40])
    return text[:end] + count + SCAN3 + apply + text[end:].replace(LAUNCH, LAUNCH3)


# variant: replacements (old text, new text), or a function of the text
ABLATIONS = {
    "whole": (),
    "no window sums": (
        ("bps_run_sums(tab, sh, p0, run, N2, b0, nb, bs, bi);",
         "for (int k = 0; k < nb; ++k) { const float v = tab[bps_pad(p0, sh)].v[k]; "
         "if (v < bs[0]) { bs[0] = v; bi[0] = b0 + k; } }"),
    ),
    "no distance": (
        ("chunk_dists<KIND>(z.x, z.y, ca, sa, g, pts, pts_g, d.v);",
         "for (int k = 0; k < C; ++k) d.v[k] = __fsub_rn(__fmul_rn(z.x, ca[k]), "
         "__fmul_rn(z.y, sa[k]));"),
    ),
    "no fill": (
        ("            const float4 z = kStaged ? xs[u] : sample(u);",
         "            if (u >= 0) break;\n"
         "            const float4 z = kStaged ? xs[u] : sample(u);"),
    ),
    "no look-back": (("excl = unwrap_look_back(status, t);", "excl = 0;"),),
    "three launches": three_launches,
}
TUNINGS = {
    "run 4": (("constexpr int kFineMaxRun = 8;", "constexpr int kFineMaxRun = 4;"),),
    "run 16": (("constexpr int kFineMaxRun = 8;", "constexpr int kFineMaxRun = 16;"),),
    "gen run 4": (("constexpr int kFineMaxRunGen = 8;", "constexpr int kFineMaxRunGen = 4;"),),
    "gen run 16": (("constexpr int kFineMaxRunGen = 8;", "constexpr int kFineMaxRunGen = 16;"),),
    "staging not unrolled": (("#pragma unroll 4\n        for (int u = threadIdx.x; u < W; u += "
                              "kBpsThreads) xs[u] = sample(u);",
                              "for (int u = threadIdx.x; u < W; u += kBpsThreads) xs[u] = "
                              "sample(u);"),),
    "B7 items 8": (("constexpr int kUnwrapItems = 4;", "constexpr int kUnwrapItems = 8;"),),
    "B7 256 threads": (("constexpr int kUnwrapThreads = 512;",
                        "constexpr int kUnwrapThreads = 256;"),),
    "B7 ticket first": ((PREFETCH, ""), (RELOAD, "    load(t);")),
    "B7 backoff": (("            } while ((w >> 32) == 0);",
                    "                if ((w >> 32) == 0) __nanosleep(100);\n"
                    "            } while ((w >> 32) == 0);"),),
    "B7 4 CTAs per SM": ((B7_BOUNDS,
                          B7_BOUNDS.replace("(kUnwrapThreads)", "(kUnwrapThreads, 4)")),),
}


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def variant_source(csrc, change):
    """phase.cu of ``csrc`` with ``change`` made; raises where a replacement does not apply."""
    text = (csrc / "phase.cu").read_text()
    if callable(change):
        return change(text)
    for a, b in change:
        if a not in text:
            raise RuntimeError("%r is not in %s/phase.cu" % (a[:50], csrc))
        text = text.replace(a, b, 1)
    return text


def build_all(variants):
    """Build every (tag, csrc, change) at once; returns {tag: ctypes library}."""
    procs = {}
    for tag, csrc, change in variants:
        d = OUT / re.sub(r"[^\w]+", "_", tag)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "phase.cu").write_text(variant_source(csrc, change))
        shutil.copy(csrc / "grid.cuh", d / "grid.cuh")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "phase.cu")]
        procs[tag] = (subprocess.Popen(cmd, stdout=(d / "build.log").open("w"),
                                       stderr=subprocess.STDOUT), d)
    libs = {}
    for tag, (p, d) in procs.items():
        if p.wait() != 0:
            log = (d / "build.log").read_text()
            raise RuntimeError("nvcc failed for %s:\n%s" % (tag, log[-3000:]))
        lib = ctypes.CDLL(str(d / "lib.so"))
        for name in ("qtt_bps_fine", "qtt_unwrap_derotate", "qtt_unwrap_tiles", "qtt_rotate"):
            getattr(lib, name).restype, getattr(lib, name).argtypes = _build.SIGNATURES[name]
        libs[tag] = lib
        log = (d / "build.log").read_text()
        regs = re.findall(r"Compiling entry function '(\S*(?:bps_fine|unwrap)\S*)'.*?Used (\d+) "
                          r"registers", log, re.S)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print("build %s: B8/B7 registers %s; spill stores up to %s"
              % (tag, sorted({int(r) for _, r in regs}), max(map(int, spills or [0]))))
    return libs


def device_ms(fn, reps):
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPACER_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def planes(key, dev, seed):
    """Two modes of 64-QAM, cross 32-QAM or 32-APSK, random-walk carrier phase and noise."""
    rng = np.random.default_rng(seed)
    if key == "sq":
        const = (cal_symbols_qam(64) / np.sqrt(cal_scaling_factor_qam(64))).astype(np.complex64)
        grid = make_rx_chain(device="cpu").grid
    elif key == "x32":
        const = (cal_symbols_qam(32) / np.sqrt(cal_scaling_factor_qam(32))).astype(np.complex64)
        grid = tph.detect_grid(const)
    else:
        const = apsk_const(32)
        grid = tph.detect_grid(const)
    z = const[rng.integers(0, const.size, (2, L))] * np.exp(
        1j * np.cumsum(rng.normal(scale=0.01, size=(2, L)), -1))
    z = z + 0.045 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
    er, ei = (torch.as_tensor(np.ascontiguousarray(x).astype(np.float32), device=dev)
              for x in (z.real, z.imag))
    ang = np.linspace(-np.pi / 4, np.pi / 4, A1, endpoint=False, dtype=np.float32)
    cos1, sin1 = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    ph1 = (-np.pi / 4 + np.pi / 2 / A1 * tph.bps_idx_planes(er, ei, cos1, sin1, grid, N1)
           .float()).contiguous()
    return grid, er, ei, ph1


def main(argv):
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    new = _build.CSRC
    variants = [("new " + a, new, r) for a, r in {**ABLATIONS, **TUNINGS}.items()]
    for arg in argv[::-1]:
        label, _, path = arg.rpartition("=")
        variants.insert(0, ((label or "old") + " whole", pathlib.Path(path).resolve(), ()))
    libs = build_all(variants)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for key, name in (("sq", "B8 twostage, 64-QAM"), ("x32", "B8 twostage, cross 32"),
                      ("apsk", "B8 twostage, 32-APSK")):
        grid, er, ei, ph1 = planes(key, dev, 1)
        cd, sd, d0f, ddf = tph.fine_tables(A1, B, grid)
        cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
        gargs, table = _grid_args(grid, dev, None, "torch_fine_split")
        out = torch.empty_like(ph1)

        def call(lib, er=er, ei=ei, ph1=ph1, cd=cd, sd=sd, gargs=gargs, out=out, table=table,
                 d0f=d0f, ddf=ddf):
            rc = lib.qtt_bps_fine(er.data_ptr(), ei.data_ptr(), ph1.data_ptr(), 2, L,
                                  cd.data_ptr(), sd.data_ptr(), B, N, *gargs, d0f, ddf,
                                  out.data_ptr(), stream)
            if rc:
                raise RuntimeError("qtt_bps_fine returned CUDA error %d" % rc)
            return out

        calls[name] = (call, 20 if key != "apsk" else 10, "bps_fine")
        args = (er, ei, ph1, cd, sd, grid, N, d0f, ddf)
        ref = bps_fine_plain(*args)
        rel, share_max = TIES[key]
        ties = tph.bps_fine_near_ties(*args[:7], rel)
        share = float(ties.double().mean())
        for tag, lib in libs.items():
            if not (tag.endswith("whole") or tag.split(" ", 1)[1] in TUNINGS) or "B7 " in tag:
                continue
            got = call(lib).clone()
            off = int(((got != ref) & ~ties).sum())
            print("%s, %s: %d phases differ from the plain stage, %d off near-ties (near-tie "
                  "share %.2e, max %.0e)" % (name, tag, int((got != ref).sum()), off, share,
                                            share_max))
            if off or share > share_max:
                raise RuntimeError("%s disagrees with the plain stage off near-ties" % tag)
        if key == "sq":
            ph = ref
        del ref, ties
        torch.cuda.empty_cache()
    # B7 on the twostage phase of 64-QAM
    grid, er, ei, _ = planes("sq", dev, 1)
    outr, outi = torch.empty_like(er), torch.empty_like(ei)

    def unwrap(lib, er=er, ei=ei, ph=ph, outr=outr, outi=outi):
        scratch = torch.zeros(2 + 2 * lib.qtt_unwrap_tiles(L), dtype=torch.int64, device=dev)
        rc = lib.qtt_unwrap_derotate(er.data_ptr(), ei.data_ptr(), ph.data_ptr(), 2, L, HALF_PI,
                                     INV_HALF_PI, scratch.data_ptr(), outr.data_ptr(),
                                     outi.data_ptr(), stream)
        if rc:
            raise RuntimeError("qtt_unwrap_derotate returned CUDA error %d" % rc)
        return outr, outi

    calls["B7, twostage phase of 64-QAM"] = (unwrap, 50, "unwrap")
    u = quarter_unwrap(ph)
    for tag, lib in libs.items():
        if not (tag.endswith("whole") or tag.endswith("three launches") or "B7 " in tag):
            continue
        r, i = (x.clone() for x in unwrap(lib))
        r6, i6 = torch.empty_like(r), torch.empty_like(i)
        lib.qtt_rotate(er.data_ptr(), ei.data_ptr(), u.data_ptr(), u.numel(), 1, r6.data_ptr(),
                       i6.data_ptr(), stream)
        same = bool(torch.equal(r, r6) and torch.equal(i, i6))
        print("B7, %s: equal to its B6 rotating by the plain unwrap: %s" % (tag, same))
        if not same and tag.startswith("new"):
            raise RuntimeError("%s: B7 differs from B6 on the plain unwrap" % tag)
    b8_only = ("no window sums", "no distance", "no fill",
               *(t for t in TUNINGS if not t.startswith("B7")))
    b7_only = ("no look-back", "three launches", *(t for t in TUNINGS if t.startswith("B7")))
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for tag in order:
            variant = tag.split(" ", 1)[1]
            for name, (call, reps, what) in calls.items():
                if (what == "unwrap" and variant in b8_only) or (
                        what == "bps_fine" and variant in b7_only):
                    continue
                times.setdefault((tag, name), []).append(
                    device_ms(lambda lib=libs[tag], call=call: call(lib), reps))
    for name in calls:
        for tag in libs:
            if (tag, name) in times:
                t = times[tag, name]
                print("time %s, %s: %.4f ms (%.4f, %.4f) [%s]" % (name, tag, min(t), *t, card))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
