#!/usr/bin/env python3
"""Where B3's and B8's bf16 window path spends its time: the kernels built whole and with parts out.

    PYTHONPATH=. python3 tools/torch_bf16_split.py [LABEL=CSRC ...]

Builds ``csrc/phase.cu`` (with ``csrc/grid.cuh``) of the port ("new"), and
of each other source directory given (an older commit's ``csrc/``, unpacked
with ``git archive``; a bare path is labelled "old"), in several variants,
each into a library of its own under ``build/bf16_split/``, all ``nvcc`` at
once. A variant is a list of text replacements; it applies those whose old
text the sources hold (the design of the bf16 windows changed, so each part
names its text in every design), and fails if none does:

- ``whole``: the sources as they are;
- ``no tails``: no reference-tile tail is built (the windows add what the
  tail table holds);
- ``no levels``: the doubling levels above the register build are not
  formed (the table passes, or the residue-class walk's levels above g);
- ``no low build``: the levels up to 8 are not built in registers (the
  tables keep what they hold);
- ``no window reads``: each window is its top level alone (no further
  component is read or added);
- ``no distance``: the rotated sample's xr + xi in place of its distance;
- ``fill only``: the four above (tails, levels, low build, window reads)
  out together, leaving the fill, the compares and the epilogue;
- ``no chunks``: the chunk loop runs no chunk (staging and epilogue only);
- for the port's sources only, launch choices changed one at a time: B3's
  runs of 16, B8's runs of 4, and one bf16 instance holding the walks of
  every window length (in place of one for 2N < 64 and one for 2N >= 64).

Every build's ``qtt_bps_idx_bf16`` and ``qtt_bps_fine_bf16`` (the same C
signatures in every design) is timed at the four shapes of the chains'
bf16 paths on 64-QAM with a random-walk carrier phase: B3 at decimated16's
(2 x 2^16, A=64, N=12, T=8192), twostage's coarse search (2 x 2^20, A=16,
N=60, T=16384) and twostage-dec's (2 x 2^17, A=16, N=14, T=8192), and B8
at twostage's fine search (2 x 2^20, B=8, N=14, T=16384, around the bf16
coarse phase of 16 angles, N=60); beside them the whole build's float32
kernels (``qtt_bps_idx``, ``qtt_bps_fine``) at the same shapes. Device times
with the host hidden behind a spacer kernel, in two rounds (builds in order,
then reversed), the lesser printed beside both; every line ends with the
card's name and power limit. Before timing, every whole build and every
changed launch choice is held bit for bit against the bf16 twin
(``ops.phase.bf16_window_sums``) at each shape, and the registers and spills
of its bf16 instances are printed.
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
from qampy_tpu_torch.ops.phase_cuda import _grid_args, bps_fine_plain, bps_search_plain

SPACER_CYCLES = 200_000_000
OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "bf16_split"
# (name, kernel, samples a row, angles or offsets, N, T, repetitions)
SHAPES = (("B3 decimated16", "B3", 2 ** 16, 64, 12, 8192, 40),
          ("B3 twostage coarse", "B3", 2 ** 20, 16, 60, 16384, 20),
          ("B3 twostage-dec coarse", "B3", 2 ** 17, 16, 14, 8192, 40),
          ("B8 twostage fine", "B8", 2 ** 20, 8, 14, 16384, 20))
COARSE_A, COARSE_N = 16, 60     # the coarse search around which B8 searches
# each part's text in the earlier design (table passes) and in the residue-class walk
_NO_TAILS = (
    ("if (b >= j0 + tile + N) break;", "break;"),
    ("for (int i = threadIdx.x >> 5; i < t.nb; i += kBpsThreads / 32) {",
     "for (int i = threadIdx.x >> 5; i < 0; i += kBpsThreads / 32) {"),
    ("for (int v = threadIdx.x; v < kBfLookback * bt.nb; v += kBpsThreads) {",
     "for (int v = threadIdx.x; v < 0; v += kBpsThreads) {"),
)
_NO_LEVELS = (
    ("for (int w = wr; w < top; w *= 2) {", "for (int w = top; w < top; w *= 2) {"),
    ("if (s >= h && m >= h) lv[j][s] = bf_add(", "if (false) lv[j][s] = bf_add("),
)
_NO_LOW = (
    ("for (int g0 = kBfGroup * threadIdx.x; g0 < W; g0 += kBfGroup * kBpsThreads) {",
     "for (int g0 = W; g0 < W; g0 += kBfGroup * kBpsThreads) {"),
    ("    switch (run) {\n        case 1: bf_build<2>(",
     "    switch (run + 1000) {\n        case 1: bf_build<2>("),
)
_NO_READS = (
    ("for (int w = top >> 1; w >= 2; w >>= 1) {", "for (int w = 0; w >= 2; w >>= 1) {"),
    ("        // the components of 2N below top, largest first; offsets in steps of 8 columns\n",
     "        if (false) {\n"),
    ("        if (c < N2 && w.e0 + kBfClass * k >= T)\n",
     "        }\n        if (c < N2 && w.e0 + kBfClass * k >= T)\n"),
)
ABLATIONS = {
    "whole": (),
    "no tails": _NO_TAILS,
    "no levels": _NO_LEVELS,
    "no low build": _NO_LOW,
    "no window reads": _NO_READS,
    "no distance": (
        ("        gen_dists(xr, xi, pts, g.npts, d);",
         "        for (int k = 0; k < C; ++k) d[k] = __fadd_rn(xr[k], xi[k]);"),
        ("for (int k = 0; k < C; ++k) d[k] = grid_dist<KIND>(xr[k], xi[k], g, pts_g);",
         "for (int k = 0; k < C; ++k) d[k] = __fadd_rn(xr[k], xi[k]);"),
    ),
    "fill only": _NO_TAILS + _NO_LEVELS + _NO_LOW + _NO_READS,
    "no chunks": (
        ("for (int a0 = 0; a0 < A; a0 += kBpsChunk) {",
         "for (int a0 = A; a0 < A; a0 += kBpsChunk) {"),
        ("for (int b0 = 0; b0 < B; b0 += C) {", "for (int b0 = B; b0 < B; b0 += C) {"),
    ),
}
# the launch constants of the port's sources, changed one at a time
TUNINGS = {
    "B3 run 16": (("constexpr int kBfMaxRun = 8;", "constexpr int kBfMaxRun = 16;"),),
    "B8 run 4": (("constexpr int kBfFineMaxRun = 8;", "constexpr int kBfFineMaxRun = 4;"),),
    # every walk in both bf16 instances (one instance's code, whatever 2N)
    "one bf16 instance": (("    if constexpr (BF == kBfShort) {\n        switch (t.J) {",
                           "    if (t.J < 3) {\n        switch (t.J) {"),),
}


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def variant_source(csrc, pairs):
    """phase.cu of ``csrc`` with every replacement that applies (every occurrence); raises if none
    does."""
    text = (csrc / "phase.cu").read_text()
    hits = [(a, b) for a, b in pairs if a in text]
    if pairs and not hits:
        raise RuntimeError("no replacement of %s applies to %s" % (pairs, csrc))
    for a, b in hits:
        text = text.replace(a, b)
    return text


def bf16_registers(log):
    """ptxas's register and spill lines of the bf16 instances (``bps_kernel_bf16``,
    ``bps_fine_kernel_bf16``, or the earlier design's window type ``true``)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif (name and re.search(r"bps_(fine_)?kernel(_bf16ILi\dELi[12]E|ILi\dE(Li\dE)?Lb1E)", name)
              and ("Used" in line or "spill" in line)):
            out.append("%s: %s" % (name, line.rpartition(" : ")[2].strip()))
    return out


def build_all(variants):
    """Build every (tag, csrc, replacements) at once; returns {tag: ctypes library}."""
    procs = {}
    for tag, csrc, pairs in variants:
        d = OUT / tag.replace(" ", "_").replace(",", "")
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "phase.cu").write_text(variant_source(csrc, pairs))
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
        for fn in ("qtt_bps_idx_bf16", "qtt_bps_fine_bf16", "qtt_bps_idx", "qtt_bps_fine"):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        libs[tag] = lib
        if tag.endswith("whole") or tag.split(" ", 1)[1] in TUNINGS:
            for line in bf16_registers((d / "build.log").read_text()):
                print("build %s: %s" % (tag, line))
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


def planes(L, dev, seed):
    """Two modes of 64-QAM with a random-walk carrier phase and noise: (grid, er, ei)."""
    rng = np.random.default_rng(seed)
    grid = make_rx_chain(device="cpu").grid
    levels = grid[1] + grid[0] * np.arange(grid[2])
    syms = rng.choice(levels, (2, L)) + 1j * rng.choice(levels, (2, L))
    z = syms * np.exp(1j * np.cumsum(rng.normal(scale=0.01, size=(2, L)), -1))
    z = z + 0.05 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
    return grid, *(torch.as_tensor(np.ascontiguousarray(x).astype(np.float32), device=dev)
                   for x in (z.real, z.imag))


def angle_tables(A, grid, dev):
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    return tuple(torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))


def shape_calls(name, kernel, L, A, N, T, dev, stream):
    """(bf16 call, float32 call, the twin's result) at one shape; a call takes a library."""
    grid, er, ei = planes(L, dev, 1 + L.bit_length())
    gargs, table = _grid_args(grid, dev, None, "torch_bf16_split")
    if kernel == "B3":
        cos_t, sin_t = angle_tables(A, grid, dev)
        out = torch.empty((2, L), dtype=torch.int32, device=dev)

        def call(lib, bf16=True):
            head = (er.data_ptr(), ei.data_ptr(), 2, L, cos_t.data_ptr(), sin_t.data_ptr(), A, N)
            rc = (lib.qtt_bps_idx_bf16(*head, T, *gargs, out.data_ptr(), stream) if bf16 else
                  lib.qtt_bps_idx(*head, *gargs, out.data_ptr(), stream))
            if rc:
                raise RuntimeError("%s: CUDA error %d" % (name, rc))
            return out
        twin = bps_search_plain(er, ei, cos_t, sin_t, grid, N, T)
    else:
        cos1, sin1 = angle_tables(COARSE_A, grid, dev)
        idx = bps_search_plain(er, ei, cos1, sin1, grid, COARSE_N, T)
        ph1 = (-np.pi / 4 + np.pi / 2 / COARSE_A * idx.float()).contiguous()
        cd, sd, d0f, ddf = tph.fine_tables(COARSE_A, A, grid)
        cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
        out = torch.empty_like(ph1)

        def call(lib, bf16=True):
            head = (er.data_ptr(), ei.data_ptr(), ph1.data_ptr(), 2, L, cd.data_ptr(),
                    sd.data_ptr(), A, N)
            tail = (d0f, ddf, out.data_ptr(), stream)
            rc = (lib.qtt_bps_fine_bf16(*head, T, *gargs, *tail) if bf16 else
                  lib.qtt_bps_fine(*head, *gargs, *tail))
            if rc:
                raise RuntimeError("%s: CUDA error %d" % (name, rc))
            return out
        twin = bps_fine_plain(er, ei, ph1, cd, sd, grid, N, d0f, ddf, T)
    call.keep = (er, ei, table)
    return call, twin


def main(argv):
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    variants = [("new " + a, _build.CSRC, r) for a, r in ABLATIONS.items()]
    variants += [("new " + t, _build.CSRC, r) for t, r in TUNINGS.items()]
    for arg in argv[::-1]:
        label, _, path = arg.rpartition("=")
        variants = [((label or "old") + " " + a, pathlib.Path(path).resolve(), r)
                    for a, r in ABLATIONS.items()] + variants
    libs = build_all(variants)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for name, kernel, L, A, N, T, reps in SHAPES:
        call, twin = shape_calls(name, kernel, L, A, N, T, dev, stream)
        for tag, lib in libs.items():
            if tag.endswith("whole") or tag.split(" ", 1)[1] in TUNINGS:
                got = call(lib).clone()
                torch.cuda.synchronize()
                same = bool(torch.equal(got, twin))
                print("%s, %s: bit-equal to the bf16 twin: %s" % (name, tag, same))
                if not same:
                    raise RuntimeError("%s of %s differs from the bf16 twin" % (name, tag))
        calls[name] = (call, reps)
        del twin
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for tag in order:
            for name, (call, reps) in calls.items():
                times.setdefault((tag, name), []).append(
                    device_ms(lambda lib=libs[tag], call=call: call(lib), reps))
                if tag.endswith("whole"):
                    times.setdefault((tag + " float32", name), []).append(
                        device_ms(lambda lib=libs[tag], call=call: call(lib, False), reps))
    for name in calls:
        for tag in [t for t, n in times if n == name]:
            t = times[tag, name]
            print("time %s, %s: %.4f ms (%.4f, %.4f) [%s]" % (name, tag, min(t), *t, card))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
