#!/usr/bin/env python3
"""Where kernel B3's time goes: the blind phase search built whole and with parts taken out.

    PYTHONPATH=. python3 tools/torch_bps_split.py [LABEL=CSRC ...]

Builds ``csrc/phase.cu`` (with ``csrc/grid.cuh``) of the port ("new"), and
of each other source directory given (an older commit's sources, unpacked
with ``git archive``; a bare path is labelled "old"), in several variants,
each into a library of its own under ``build/bps_split/``, all ``nvcc`` at
once:

- ``whole``: the sources as they are;
- ``no window sums``: each position reads one distance per angle instead of
  summing its window;
- ``no distance``: the rotated sample's xr + xi in place of its distance to
  the constellation (the rotation stays);
- for the port's sources only, the launch constants changed one at a time
  (``chunk 2``, ``chunk 8``, ``threads 256``, ``run 8``, ``gen run 16``,
  ``gen run 4``, ``unroll 1``), to see which way they move the time.

Each variant's ``qtt_bps_idx`` (the same C signature in every state of B3)
is timed on 2 x 2^20 samples: 64-QAM at the single chain's shape (64
angles, N = 14) and at the twostage chain's coarse shape (16 angles, N =
60), and the warped 64-point alphabet at 64 angles, N = 14. Device times
with the host hidden behind a spacer kernel, in two rounds (variants in
order, then reversed), the lesser of the two printed beside both; every
line ends with the card's name and power limit. Before timing, every whole
build is held against the plain search off near-ties (``chip_smoke.py``'s
rules) at each shape.
"""
import ctypes
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.phase_cuda import _grid_args
from qampy_tpu_torch.workload import warped_qam

SPACER_CYCLES = 200_000_000
OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "bps_split"
L = 2 ** 20
# (name, alphabet, angles, N, repetitions)
SHAPES = (("single, 64-QAM", "sq", 64, 14, 20), ("twostage coarse, 64-QAM", "sq", 16, 60, 20),
          ("single, warped 64", "w64", 64, 14, 5))
TIES = {"sq": (1e-5, 1e-3), "w64": (1e-6, 2e-2)}     # chip_smoke.py TIE_REL(_GEN), TIES_MAX(_GEN)
# variant: replacements (old text, new text), for B3 as PR 6 left it and as it is now; a
# variant applies those whose old text the sources hold, and at least one
ABLATIONS = {
    "whole": (),
    "no window sums": (
        ("for (int n = 0; n < N2; ++n) acc += d[n];", "acc = d[0];"),
        ("bps_run_sums(tab, sh, p0, run, N2, a0, na, bs, bi);",
         "for (int k = 0; k < na; ++k) { const float v = tab[bps_pad(p0, sh)].v[k]; "
         "if (v < bs[0]) { bs[0] = v; bi[0] = a0 + k; } }"),
    ),
    "no distance": (
        ("dist[q] = grid_dist<KIND>(xr, xi, g, pts);", "dist[q] = __fadd_rn(xr, xi);"),
        ("d.v[k] = grid_dist<KIND>(xr[k], xi[k], g, nullptr);",
         "d.v[k] = __fadd_rn(xr[k], xi[k]);"),
        ("gen_dists(xr, xi, pts, g.npts, d.v);",
         "for (int k = 0; k < kBpsChunk; ++k) d.v[k] = __fadd_rn(xr[k], xi[k]);"),
        # B3's and B8's fills sharing chunk_dists
        ("        gen_dists(xr, xi, pts, g.npts, d);",
         "        for (int k = 0; k < C; ++k) d[k] = __fadd_rn(xr[k], xi[k]);"),
        ("for (int k = 0; k < C; ++k) d[k] = grid_dist<KIND>(xr[k], xi[k], g, pts_g);",
         "for (int k = 0; k < C; ++k) d[k] = __fadd_rn(xr[k], xi[k]);"),
    ),
}
TUNINGS = {
    "chunk 2": (("constexpr int kBpsChunk = 4;", "constexpr int kBpsChunk = 2;"),),
    "chunk 8": (("constexpr int kBpsChunk = 4;", "constexpr int kBpsChunk = 8;"),),
    "threads 256": (("constexpr int kBpsThreads = 128;", "constexpr int kBpsThreads = 256;"),),
    "run 8": (("constexpr int kBpsMaxRun = 16;", "constexpr int kBpsMaxRun = 8;"),),
    "gen run 16": (("constexpr int kBpsMaxRunGen = 8;", "constexpr int kBpsMaxRunGen = 16;"),),
    "gen run 4": (("constexpr int kBpsMaxRunGen = 8;", "constexpr int kBpsMaxRunGen = 4;"),),
    "unroll 1": (("constexpr int kUnroll = KIND == kGen ? 1 : 2;", "constexpr int kUnroll = 1;"),),
}
ARGTYPES = _build.SIGNATURES["qtt_bps_idx"][1]


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def variant_source(csrc, pairs):
    """phase.cu of ``csrc`` with the replacements that apply; raises if none does."""
    text = (csrc / "phase.cu").read_text()
    hits = [(a, b) for a, b in pairs if a in text]
    if pairs and not hits:
        raise RuntimeError("no replacement of %s applies to %s" % (pairs, csrc))
    for a, b in hits:
        text = text.replace(a, b, 1)
    return text


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
        lib.qtt_bps_idx.restype = ctypes.c_int
        lib.qtt_bps_idx.argtypes = ARGTYPES
        libs[tag] = lib
        regs = [line.strip() for line in (d / "build.log").read_text().splitlines()
                if "Used" in line and "registers" in line]
        print("build %s: %s" % (tag, "; ".join(regs[:3])))
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
    """Two modes of 64-QAM or of the warped alphabet, random-walk carrier phase and noise."""
    rng = np.random.default_rng(seed)
    if key == "sq":
        grid = make_rx_chain(device="cpu").grid
        levels = grid[1] + grid[0] * np.arange(grid[2])
        syms = rng.choice(levels, (2, L)) + 1j * rng.choice(levels, (2, L))
        noise = 0.05
    else:
        const = warped_qam(64)
        grid = tph.detect_grid(const)
        syms = const[rng.integers(0, const.size, (2, L))]
        noise = 0.045
    z = syms * np.exp(1j * np.cumsum(rng.normal(scale=0.01, size=(2, L)), -1))
    z = z + noise * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
    return grid, *(torch.as_tensor(np.ascontiguousarray(x).astype(np.float32), device=dev)
                   for x in (z.real, z.imag))


def main(argv):
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    new = _build.CSRC
    variants = [("new " + a, new, r) for a, r in ABLATIONS.items()]
    variants += [("new " + t, new, r) for t, r in TUNINGS.items()]
    for arg in argv[::-1]:
        label, _, path = arg.rpartition("=")
        src = pathlib.Path(path).resolve()
        label = label or "old"
        variants = [(label + " " + a, src, r) for a, r in ABLATIONS.items()] + variants
    libs = build_all(variants)
    stream = torch.cuda.current_stream(dev).cuda_stream
    data = {key: planes(key, dev, seed) for key, seed in (("sq", 1), ("w64", 2))}
    calls = {}
    for name, key, A, N, reps in SHAPES:
        grid, er, ei = data[key]
        ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
        cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
        gargs, table = _grid_args(grid, dev, None, "torch_bps_split")
        out = torch.empty((2, L), dtype=torch.int32, device=dev)

        def call(lib, er=er, ei=ei, cos_t=cos_t, sin_t=sin_t, A=A, N=N, gargs=gargs, out=out,
                 table=table):
            rc = lib.qtt_bps_idx(er.data_ptr(), ei.data_ptr(), 2, L, cos_t.data_ptr(),
                                 sin_t.data_ptr(), A, N, *gargs, out.data_ptr(), stream)
            if rc:
                raise RuntimeError("qtt_bps_idx returned CUDA error %d" % rc)
            return out

        calls[name] = (call, reps)
        ref = tph.bps_idx_planes(er, ei, cos_t, sin_t, grid, N)
        rel, share_max = TIES[key]
        ties = tph.bps_near_ties(er, ei, cos_t, sin_t, grid, N, rel)
        share = float(ties.double().mean())
        whole = {}
        for tag, lib in libs.items():
            if not (tag.endswith("whole") or tag.split(" ", 1)[1] in TUNINGS):
                continue
            got = call(lib).clone()
            torch.cuda.synchronize()
            off = int(((got != ref) & ~ties).sum())
            whole[tag] = got
            print("%s, %s: %d positions differ from the plain search, %d off near-ties "
                  "(near-tie share %.2e, max %.0e)" % (name, tag, int((got != ref).sum()), off,
                                                       share, share_max))
            if off or share > share_max:
                raise RuntimeError("%s disagrees with the plain search off near-ties" % tag)
        for tag in whole:
            if tag != "new whole":
                print("%s: %s and new whole builds differ at %d positions"
                      % (name, tag, int((whole[tag] != whole["new whole"]).sum())))
        del ref, ties
        torch.cuda.empty_cache()
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for tag in order:
            for name, (call, reps) in calls.items():
                times.setdefault((tag, name), []).append(
                    device_ms(lambda lib=libs[tag], call=call: call(lib), reps))
    for name in calls:
        for tag in libs:
            t = times[tag, name]
            print("time %s, %s: %.4f ms (%.4f, %.4f) [%s]" % (name, tag, min(t), *t, card))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
