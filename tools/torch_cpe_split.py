#!/usr/bin/env python3
"""Where kernel B5 (the pilot CPE coefficients) and B2's pilot side output spend their time.

    PYTHONPATH=. python3 tools/torch_cpe_split.py [LABEL=CSRC ...]

Builds ``csrc/phase.cu`` and ``csrc/equaliser.cu`` (each with
``csrc/grid.cuh``) of the port ("new"), and those of each other directory
given (an older commit's ``csrc/``, unpacked with ``git archive``; a bare
path is labelled "old"), in several variants, each source into a library of
its own under ``build/cpe_split/``, all ``nvcc`` at once:

- ``whole``: the sources as they are;
- B5 ``no atan2``: the lesser of the conjugate product's parts in place of
  its angle (the loads, the scan and the average stay);
- B5 ``no blocks``: no average and no (a, b) computed or written (the
  tile's u is);
- B5 ``256 threads`` / ``1024 threads``: CTAs of that many threads (512
  as built; 4 pilots a thread, a tile of 4 x the threads); ``3 CTAs per
  SM`` / ``4 CTAs per SM``: launch bounds that cap the registers so that
  many CTAs of 512 threads fit an SM (480 rows take one wave at 4);
- B2 ``side bookkeeping, no stores``: the frame entry finds the pilot of
  each thread's run (at a pilot stride of at least a run, one at most) but
  writes none; ``side stored at the output's own address``: each pilot's
  store goes where the epilogue then stores the same output (the same
  instructions, no scattered addresses).
  Earlier states of the sources (the side output stored from the
  epilogue's store loop, or gathered there in shared memory) are measured
  by passing their directories.

Each B5 library's ``qtt_cpe_coeffs`` (the same C signature in every state of
B5) is timed at the pilot dispatch's shape, 480 rows of 2,016 pilots, read
from contiguous rows (the frame filter's pilot side output) and strided from
rows of 2^16 symbols, and at 32 rows of 8,160 pilots (frames of 2^18
symbols); each B2 library's frame entry (``qtt_apply_filter_frames``) at
the pilot dispatch's shape (240 frames of 2 x 2^16 outputs, 45 taps, random
planes of the capture's size) with the pilot side output and without it
(an older B2 has no side output). Device times with the host hidden behind
a spacer kernel, in two rounds (variants in order, then reversed), the
lesser printed beside both; every line ends with the card's name and power
limit. Before timing, every whole build's B5 is held against the plain
version in both forms (the present one must agree; an older one that does
not, as PR 10's at more than 4,096 pilots, is marked), and the new frame
entry's side output against the main output's pilot columns, bit for bit.
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
from qampy_tpu_torch.ops.phase_cuda import INV_TWO_PI, TWO_PI, cpe_coeffs_plain

SPACER_CYCLES = 200_000_000
OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "cpe_split"
SEQ, RAT = 1024, 32
TOL_A, TOL_B = 1e-5, 1e-6                 # chip_smoke.py TOL_CPE_A, TOL_CPE_B
# the frame entry's C signature before its pilot side output
OLD_FRAMES = (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])

ATAN2 = "            ph_s[t + q * kCpeThreads] =\n                atan2f("
THREADS = "constexpr int kCpeThreads = 512;"
BOUNDS = "__global__ void __launch_bounds__(kCpeThreads)\ncpe_coeffs_kernel("
B5_VARIANTS = {
    "whole": (),
    "no atan2": ((ATAN2, "            ph_s[t + q * kCpeThreads] =\n                fminf("),),
    "no blocks": (("        if (p0 < p1) {", "        if (p0 < p1 && nbt < 0) {"),),
    "256 threads": ((THREADS, THREADS.replace("512", "256")),),
    "1024 threads": ((THREADS, THREADS.replace("512", "1024")),),
    "3 CTAs per SM": ((BOUNDS, BOUNDS.replace("(kCpeThreads)", "(kCpeThreads, 3)")),),
    "4 CTAs per SM": ((BOUNDS, BOUNDS.replace("(kCpeThreads)", "(kCpeThreads, 4)")),),
}
SIDE_IF = "            if (rs < R && p >= 0 && p < npil) {"
B2_VARIANTS = {
    "whole": (),
    "side bookkeeping, no stores": ((SIDE_IF, SIDE_IF.replace("p < npil)",
                                                              "p < npil && npil < 0)")),),
    "side stored at the output's own address": (
        ("                pre[p] = zr;\n                pim[p] = zi;",
         "                out[((long long)j * nframes + f) * Lout + k0 + c + rs] = zr;\n"
         "                out[((long long)(nrows + j) * nframes + f) * Lout + k0 + c + rs] = "
         "zi;"),),
}


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def variant_source(csrc, name, change):
    """``name`` of ``csrc`` with ``change`` made; raises where a replacement does not apply."""
    text = (csrc / name).read_text()
    for a, b in change:
        if a not in text:
            raise RuntimeError("%r is not in %s/%s" % (a[:50], csrc, name))
        text = text.replace(a, b, 1)
    return text


def build_all(variants):
    """Build every (tag, csrc, source name, change) at once; returns {tag: ctypes library}."""
    procs = {}
    for tag, csrc, name, change in variants:
        d = OUT / re.sub(r"[^\w]+", "_", tag)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / name).write_text(variant_source(csrc, name, change))
        shutil.copy(csrc / "grid.cuh", d / "grid.cuh")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / name)]
        procs[tag] = (subprocess.Popen(cmd, stdout=(d / "build.log").open("w"),
                                       stderr=subprocess.STDOUT), d, name, csrc)
    libs = {}
    for tag, (p, d, name, csrc) in procs.items():
        if p.wait() != 0:
            log = (d / "build.log").read_text()
            raise RuntimeError("nvcc failed for %s:\n%s" % (tag, log[-3000:]))
        lib = ctypes.CDLL(str(d / "lib.so"))
        if name == "phase.cu":
            fn = lib.qtt_cpe_coeffs
            fn.restype, fn.argtypes = _build.SIGNATURES["qtt_cpe_coeffs"]
        else:
            fn = lib.qtt_apply_filter_frames
            new = "int poff" in (csrc / name).read_text()
            fn.restype, fn.argtypes = _build.SIGNATURES["qtt_apply_filter_frames"] if new \
                else OLD_FRAMES
            lib.side = new
        libs[tag] = lib
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


def cpe_case(dev, rows, npil, seed):
    """B5's arguments at ``rows`` x ``npil`` pilots: (contiguous form, strided form)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    frame = SEQ + RAT * npil
    pil = torch.polar(torch.ones(2, npil, device=dev),
                      (torch.randint(0, 4, (2, npil), generator=g, device=dev) + 0.5) * np.pi / 2)
    walk = torch.cumsum(0.05 * torch.randn(rows, npil, generator=g, device=dev), -1)
    sym = torch.complex(torch.randn(rows, frame, generator=g, device=dev),
                        torch.randn(rows, frame, generator=g, device=dev))
    sym[:, SEQ::RAT] = (pil.repeat_interleave(rows // 2, 0)
                        * torch.polar(torch.ones_like(walk), walk))
    symr, symi = sym.real.contiguous(), sym.imag.contiguous()
    tail = (SEQ // RAT + 1, npil - 2, RAT, 3, SEQ // RAT + npil)
    pr, pi = pil.real.contiguous(), pil.imag.contiguous()
    zr, zi = (x[:, SEQ::RAT].contiguous() for x in (symr, symi))
    return (zr, zi, pr, pi, 0, 1, *tail), (symr, symi, pr, pi, SEQ, RAT, *tail)


def cpe_call(lib, args):
    symr, symi, pr, pi, off, stride, n_head, npts, dx, cpe_avg, nbt = args
    rows = symr.shape[0]
    a = torch.empty((rows, nbt), dtype=torch.float32, device=symr.device)
    b = torch.empty_like(a)

    def run():
        rc = lib.qtt_cpe_coeffs(symr.data_ptr(), symi.data_ptr(), rows, symr.shape[1], off,
                                stride, pr.data_ptr(), pi.data_ptr(), rows // pr.shape[0],
                                pr.shape[1], n_head, npts, dx, cpe_avg, nbt, TWO_PI, INV_TWO_PI,
                                a.data_ptr(), b.data_ptr(), _build.stream_of(symr))
        if rc:
            raise RuntimeError("qtt_cpe_coeffs: CUDA error %d" % rc)
    return run, a, b


def frames_case(dev):
    """The pilot dispatch's frame filter: planes of the capture's size, 240 frame windows."""
    g = torch.Generator(device=dev).manual_seed(5)
    F, nframes, ntaps = 2 ** 16, 240, 45
    P = torch.randn(4, 244 * 2 * F, generator=g, device=dev)
    w = torch.complex(torch.randn(2, 2, ntaps, generator=g, device=dev),
                      torch.randn(2, 2, ntaps, generator=g, device=dev)) / 8
    offs = (torch.arange(nframes, device=dev) * 2 * F + 3038)[None].repeat(2, 1).contiguous()
    return P, torch.view_as_real(w.contiguous()), offs, F, ntaps


def frames_call(lib, case, side):
    P, w, offs, F, ntaps = case
    nframes = offs.shape[1]
    out = torch.empty((2, 2, nframes, F), dtype=torch.float32, device=P.device)
    npil = (F - SEQ) // RAT
    pout = torch.empty((2, 2, nframes, npil), dtype=torch.float32, device=P.device)
    args = [P.data_ptr(), 2, P.shape[-1], w.data_ptr(), offs.data_ptr(), 2, nframes, ntaps, 2, F,
            out.data_ptr()]
    if lib.side:
        args += [SEQ, RAT, npil, pout.data_ptr() if side else None]

    def run():
        rc = lib.qtt_apply_filter_frames(*args, _build.stream_of(P))
        if rc:
            raise RuntimeError("qtt_apply_filter_frames: CUDA error %d" % rc)
    return run, out, pout


def main():
    if not torch.cuda.is_available():
        print("torch_cpe_split: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda")
    dirs = [("new", _build.CSRC)]
    for arg in sys.argv[1:]:
        label, _, path = arg.rpartition("=")
        dirs.append((label or "old", pathlib.Path(path).resolve()))
    variants = [("%s B5 %s" % (label, v), csrc, "phase.cu", ch)
                for label, csrc in dirs for v, ch in B5_VARIANTS.items()
                if v == "whole" or label == "new"]
    variants += [("%s B2 %s" % (label, v), csrc, "equaliser.cu", ch)
                 for label, csrc in dirs for v, ch in B2_VARIANTS.items()
                 if v == "whole" or label == "new"]
    libs = build_all(variants)
    print("built %d libraries under %s [%s]" % (len(libs), OUT, card))
    for tag, _, name, _ in variants:
        log = (OUT / re.sub(r"[^\w]+", "_", tag) / "build.log").read_text()
        kernel = "cpe_coeffs_kernel" if name == "phase.cu" else "apply_filter_frames_kernel"
        found = re.findall(r"Compiling entry function '[^']*%s[^']*'.*?(\d+) bytes spill stores, "
                           r"(\d+) bytes spill loads.*?Used (\d+) registers" % kernel, log, re.S)
        print("build %s: %s, registers %s, spill stores %s bytes"
              % (tag, kernel, [int(f[2]) for f in found], [int(f[0]) for f in found]))

    bench = cpe_case(dev, 480, 2016, 1)
    cases = {"480 x 2016 side output": bench[0], "480 x 2016 strided": bench[1],
             "32 x 8160 side output": cpe_case(dev, 32, 8160, 2)[0]}
    for what, args in cases.items():
        a_p, b_p = cpe_coeffs_plain(*args)
        for tag, lib in libs.items():
            if tag.endswith("B5 whole"):
                run, a, b = cpe_call(lib, args)
                run()
                torch.cuda.synchronize()
                da, db = float((a - a_p).abs().max()), float((b - b_p).abs().max())
                ok = da <= TOL_A and db <= TOL_B           # false for a NaN as well
                print("check %s (%s): max|da| %.3e, max|db| %.3e%s [%s]"
                      % (tag, what, da, db, "" if ok else ": DISAGREES, its time below is "
                         "not of this function", card))
                if not ok and tag.startswith("new "):
                    raise RuntimeError("%s disagrees with the plain B5 (%s)" % (tag, what))
    fcase = frames_case(dev)
    for tag, lib in libs.items():
        if tag == "new B2 whole":
            run, out, pout = frames_call(lib, fcase, True)
            run()
            torch.cuda.synchronize()
            same = torch.equal(pout, out[..., SEQ::RAT])
            print("check %s: side output bit-equal to the pilot columns: %s [%s]"
                  % (tag, same, card))
            if not same:
                raise RuntimeError("the side output is not the pilot columns")

    timings = []
    for what, args in cases.items():
        for tag, lib in libs.items():
            if "B5" in tag:
                timings.append(("B5 %s: %s" % (what, tag), cpe_call(lib, args)[0], 50))
    for tag, lib in libs.items():
        if "B2" in tag:
            for side in ((True, False) if lib.side else (False,)):
                timings.append(("B2 frames %s: %s" % ("with the side output" if side else
                                                      "without a side output", tag),
                                frames_call(lib, fcase, side)[0], 20))
    rounds = [{}, {}]
    for r, order in enumerate((timings, timings[::-1])):
        for name, fn, reps in order:
            rounds[r][name] = device_ms(fn, reps)
    for name, _, _ in timings:
        t0, t1 = rounds[0][name], rounds[1][name]
        print("time %s: %.4f ms (rounds %.4f, %.4f) [%s]" % (name, min(t0, t1), t0, t1, card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
