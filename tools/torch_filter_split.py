#!/usr/bin/env python3
"""Where kernel B2's time goes: the strided MIMO filter built whole and with parts taken out.

    PYTHONPATH=. python3 tools/torch_filter_split.py [LABEL=CSRC ...]

Builds ``csrc/equaliser.cu`` (with ``csrc/grid.cuh``) of the port ("new"),
and of each other source directory given (an older commit's sources,
unpacked with ``git archive``; a bare path is labelled "old"), in several
variants, each into a library of its own under ``build/filter_split/``, all
``nvcc`` at once:

- ``whole``: the sources as they are;
- ``no FMAs``: the tap loop runs no step (the staging, the tap table and
  the stores only);
- ``no staging``: nothing is read from the capture (the FMAs on whatever
  shared memory holds, the tap table and the stores);
- for the port's sources only, ``interleaved``: the capture is read as
  (nmodes, L) complex64 samples and split into planes while it is staged
  (4-byte loads two floats apart, no bulk copies), in place of float32
  planes: the question of ``tools/probe_interleave.py`` on the H100; ``no
  union``: a frame CTA stages its two output modes' windows apart even
  where they overlap; ``no epilogue``: the outputs are not written (a
  compare keeps their sums alive); ``taps ahead``: each chunk loads the
  next chunk's taps; and the launch constants changed one at a time
  (``frames 1 CTA bound``: the frame instances' register bound for one
  resident CTA, ``frames run 6``, ``planes run 10``: an instance that the
  sources do not build, added to the planes entry's table, ``min CTAs
  528``), to
  see which way they move the time. The busiest loop of each B2 instance of
  every whole build is counted from ``cuobjdump -sass``.

Each variant's ``qtt_apply_filter`` and ``qtt_apply_filter_frames`` (the frame
entry without its pilot side output, in sources that have one) are timed at the
paths' shapes: the blind
planes (4, 2^21) with 17 taps and the stride-16 side output, the same
without it, the equaliser's (4, 2^19), and the pilot frame entry over the
pilot capture's (4, 31,981,568) planes with 45 taps, at 240 and 8 frames of
2^16 symbols, the output modes' windows 28 samples apart. Device times with
the host hidden behind a spacer kernel, in two rounds (variants in order,
then reversed), the lesser of the two printed beside both; every line ends
with the card's name and power limit. Before timing, every whole build and
every tuning is held against the plain filter (the frames at 8 frames; at
240 against the first whole build) within ``chip_smoke.py``'s 1e-5 x rms.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops.equaliser_cuda import apply_filter_frames_plain, apply_filter_plain

SPACER_CYCLES = 200_000_000
OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "filter_split"
TOL_FILTER_REL = 1e-5
# the frame entry's C signature before its pilot side output (poff, pstride, npil, pout)
OLD_FRAMES = (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
PILOT_L, FRAME, FRAME_STRIDE = 31_981_568, 2 ** 16, 131_072
# variant: replacements (old text, new text), for B2 before its redesign and as it is now; a
# variant applies those whose old text the sources hold, and at least one; every occurrence
ABLATIONS = {
    "whole": (),
    "no FMAs": (
        ("for (int t = 0; t < ntaps; ++t) {", "for (int t = 0; t < 0; ++t) {"),
        ("    for (int m = 0; m < nmodes; ++m) {\n        const float* xr = x + m * plane;",
         "    for (int m = 0; m < 0; ++m) {\n        const float* xr = x + m * plane;"),
    ),
    "no staging": (
        ("xs[i] = g < L ? P[p * L + g] : 0.f;", "xs[i] = 0.f;"),
        ("xs[i] = (g >= 0 && g < L) ? P[p * L + g] : 0.f;", "xs[i] = 0.f;"),
        ("    stage_windows<1>(xs, seg, P, nmodes, L, wg, wn, woff, &bar, tid, T);", ""),
        ("        stage_windows<1>(xs, prow, P, nmodes, L, g, n, off, &bar, tid, nthreads);", ""),
        ("        stage_windows<2>(xs, prow, P, nmodes, L, g, n, off, &bar, tid, nthreads);", ""),
    ),
}
TUNINGS = {
    "interleaved": (
        ("    return (g >= 0 && g < L) ? P[p * L + g] : 0.f;",
         "    return (g >= 0 && g < L) ? P[((p % nmodes) * L + g) * 2 + p / nmodes] : 0.f;"),
        ("    return (reinterpret_cast<unsigned long long>(P) & 15) == 0 && (L & 3) == 0;",
         "    return false;"),
    ),
    "taps ahead": (
        ("#pragma unroll 1\n            for (int q0 = 0; q0 < nch; q0 += NW) {",
         "float wr[NOUT][4], wi[NOUT][4], nr[NOUT][4], ni[NOUT][4];\n"
         "            chunk_taps<NOUT>(wt + m * wstep, wr, wi);\n"
         "#pragma unroll 1\n            for (int q0 = 0; q0 < nch; q0 += NW) {"),
        ("                        float wr[NOUT][4], wi[NOUT][4];\n"
         "                        chunk_taps<NOUT>(wt + (q * nmodes + m) * wstep, wr, wi);",
         "                        if (q + 1 < nch)\n"
         "                            chunk_taps<NOUT>(wt + ((q + 1) * nmodes + m) * wstep, nr, ni);"),
        ("fma4(j, r, u, v, wr[j][t], wi[j][t]);\n                            }\n                    }",
         "fma4(j, r, u, v, wr[j][t], wi[j][t]);\n                            }\n"
         "                        for (int j = 0; j < NOUT; ++j)\n"
         "                            for (int t = 0; t < C; ++t) wr[j][t] = nr[j][t], wi[j][t] = ni[j][t];\n"
         "                    }"),
    ),
    "frames 1 CTA bound": (("__launch_bounds__(kMaxOut * kFilterThreads, 2)",
                            "__launch_bounds__(kMaxOut * kFilterThreads, 1)"),),
    "frames run 6": (("constexpr int kFrameRuns[] = {10, 6, 2};", "constexpr int kFrameRuns[] = {6, 2};"),
                     ("{apply_filter_frames_kernel<OS, kFrameRuns[0]>, apply_filter_frames_kernel<OS, kFrameRuns[1]>, \\\n"
                      "     apply_filter_frames_kernel<OS, kFrameRuns[2]>}",
                      "{apply_filter_frames_kernel<OS, kFrameRuns[0]>, apply_filter_frames_kernel<OS, kFrameRuns[1]>}")),
    # the planes entry's runs of 10 exist only here: an instance added to its table
    "planes run 10": (("constexpr int kPlanesRuns[] = {6, 2};", "constexpr int kPlanesRuns[] = {10, 6, 2};"),
                      ("{apply_filter_kernel<OS, N, kPlanesRuns[0]>, apply_filter_kernel<OS, N, kPlanesRuns[1]>}",
                       "{apply_filter_kernel<OS, N, kPlanesRuns[0]>, apply_filter_kernel<OS, N, kPlanesRuns[1]>, "
                       "apply_filter_kernel<OS, N, kPlanesRuns[2]>}")),
    "no epilogue": (("            out[((long long)orow * nframes + f) * Lout + k0 + u] = xs[row * tile + u];",
                     "            if (xs[row * tile + u] == 1e30f) out[0] = 0.f;"),
                    ("        for (int u = tid; u < n; u += T) out[row * Lout + i0 + u] = xs[row * tile + u];",
                     "        for (int u = tid; u < n; u += T) if (xs[row * tile + u] == 1e30f) out[0] = 0.f;"),),
    "no union": (("if (nout > 1 && a1 - a0 < seg && a0 - a1 < seg) {", "if (false) {"),),
    "min CTAs 528": (("constexpr int kFilterMinCtas = 264;", "constexpr int kFilterMinCtas = 528;"),),
}
NAMES = ("qtt_apply_filter", "qtt_apply_filter_frames")


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def variant_source(csrc, pairs):
    """equaliser.cu of ``csrc`` with the replacements that apply; raises if none does."""
    text = (csrc / "equaliser.cu").read_text()
    hits = [(a, b) for a, b in pairs if a in text]
    if pairs and not hits:
        raise RuntimeError("no replacement of %s applies to %s" % (pairs, csrc))
    for a, b in hits:
        text = text.replace(a, b)
    return text


def build_all(variants):
    """Build every (tag, csrc, replacements) at once; returns {tag: ctypes library}."""
    procs = {}
    for tag, csrc, pairs in variants:
        d = OUT / tag.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "equaliser.cu").write_text(variant_source(csrc, pairs))
        shutil.copy(csrc / "grid.cuh", d / "grid.cuh")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "equaliser.cu")]
        procs[tag] = (subprocess.Popen(cmd, stdout=(d / "build.log").open("w"),
                                       stderr=subprocess.STDOUT), d)
    rcs = {tag: p.wait() for tag, (p, _) in procs.items()}     # every nvcc has ended
    libs = {}
    for tag, (_, d) in procs.items():
        if rcs[tag] != 0:
            log = (d / "build.log").read_text()
            raise RuntimeError("nvcc failed for %s:\n%s" % (tag, log[-3000:]))
        lib = ctypes.CDLL(str(d / "lib.so"))
        for name in NAMES:
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _build.SIGNATURES[name]
        lib.side = "int poff" in (d / "equaliser.cu").read_text()
        if not lib.side:
            lib.qtt_apply_filter_frames.restype, lib.qtt_apply_filter_frames.argtypes = OLD_FRAMES
        libs[tag] = lib
        log = (d / "build.log").read_text()
        entries = re.findall(r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S)
        mine = [(int(st), int(ld), int(r)) for fn, st, ld, r in entries if "apply_filter" in fn]
        print("build %s: %d B2 instances, registers %s, spill bytes %d"
              % (tag, len(mine), sorted({m[2] for m in mine}), sum(m[0] + m[1] for m in mine)))
        if tag.endswith("whole"):
            print(hot_loops(d / "lib.so", tag))
    return libs


def hot_loops(so, tag):
    """The instruction mix of each B2 instance's busiest loop, from ``cuobjdump -sass``.

    A loop is the span from a backward branch's target to the branch; the
    busiest is the densest in FFMAs of those that hold at least 64.
    """
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    lines = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        if "apply_filter" not in name:
            continue
        ops = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*;", part)]
        spans = [(int(t, 16), int(a, 16)) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA[^;]*?0x([0-9a-f]+)", part)
                 if int(t, 16) < int(a, 16)]
        best = (0, 1)
        for lo, hi in spans:
            body = [op for a, op in ops if lo <= a <= hi]
            if body.count("FFMA") >= 64 and body.count("FFMA") / len(body) > best[0] / best[1]:
                best = (body.count("FFMA"), len(body))
        kernel = re.search(r"(apply_filter\w*?kernel)(?:I(\w+?)EE)?", name)
        lines.append("sass %s %s<%s>: busiest loop %d FFMA of %d instructions; %d in all"
                     % (tag, kernel.group(1),
                        ",".join(re.findall(r"Li(\d+)", kernel.group(2) or "")),
                        best[0], best[1], len(ops)))
    return "\n".join(lines)


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


def taps(dev, nout, nmodes, ntaps, seed):
    """Complex taps, and their two layouts: (2, nout, nmodes, ntaps) planes, which B2 took before
    its redesign, and the complex64 numbers' own floats, which it takes now (libraries with
    ``qtt_filter_plan``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.complex(torch.randn(nout, nmodes, ntaps, generator=g, device=dev),
                      torch.randn(nout, nmodes, ntaps, generator=g, device=dev)) / 8
    return w, {False: torch.stack([w.real, w.imag]).contiguous(), True: torch.view_as_real(w)}


def interleaved_taps(lib):
    """Whether a build of B2 reads the taps as complex64 floats (it has ``qtt_filter_plan``)."""
    return hasattr(lib, "qtt_filter_plan")


def main(argv):
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    new = _build.CSRC
    variants = [("new " + a, new, r) for a, r in ABLATIONS.items()]
    variants += [("new " + t, new, r) for t, r in TUNINGS.items()]
    for arg in argv[::-1]:
        label, _, path = arg.rpartition("=")
        label = label or "old"
        variants = [(label + " " + a, pathlib.Path(path).resolve(), r)
                    for a, r in ABLATIONS.items()] + variants
    libs = build_all(variants)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(9)
    blind = torch.randn(4, 2 ** 21, generator=g, device=dev)
    eqp = torch.randn(4, 2 ** 19, generator=g, device=dev)
    pilot = torch.randn(4, PILOT_L, generator=g, device=dev)
    # the complex64 capture of the interleaved variant: (nmodes, L) samples of the same values
    cplx = {id(P): torch.complex(P[:2], P[2:]).contiguous() for P in (blind, eqp, pilot)}
    w17, wt17 = taps(dev, 2, 2, 17, 1)
    w45, wt45 = taps(dev, 2, 2, 45, 2)
    calls = {}

    def planes_call(name, P, dec, reps):
        Lout = (P.shape[-1] - 17) // 2 + 1
        Ld = -(-Lout // dec) if dec else 0
        out = torch.empty((4, Lout), device=dev)
        outd = torch.empty((4, max(Ld, 1)), device=dev)

        def call(lib, interleaved=False):
            src = torch.view_as_real(cplx[id(P)]) if interleaved else P
            rc = lib.qtt_apply_filter(src.data_ptr(), 2, P.shape[-1],
                                      wt17[interleaved_taps(lib)].data_ptr(), 2, 17, 2,
                                      Lout, out.data_ptr(), dec or 1, Ld,
                                      outd.data_ptr() if dec else None, stream)
            if rc:
                raise RuntimeError("qtt_apply_filter returned CUDA error %d" % rc)
            return (out, outd[:, :Ld]) if dec else (out,)
        ref = apply_filter_plain(P, 2, w17, dec)
        calls[name] = (call, reps, ref if dec else (ref,))

    def frames_call(name, nframes, reps, check):
        offs = (torch.arange(nframes, device=dev)[None] * FRAME_STRIDE
                + torch.tensor([[1035], [1007]], device=dev)).contiguous()
        out = torch.empty((2, 2, nframes, FRAME), device=dev)

        def call(lib, interleaved=False):
            src = torch.view_as_real(cplx[id(pilot)]) if interleaved else pilot
            rc = lib.qtt_apply_filter_frames(src.data_ptr(), 2, PILOT_L,
                                             wt45[interleaved_taps(lib)].data_ptr(),
                                             offs.data_ptr(), 2, nframes, 45, 2, FRAME,
                                             out.data_ptr(),
                                             *((0, 1, 0, None) if lib.side else ()), stream)
            if rc:
                raise RuntimeError("qtt_apply_filter_frames returned CUDA error %d" % rc)
            return (out,)
        ref = (apply_filter_frames_plain(pilot, 2, w45, offs, FRAME),) if check else None
        calls[name] = (call, reps, ref)

    planes_call("blind planes, side output 16", blind, 16, 50)
    planes_call("blind planes, no side output", blind, None, 50)
    planes_call("equaliser planes 2^19", eqp, None, 50)
    frames_call("pilot frames, 8", 8, 20, True)
    frames_call("pilot frames, 240", 240, 10, False)
    first = {}
    for name, (call, _, ref) in calls.items():
        for tag, lib in libs.items():
            kind = tag.split(" ", 1)[1]
            if not (kind == "whole" or kind in TUNINGS):
                continue
            got = call(lib, kind == "interleaved")
            torch.cuda.synchronize()
            want = ref if ref is not None else first.setdefault(name, [x.clone() for x in got])
            rms = float(want[0].pow(2).mean().sqrt())
            d = max(float((a - b).abs().max()) for a, b in zip(got, want))
            print("%s, %s: max|d| %.3e against %s (tol %.0e x rms %.3f)"
                  % (name, tag, d, "the plain filter" if ref is not None else "the first whole "
                     "build", TOL_FILTER_REL, rms))
            if d > TOL_FILTER_REL * rms:
                raise RuntimeError("%s disagrees at %s" % (tag, name))
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for tag in order:
            for name, (call, reps, _) in calls.items():
                il = tag.endswith("interleaved")
                times.setdefault((tag, name), []).append(
                    device_ms(lambda lib=libs[tag], call=call, il=il: call(lib, il), reps))
    for name in calls:
        for tag in libs:
            t = times[tag, name]
            print("time %s, %s: %.4f ms (%.4f, %.4f) [%s]" % (name, tag, min(t), *t, card))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
