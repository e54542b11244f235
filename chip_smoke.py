#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's receivers once on one CUDA card and check them.

Run from the repository root, with one card visible: ``python3 chip_smoke.py``.

Phases, each fatal on failure (the script then exits non-zero and prints no
result line):

1. device: a CUDA card must be present (no CPU fallback); prints its name
   and ``nvidia-smi``'s name and power limit;
2. build: compiles the kernels (B1-B9, B2's frame entry and the latency
   probe) from ``qampy_tpu_torch/csrc``, one ``nvcc`` per source; then the
   probe (``csrc/probe.cu``): the card's latencies of a dependent add, a
   shuffle and add, rde's register lookup and a CTA barrier, from which the
   chain bounds of the two trainers are reckoned, and B9's straight-line
   division against ``__fdiv_rn`` on 2^22 operand pairs (none may differ);
3. blind kernels: B1-B4 against their plain PyTorch versions on the card, at
   the blind path's shapes, with the stated tolerance;
4. blind main path: ``workload.make_tx(2**20)`` through ``RxChain.planes``
   with the bench configuration; SER gate <= 1e-5, launch counts B1=2, B2=1,
   B3=1, B4=1 for that one call, and agreement with the plain chain on the
   CPU on a small capture;
5. blind tracking: ``tracking_planes`` with the chain's own taps equals the
   full output exactly;
6. blind times (CUDA events after warm-up): the chain and the tracking entry
   with their Msym/s as a caller sees them (back-to-back calls, host
   dispatch included), then the device time of each stage and of each
   kernel beside its plain version (calls queued behind a spacer kernel,
   host hidden);
7. per-sample kernels: on the same capture and taps, B2 without its side
   output, B3 at the twostage coarse (16 angles, N=60) and single (64, N=14)
   shapes, B8 and B7 against their plain versions at 2 x 2^20 samples;
8. blind twostage and blind single: the bench's attempts 3 and 4
   (``bps_mode="twostage"``/``"single"``, bps_N=14) through ``RxChain.planes``
   on the same capture; SER <= 1e-5 (twostage) and <= 1e-4 (single), launch
   counts B1=2, B2=1, B3=1, B8=1 (twostage only), B7=1, tracking bit-exact,
   decisions shared with the plain CPU chain on a small capture, and times
   (chain, tracking, each stage);
9. pilot kernels: ``workload.make_pilot_tx(244)`` built on the card; B2's
   frame entry (every one of the 240 frames), B5, B4 and B6 against their
   plain versions at the pilot path's shapes (480 rows of 2^16 symbols);
10. pilot main path: one dispatch of the LS pilot chain over frames 0-239
   through ``PilotRxChain.planes``; BER <= 1e-5 with sync_corr >= 120,
   launch counts B2 frames=1, B5=1, B4=1 and no other kernel, and the
   synchronising calls seen in that dispatch;
11. pilot variants: the ``return_phase=True`` chain over 8 frames (B6 once,
   B5 never, payload within 1e-4 of the serving chain's), tracking bit-exact,
   and the card's chain against the plain CPU chain on a small capture;
12. pilot times: the dispatch and the tracking entry in payload Msym/s, the
   device time of each stage, and each new kernel beside its plain version;
13. per-symbol trainer: B9 (one warp per output mode, a kernel instance per
   taps per lane, method and adaptive step) against its plain version on
   ``make_tx(2**13)`` (17 taps, TrSyms 4096) for cma, mcma and rde with and
   without the adaptive step from the centre-tap start, rde from converged
   taps, and three passes over 1024 symbols, whose chunk ends and buffered
   error trace end inside a pass (bounds: taps 1e-5, mu 1e-4 relative,
   error trace 1e-4; every case measured bit-equal on the H100), and two
   launches on one input bit-equal;
14. block trainer methods: B1's cma, rde, sbd and dd (one CTA per output
   mode, the capture ring fed by bulk copies) against the plain block
   trainer on the blind capture (2^14 symbols, blocks of 256), and two
   launches on one input bit-equal;
15. equaliser path: ``workload.make_tx(2**18)`` through
   ``dual_mode_equalisation(E, 2, (1e-3, 1e-3), 64, Ntaps=17, methods=("mcma",
   "rde"), adaptive_stepsize=(True, True))`` over the whole capture with
   ``backend="cuda"`` (launch counts B9=2, B2=1) and with
   ``backend="cuda_block"``, ``block_size=256`` (B1=2, B2=1), each followed
   by the single-grid carrier recovery and the SER gate <= 1e-4; B9, B1 and
   B2 against their plain versions at that path's shapes (B9's plain
   version over the first 4096 symbols, whose errors the full launch must
   repeat bit for bit), and the times of the calls, the stages and the
   kernels, B9's and B1's beside their chain bounds.

Beside every kernel's time stand its bound (the larger of its bytes over
the card's 3.35 TB/s and its operations over the card's 67 TFLOP/s in
float32, both counted from this run's shapes) and, where one PyTorch call
computes the same function (the filters: ``conv1d``), that call's time. The
trainers B1 and B9 are chains of dependent steps that no roofline bound
describes: beside their times stands a chain bound as well, the steps times
the latency of one step's critical path, from a written count of dependent
operations (``seq_chain_cycles``, ``block_chain_cycles``) and the latencies
the probe measured in this run.

Every time is printed with the card's name and power limit. The line before
the last is ``{"kernels": [...]}``, one record per kernel and path that
launched it, with that path's launch count and the error, times and bound
at that path's shapes; the last line is the device record
``{"ok": true, "device": {...}}``.
"""
import json
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from qampy_tpu_torch.core.metrics import decision_idx
from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.chain import decimated_derotation_inputs, make_rx_chain
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter_cuda, apply_filter_frames_cuda,
                                                apply_filter_frames_plain, apply_filter_plain,
                                                chain_latencies, div_check, train_block_cuda,
                                                train_block_plain, train_seq_cuda,
                                                train_seq_plain)
from qampy_tpu_torch.ops.phase_cuda import (bps_fine, bps_fine_cuda, bps_fine_plain,
                                            bps_search_cuda, bps_search_plain, cpe_coeffs,
                                            cpe_coeffs_cuda, cpe_coeffs_plain, interp_rotate,
                                            interp_rotate_cuda, interp_rotate_plain,
                                            quarter_unwrap, rotate_cuda, rotate_plain,
                                            unwrap_derotate_cuda, unwrap_derotate_plain)
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu_torch.workload import (GATE_TRIM, ber_gate, decide, make_pilot_tx, make_tx,
                                      ser_gate, shared_decisions)

NSYM = 2 ** 20
CFG = dict(M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3, bps_angles=64,
           bps_N=12, block_size=256, TrSyms=2 ** 14, bps_mode="decimated16")
SER_LIMIT = 1e-5
# the bench's blind attempts 3 and 4 (bench.py:656-657, 182-185) and their gates
SAMPLE_CFG = dict(CFG, bps_N=14)
SAMPLE_GATES = {"twostage": 1e-5, "single": 1e-4}
# kernel vs plain tolerances: float32 on both sides, summed in other orders
TOL_TAPS = 1e-4          # B1 taps after 64 dependent blocks
TOL_MU_REL = 1e-5        # B1 final step size
TOL_ERR = 1e-4           # B1 per-sample error
TOL_FILTER_REL = 1e-5    # B2, relative to the output rms
TOL_ROTATE = 1e-5        # B4, absolute (phases of many radians)
TIES_MAX = 1e-3          # B3: share of near-tied positions allowed to differ
TIE_REL = 1e-5           # B3: best two window sums within this are a near-tie
SMALL_AGREE = 0.999      # decided symbols shared with the plain chain on a small capture
SPACER_CYCLES = 200_000_000   # ~0.1 s at the H100's ~1.98 GHz boost clock
# the pilot serving chain (bench.py:425-435, 700): 240 frames per dispatch
PILOT_TX_FRAMES, PILOT_FRAMES, PILOT_FRAME, PILOT_SEQ, PILOT_RAT = 244, 240, 2 ** 16, 1024, 32
PILOT_CFG = dict(os=2, nmodes=2, sync_Ntaps=17, sync_mu=5e-3, sync_Niter=10, Ntaps=45,
                 cpe_avg=3, block_size=256, eq_trainer="ls")
PHASE_FRAMES = 8         # depth of the return_phase=True chain
TOL_CPE_A = 1e-5         # B5 a: the same float32 formula; atan2 may differ by an ulp,
TOL_CPE_B = 1e-6         # which moves a (a few rad) by ~1e-6 and the slopes b by ~1e-7
TOL_PAYLOAD = 1e-4       # return_phase on/off, the reference's bound (test_pilot_chain.py:543)
# the granular equaliser (examples/64_qam_equalisation.py): 2^18 symbols, trained over
# the whole capture, then the single-grid carrier recovery and the bench's gate for it
EQ_NSYM = 2 ** 18
EQ_CFG = dict(Ntaps=17, methods=("mcma", "rde"), adaptive_stepsize=(True, True))
EQ_MU = (1e-3, 1e-3)
EQ_BLOCK = 256
EQ_SER_LIMIT = 1e-4
RDE_BLOCKS = 8           # blocks over which B1's rde is held against its plain version
# B9 against its plain version: both round every product and sum alike and differ
# at most in the order of z's sum, and the recurrence contracts. Measured on the
# H100: every case bit-equal (the plain sum happens to pair the terms as the warp
# butterfly does). The bounds leave room for another order: 1e-5 in the taps and
# 1e-4 in the error, and one differing sign test of the adaptive step, which moves
# mu by mu^2 |e|^2, about 1e-4 of it
SEQ_NSYM, SEQ_TRS = 2 ** 13, 4096
TOL_SEQ_TAPS = 1e-5
TOL_SEQ_MU_REL = 1e-4
TOL_SEQ_ERR = 1e-4
# the card's published peaks (H100 SXM): device memory and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# operations per element of each function, counted from its definition: a complex
# multiply-add as 8, sin and cos as one each, a floor, clamp, abs or compare as one
OPS_FILTER_TAP = 8       # one complex tap on one output sample
OPS_TRAIN_TAP = 16       # a tap's complex multiply-add in z and in the update, per sample
OPS_TRAIN_ERR = 10       # the error and the step-size rule, per training sample
B1_THREADS = 288         # B1's CTA: 256 computing threads and the producer warp
DIV_PAIRS = 2 ** 22      # operand pairs of the division check
OPS_BPS_ANGLE = 26       # rotate 6, decide 12, distance 5, running window 2, compare 1
OPS_ROTATE = 8           # sin, cos and the rotation
OPS_INTERP = 2           # a + b j
OPS_UNWRAP = 6           # difference, quarter-turn count, prefix sum
OPS_CPE_PILOT = 20       # conjugate product, atan2, unwrap, average, coefficients
# the paths in the order they run; each is counted on its own (see counted())
PATHS = ("blind", "blind twostage", "blind single", "pilot", "pilot return_phase",
         "equaliser seq", "equaliser block")
# kernel: (wrapper name, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "B1": ("train_block", "qampy_tpu_torch/csrc/equaliser.cu",
           "qampy_tpu/ops/equaliser_pallas.py:296"),
    "B2": ("apply_filter", "qampy_tpu_torch/csrc/equaliser.cu",
           "qampy_tpu/ops/equaliser_pallas.py:539"),
    "B3": ("bps_search", "qampy_tpu_torch/csrc/phase.cu", "qampy_tpu/ops/phase_pallas.py:206"),
    "B4": ("interp_rotate", "qampy_tpu_torch/csrc/phase.cu",
           "qampy_tpu/ops/phase_pallas.py:695"),
    "B2 frames": ("apply_filter_frames", "qampy_tpu_torch/csrc/equaliser.cu",
                  "qampy_tpu/ops/equaliser_pallas.py:539"),
    "B5": ("cpe_coeffs", "qampy_tpu_torch/csrc/phase.cu", "qampy_tpu/ops/phase_pallas.py:808"),
    "B6": ("rotate", "qampy_tpu_torch/csrc/phase.cu", "qampy_tpu/ops/phase_pallas.py:616"),
    "B7": ("unwrap_derotate", "qampy_tpu_torch/csrc/phase.cu",
           "qampy_tpu/ops/phase_pallas.py:370"),
    "B8": ("bps_fine", "qampy_tpu_torch/csrc/phase.cu", "qampy_tpu/ops/phase_pallas.py:529"),
    "B9": ("train_seq", "qampy_tpu_torch/csrc/equaliser.cu",
           "qampy_tpu/ops/equaliser_pallas.py:69"),
}
COUNTERS = {"B1": train_block_cuda, "B2": apply_filter_cuda, "B3": bps_search_cuda,
            "B4": interp_rotate_cuda, "B2 frames": apply_filter_frames_cuda,
            "B5": cpe_coeffs_cuda, "B6": rotate_cuda, "B7": unwrap_derotate_cuda,
            "B8": bps_fine_cuda, "B9": train_seq_cuda}


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps):
    """Mean time of ``fn`` on the card's stream in ms over ``reps`` back-to-back calls.

    After two warm-up calls. The stream runs the calls as fast as the host
    enqueues them, so host dispatch gaps count: this is the time a caller
    sees per call in steady state.
    """
    fn()
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


def device_ms(fn, reps):
    """Mean device time of ``fn`` in ms, with the host's dispatch hidden.

    A spacer kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues all ``reps`` calls behind it, so the events around them see
    the device work only (as long as the enqueue fits in the spacer).
    """
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPACER_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_busy(fn, reps):
    """Device busy time of ``fn`` per call in ms, its kernels per call, and the device events.

    From ``torch.profiler``: the sum of the durations of everything that ran
    on the card (kernels, copies, fills) over ``reps`` calls. Unlike
    :func:`device_ms` it holds for stages of many small ops, whose enqueue
    would outlast any spacer, and it counts no idle gap.
    """
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps, len(dev) / reps, dev


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, ops):
    """The least time in ms the card could take: ``moved`` bytes or ``ops`` float32 operations."""
    t_b, t_o = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=None)


def trainer_bound(nmodes, nout, ntaps, os_, nsyms, niter):
    """Roofline bound of a trainer (B1, B9): the capture prefix in, taps in and out, the error out.

    The trainers are chains of dependent steps, one SM per output mode, so
    their time is set by latency and lies far above this bound; the bound
    to hold them against is the chain bound (:func:`seq_chain_cycles`,
    :func:`block_chain_cycles`), printed beside their times.
    """
    K = nmodes * ntaps
    moved = 4 * (2 * nmodes * (nsyms * os_ + ntaps - 1) + 2 * nout * nsyms * niter + 4 * nout * K)
    return bound(moved, niter * nsyms * nout * (OPS_TRAIN_TAP * K + OPS_TRAIN_ERR))


def trainer_build_report():
    """What ptxas said of the trainers' instances, from the build's log: registers and spills."""
    log = (_build.build_dir() / "build.log").read_text()
    entries = re.findall(r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, (\d+) bytes "
                         r"spill stores, (\d+) bytes spill loads.*?Used (\d+) registers", log, re.S)
    for kernel, name in (("train_seq_kernel", "B9"), ("train_block_kernel", "B1")):
        mine = [(int(st), int(ss), int(sl), int(r)) for fn, st, ss, sl, r in entries if kernel in fn]
        require(mine, "no %s instance in the build log" % kernel)
        print("build: %s %s has %d instances, %d to %d registers, stack up to %d bytes, spill "
              "stores up to %d, spill loads up to %d"
              % (name, kernel, len(mine), min(m[3] for m in mine), max(m[3] for m in mine),
                 max(m[0] for m in mine), max(m[1] for m in mine), max(m[2] for m in mine)))
        require(all(m[1] == 0 and m[2] == 0 for m in mine), "%s spills registers" % name)


def probe_phase(dev, card):
    """Phase 2, after the build: the latencies behind the chain bounds, and B9's division.

    Returns the latencies in cycles (a lone warp's, and the barrier and the
    SM-wide rates of a CTA of B1's size) and the SM clock in GHz.
    """
    warp, cta = chain_latencies(dev, 32), chain_latencies(dev, B1_THREADS)
    lat = dict(warp, barrier=cta["barrier"], lds128_per_sm=cta["lds128_per_sm"],
               ffma_per_sm=cta["ffma_per_sm"])
    print("probe: dependent add %.2f cycles, fused multiply-add %.2f, shuffle + add %.2f, rde "
          "lookup (ballot, popc, shuffle) + add %.2f, shared load %.2f, barrier of %d threads "
          "%.2f; with %d threads at work %.2f SM cycles per warp's 16-byte shared load and %.3f "
          "per warp's FFMA; SM clock %.3f GHz [%s]"
          % (lat["fadd"], lat["ffma"], lat["shuffle_add"], lat["lookup_add"], lat["shared_load"],
             B1_THREADS, lat["barrier"], B1_THREADS, lat["lds128_per_sm"], lat["ffma_per_sm"],
             lat["ghz"], card))
    require(all(np.isfinite(v) and v > 0 for v in lat.values()), "the latency probe failed")
    g = torch.Generator(device=dev).manual_seed(1)
    differ = []
    for a, b in ((torch.rand(DIV_PAIRS, generator=g, device=dev) * 2e-3 + 1e-7,
                  1 + torch.rand(DIV_PAIRS, generator=g, device=dev) * 0.5),
                 (torch.randn(DIV_PAIRS, generator=g, device=dev),
                  torch.randn(DIV_PAIRS, generator=g, device=dev) + 3)):
        differ.append(div_check(a, b))
    print("B9's straight-line division against __fdiv_rn: %d of %d quotients differ on the step "
          "size's operands (a in (1e-7, 2e-3), b in (1, 1.5)), %d of %d on normal operands"
          % (differ[0], DIV_PAIRS, differ[1], DIV_PAIRS))
    require(differ == [0, 0], "B9's division rounds unlike __fdiv_rn")
    return lat


def seq_chain_cycles(lat, K, method):
    """Cycles of one B9 step's critical path, from the probe's latencies.

    Dependent roundings: the tap update 4 (e x, +, mu x, w +), a product and
    its difference 2, the lane's sum over its ceil(K/32) taps, the error 3;
    then the 5 butterfly steps (shuffle + add). rde's ring lookup stands
    between |z|^2 and the error: its measured chain on top.
    """
    tpl = -(-K // 32)
    cycles = (4 + 2 + (tpl - 1) + 3) * lat["fadd"] + 5 * lat["shuffle_add"]
    return cycles + (lat["lookup_add"] if method == "rde" else 0.0)


def block_chain_cycles(lat, K, S):
    """Cycles of one B1 block's critical path at full parallelism.

    Three CTA barriers and, as dependent float operations: z as a product
    and a tree of ceil(log2 K) adds, the error 3, the product with the step
    size 1, a tap's sum over the block as a product and a tree of
    ceil(log2 S) adds, the tap's update 1.
    """
    ops = (1 + int(np.ceil(np.log2(K)))) + 3 + 1 + (1 + int(np.ceil(np.log2(S)))) + 1
    return 3 * lat["barrier"] + ops * lat["fadd"]


def print_chain(what, lat, steps, cycles, ms, card, unit):
    """A trainer's chain bound beside its time."""
    bound_ms = steps * cycles / (lat["ghz"] * 1e6)
    print("chain bound %s: %d dependent %ss x %.1f cycles at %.3f GHz = %.4f ms; kernel %.4f ms "
          "(%.1f cycles per %s) reaches %.1f%% of it [%s]"
          % (what, steps, unit, cycles, lat["ghz"], bound_ms, ms,
             ms * lat["ghz"] * 1e6 / steps, unit, 100 * bound_ms / ms, card))


def filter_bound(P, w, *outs):
    """Bound of the filter (B2): planes and taps in, output planes out."""
    nout, nmodes, ntaps = w.shape
    return bound(nbytes(P, w, *outs), OPS_FILTER_TAP * nmodes * ntaps * nout * outs[0].shape[-1])


def conv_taps(w):
    """The real (2*nout, 2*nmodes, ntaps) tap matrix [[wr, -wi], [wi, wr]] of complex taps."""
    wr, wi = w.real, w.imag
    return torch.cat([torch.cat([wr, -wi], dim=1), torch.cat([wi, wr], dim=1)]).contiguous()


def filter_library(P, os_, w, want, reps=20):
    """Time of ``conv1d(stride=os)`` on the planes, the one PyTorch call that is this filter.

    Checked against ``want`` (the kernel's output planes) before it is timed.
    """
    W = conv_taps(w)
    got = F.conv1d(P[None], W, stride=os_)[0]
    rms = float(want.pow(2).mean().sqrt())
    require(float((got - want).abs().max()) <= 10 * TOL_FILTER_REL * rms,
            "the library convolution is not the filter")
    return device_ms(lambda: F.conv1d(P[None], W, stride=os_), reps)


def check_kernels(P, chain, card, lat):
    """Phase 3: each kernel against its plain version at the main path's shapes."""
    rec = {}
    os_, mu, S, trs = CFG["os"], CFG["mu"], CFG["block_size"], CFG["TrSyms"]
    s1, s2 = chain.specs
    w0 = chain.w0

    # B1: the mcma stage from the identity taps, the mddma stage from its taps
    e_p, w_p, mu_p = train_block_plain(P, trs, 1, os_, mu, w0, s1, True, S)
    e_k, w_k, mu_k = train_block_cuda(P, trs, 1, os_, mu, w0, s1, True, S)
    e2_p, w2_p, mu2_p = train_block_plain(P, trs, 1, os_, mu, w_k, s2, True, S)
    e2_k, w2_k, mu2_k = train_block_cuda(P, trs, 1, os_, mu, w_k, s2, True, S)
    d_taps = max(float((w_k - w_p).abs().max()), float((w2_k - w2_p).abs().max()))
    d_mu = max(float(((mu_k - mu_p) / mu_p).abs().max()),
               float(((mu2_k - mu2_p) / mu2_p).abs().max()))
    d_err = max(float((e_k - e_p).abs().max()), float((e2_k - e2_p).abs().max()))
    print("B1 train_block: taps max|d| %.3e (tol %.0e), mu rel %.3e (tol %.0e), "
          "err max|d| %.3e (tol %.0e)" % (d_taps, TOL_TAPS, d_mu, TOL_MU_REL, d_err, TOL_ERR))
    require(d_taps <= TOL_TAPS and d_mu <= TOL_MU_REL and d_err <= TOL_ERR,
            "B1 disagrees with its plain version")
    rec["B1"] = dict(
        **trainer_bound(2, 2, CFG["Ntaps"], os_, trs, 1), err=d_taps,
        ms=device_ms(lambda: train_block_cuda(P, trs, 1, os_, mu, w0, s1, True, S), 20),
        plain_ms=device_ms(lambda: train_block_plain(P, trs, 1, os_, mu, w0, s1, True, S), 3))
    K = 2 * CFG["Ntaps"]
    print_chain("B1 train_block (blind path)", lat, trs // S, block_chain_cycles(lat, K, S),
                rec["B1"]["ms"], card, "block")
    print("B1's block also needs %.0f SM cycles for its 8 K S flops at the probe's FFMA rate"
          % (8 * K * S / 2 / 32 * lat["ffma_per_sm"]))

    # B2: the filter with the trained taps and its stride-16 side output
    w = w2_k
    out_p, dec_p = apply_filter_plain(P, os_, w, chain.dec)
    out_k, dec_k = apply_filter_cuda(P, os_, w, chain.dec)
    rms = float(out_p.pow(2).mean().sqrt())
    d_out = float((out_k - out_p).abs().max())
    d_dec = float((dec_k - dec_p).abs().max())
    print("B2 apply_filter: out %s max|d| %.3e, dec %s max|d| %.3e (tol %.0e x rms %.3f)"
          % (tuple(out_k.shape), d_out, tuple(dec_k.shape), d_dec, TOL_FILTER_REL, rms))
    require(out_k.shape == out_p.shape and dec_k.shape == dec_p.shape,
            "B2 output shapes differ")
    require(max(d_out, d_dec) <= TOL_FILTER_REL * rms, "B2 disagrees with its plain version")
    rec["B2"] = dict(**filter_bound(P, w, out_k, dec_k), err=max(d_out, d_dec),
                     ms=device_ms(lambda: apply_filter_cuda(P, os_, w, chain.dec), 50),
                     plain_ms=device_ms(lambda: apply_filter_plain(P, os_, w, chain.dec), 10))
    rec["B2"]["library_ms"] = filter_library(P, os_, w, out_k)

    # B3: the phase search on the decimated planes
    no = dec_k.shape[0] // 2
    er, ei = dec_k[:no].contiguous(), dec_k[no:].contiguous()
    args = (er, ei, chain.bps_cos, chain.bps_sin, chain.grid, chain.bps_N)
    idx_p = bps_search_plain(*args)
    idx_k = bps_search_cuda(*args)
    N = chain.bps_N
    ties = phops.bps_near_ties(er, ei, chain.bps_cos, chain.bps_sin, chain.grid, N, TIE_REL)
    differ = idx_k != idx_p
    d_idx = int((idx_k - idx_p).abs()[~ties].max())
    tie_share = float(ties.double().mean())
    off_tie = bool((differ & ~ties).any())
    print("B3 bps_search: %s, %d positions differ, %s off near-ties; near-tie share "
          "%.2e (max %.0e); max|d idx| off ties %d"
          % (tuple(idx_k.shape), int(differ.sum()), "some" if off_tie else "none",
             tie_share, TIES_MAX, d_idx))
    require(not off_tie and tie_share <= TIES_MAX,
            "B3 disagrees with its plain version off near-ties")
    rec["B3"] = dict(**bound(nbytes(er, ei, idx_k),
                             OPS_BPS_ANGLE * chain.bps_cos.shape[0] * er.numel()),
                     err=float(d_idx), ms=device_ms(lambda: bps_search_cuda(*args), 50),
                     plain_ms=device_ms(lambda: bps_search_plain(*args), 10))

    # B4: the derotation with the coefficients the chain builds from B3
    eqp = out_k
    er_p, ei_p, a, b = decimated_derotation_inputs(eqp[:no], eqp[no:], idx_k, chain.lo_a,
                                                   chain.step_a, chain.dec)
    rargs = (er_p, ei_p, a, b, chain.dec, 1)
    r_p, i_p = interp_rotate_plain(*rargs)
    r_k, i_k = interp_rotate_cuda(*rargs)
    d_rot = max(float((r_k - r_p).abs().max()), float((i_k - i_p).abs().max()))
    print("B4 interp_rotate: %s max|d| %.3e (tol %.0e), |phase| up to %.2f rad"
          % (tuple(r_k.shape), d_rot, TOL_ROTATE, float(a.abs().max())))
    require(d_rot <= TOL_ROTATE, "B4 disagrees with its plain version")
    rec["B4"] = dict(**bound(nbytes(er_p, ei_p, a, b, r_k, i_k),
                             (OPS_INTERP + OPS_ROTATE) * er_p.numel()),
                     err=d_rot, ms=device_ms(lambda: interp_rotate_cuda(*rargs), 50),
                     plain_ms=device_ms(lambda: interp_rotate_plain(*rargs), 10))
    print_times({(k, "blind"): dict(v, shape="blind path") for k, v in rec.items()}, card)
    return rec


def print_times(rec, card):
    """One line per record: the kernel's time beside its bound, plain version and library call."""
    for (k, path), v in rec.items():
        lib = "none" if v["library_ms"] is None else "%.4f ms" % v["library_ms"]
        print("time %s (%s path, device, %s): kernel %.4f ms, bound %.5f ms by %s, plain %.4f ms, "
              "library call %s [%s]" % (k, path, v["shape"], v["ms"], v["bound_ms"],
                                        v["bound_by"], v["plain_ms"], lib, card))


def counted(fn):
    """Run ``fn`` with every launch count set to 0 before it; return (result, counts)."""
    for k in COUNTERS.values():
        k.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, {name: k.launches for name, k in COUNTERS.items()}


def expected(counts):
    """A path's expected launch counts: ``counts``, and 0 for every other kernel."""
    return {k: counts.get(k, 0) for k in COUNTERS}


def rotation_bound(er, ei, u):
    """2 |z| (ulp32(|u|) + 2^-23): how far two float32 rotations of z by u may lie apart.

    Each rounds the phase (up to an ulp of |u|) and takes sin and cos to
    about an ulp, below 2^-23 (tests/test_torch_kernels.py:185).
    """
    a = u.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return 2 * torch.sqrt(er * er + ei * ei) * (ulp + 2.0 ** -23)


def check_sample_kernels(P, w, card):
    """Phase 7: B2 (no side output), B3, B8 and B7 at the per-sample paths' shapes.

    P: the blind capture; w: taps trained on it. Returns records keyed by
    (kernel, path) for "blind twostage" and "blind single".
    """
    rec = {}
    os_ = CFG["os"]
    out_p = apply_filter_plain(P, os_, w)
    out_k = apply_filter_cuda(P, os_, w)
    rms = float(out_p.pow(2).mean().sqrt())
    d_out = float((out_k - out_p).abs().max())
    print("B2 apply_filter (no side output): %s max|d| %.3e (tol %.0e x rms %.3f)"
          % (tuple(out_k.shape), d_out, TOL_FILTER_REL, rms))
    require(out_k.shape == out_p.shape and d_out <= TOL_FILTER_REL * rms,
            "B2 without side output disagrees with its plain version")
    b2 = dict(**filter_bound(P, w, out_k), err=d_out,
              ms=device_ms(lambda: apply_filter_cuda(P, os_, w), 50),
              plain_ms=device_ms(lambda: apply_filter_plain(P, os_, w), 10),
              shape="2 x 2^21 samples in, no side output")
    b2["library_ms"] = filter_library(P, os_, w, out_k)
    no = out_k.shape[0] // 2
    er, ei = out_k[:no], out_k[no:]
    L = er.shape[-1]
    for mode in ("twostage", "single"):
        path = "blind " + mode
        chain = make_rx_chain(**dict(SAMPLE_CFG, bps_mode=mode), device=P.device)
        rec["B2", path] = b2
        A, N = chain.bps_cos.shape[0], chain.search_N
        args = (er, ei, chain.bps_cos, chain.bps_sin, chain.grid, N)
        idx_p = bps_search_plain(*args)
        idx_k = bps_search_cuda(*args)
        ties = phops.bps_near_ties(*args, TIE_REL)
        differ = idx_k != idx_p
        tie_share = float(ties.double().mean())
        off_tie = bool((differ & ~ties).any())
        print("B3 bps_search (%s: A=%d, N=%d): %s, %d positions differ, %s off near-ties; "
              "near-tie share %.2e (max %.0e)" % (path, A, N, tuple(idx_k.shape),
                                                  int(differ.sum()),
                                                  "some" if off_tie else "none", tie_share,
                                                  TIES_MAX))
        require(not off_tie and tie_share <= TIES_MAX,
                "B3 disagrees with its plain version off near-ties at A=%d, N=%d" % (A, N))
        rec["B3", path] = dict(**bound(nbytes(er, ei, idx_k), OPS_BPS_ANGLE * A * er.numel()),
                               err=float((idx_k - idx_p).abs()[~ties].max()),
                               ms=device_ms(lambda: bps_search_cuda(*args), 20),
                               plain_ms=device_ms(lambda: bps_search_plain(*args), 5),
                               shape="A=%d N=%d, 2 x %d samples" % (A, N, L))
        ph = chain.lo_a + chain.step_a * idx_k.to(torch.float32)
        if mode == "twostage":
            fargs = (er, ei, ph, chain.fine_cos, chain.fine_sin, chain.grid, chain.bps_N,
                     chain.fine_d0, chain.fine_step)
            f_p = bps_fine_plain(*fargs)
            f_k = bps_fine_cuda(*fargs)
            ties = phops.bps_fine_near_ties(*fargs[:7], TIE_REL)
            differ = f_k != f_p
            tie_share = float(ties.double().mean())
            off_tie = bool((differ & ~ties).any())
            print("B8 bps_fine (B=%d, N=%d): %s, %d phases differ, %s off near-ties; near-tie "
                  "share %.2e (max %.0e); max|d| %.3e" % (
                      chain.fine_cos.shape[0], chain.bps_N, tuple(f_k.shape),
                      int(differ.sum()), "some" if off_tie else "none", tie_share, TIES_MAX,
                      float((f_k - f_p).abs().max())))
            require(not off_tie and tie_share <= TIES_MAX,
                    "B8 disagrees with its plain version off near-ties")
            rec["B8", path] = dict(**bound(nbytes(er, ei, ph, f_k),
                                           (OPS_BPS_ANGLE * chain.fine_cos.shape[0] + OPS_ROTATE)
                                           * er.numel()),
                                   err=float((f_k - f_p).abs()[~ties].max()),
                                   ms=device_ms(lambda: bps_fine_cuda(*fargs), 20),
                                   plain_ms=device_ms(lambda: bps_fine_plain(*fargs), 5),
                                   shape="B=8 N=%d, 2 x %d samples" % (chain.bps_N, L))
            ph = f_k
        r_p, i_p = unwrap_derotate_plain(er, ei, ph)
        r_k, i_k = unwrap_derotate_cuda(er, ei, ph)
        dist = torch.sqrt((r_k - r_p) ** 2 + (i_k - i_p) ** 2)
        rot_bound = rotation_bound(er, ei, quarter_unwrap(ph))
        d_rot = max(float((r_k - r_p).abs().max()), float((i_k - i_p).abs().max()))
        print("B7 unwrap_derotate (%s phase): %s max|d| %.3e, worst share of the bound "
              "2|z|(ulp32(|u|) + 2^-23) %.3f, |u| up to %.2f rad"
              % (mode, tuple(r_k.shape), d_rot, float((dist / rot_bound).max()),
                 float(quarter_unwrap(ph).abs().max())))
        require(bool((dist <= rot_bound).all()), "B7 disagrees with its plain version")
        uargs = (er, ei, ph)
        rec["B7", path] = dict(**bound(nbytes(er, ei, ph, r_k, i_k),
                                       (OPS_UNWRAP + OPS_ROTATE) * er.numel()),
                               err=d_rot, ms=device_ms(lambda: unwrap_derotate_cuda(*uargs), 50),
                               plain_ms=device_ms(lambda: unwrap_derotate_plain(*uargs), 10),
                               shape="2 x %d samples" % L)
    print_times(rec, card)
    return rec


def sample_path(mode, P, ref, const, card):
    """Phase 8 for one mode: the per-sample blind chain counted, gated, compared and timed.

    Returns that path's launch counts.
    """
    dev = P.device
    gate = SAMPLE_GATES[mode]
    cfg = dict(SAMPLE_CFG, bps_mode=mode)
    chain = make_rx_chain(**cfg, device=dev)
    (outr, outi), launches = counted(lambda: chain.planes(P))
    print("blind %s launches: %s" % (mode, launches))
    want = {"B1": 2, "B2": 1, "B3": 1, "B7": 1}
    if mode == "twostage":
        want["B8"] = 1
    require(launches == expected(want), "the %s path did not launch each kernel as expected"
            % mode)
    Lout = (P.shape[-1] - SAMPLE_CFG["Ntaps"]) // SAMPLE_CFG["os"] + 1
    require(tuple(outr.shape) == (2, Lout) and outr.shape == outi.shape,
            "%s output shape %s" % (mode, tuple(outr.shape)))
    require(bool(torch.isfinite(outr).all() and torch.isfinite(outi).all()),
            "non-finite %s output" % mode)
    ser = ser_gate(torch.complex(outr, outi), ref, const)
    print("blind %s SER %.3e (gate %.0e; against 1e-5: %s) on %d x 2 symbols"
          % (mode, ser, gate, "pass" if ser <= 1e-5 else "fail", NSYM))
    require(ser <= gate, "%s SER gate failed" % mode)

    (fr, fi), w = chain.planes_with_taps(P)
    tr, ti = chain.tracking_planes(P, w)
    exact = bool(torch.equal(tr, fr) and torch.equal(ti, fi))
    print("blind %s tracking_planes == planes_with_taps output: %s" % (mode, exact))
    require(exact, "%s tracking output differs from the full chain" % mode)

    Es, syms_s, _ = make_tx(2 ** 15, seed=2)
    o_cpu = make_rx_chain(**cfg, device="cpu").forward(torch.as_tensor(Es))
    o_gpu = chain.forward(torch.as_tensor(Es, device=dev)).cpu()
    trim = slice(GATE_TRIM, -GATE_TRIM)
    agree = shared_decisions(o_cpu[:, trim], o_gpu[:, trim], const)
    ser_s = [ser_gate(o, torch.as_tensor(syms_s), const) for o in (o_cpu, o_gpu)]
    print("blind %s small capture (2^15 x 2 symbols): card vs plain CPU chain share %.6f of "
          "decisions, each mode at its best quarter turn (min %.3f); SER cpu %.2e, card %.2e"
          % (mode, agree, SMALL_AGREE, ser_s[0], ser_s[1]))
    require(agree >= SMALL_AGREE and max(ser_s) <= gate,
            "the card's %s chain disagrees with the plain chain" % mode)

    nsym_tot = NSYM * 2
    t_full = cuda_ms(lambda: chain.planes(P), 10)
    t_trk = cuda_ms(lambda: chain.tracking_planes(P, w), 20)
    print("time blind %s chain.planes: %.4f ms, %.1f Msym/s [%s]"
          % (mode, t_full, nsym_tot / t_full / 1e3, card))
    print("time blind %s chain.tracking_planes: %.4f ms, %.1f Msym/s [%s]"
          % (mode, t_trk, nsym_tot / t_trk / 1e3, card))
    eqp, _ = chain.equalise(P, w)
    no = eqp.shape[0] // 2
    idx = chain.phase_search(eqp)
    ph1 = chain.lo_a + chain.step_a * idx.to(torch.float32)
    ph = chain.carrier_phase(eqp)
    stages = {
        "train (2x B1 + guard)": device_ms(lambda: chain.train_taps(P), 10),
        "filter (B2)": device_ms(lambda: chain.equalise(P, w), 20),
        "bps (B3, A=%d, N=%d)" % (chain.bps_cos.shape[0], chain.search_N):
            device_ms(lambda: chain.phase_search(eqp), 20),
        "index to phase (plain)": device_ms(
            lambda: chain.lo_a + chain.step_a * idx.to(torch.float32), 20),
    }
    if mode == "twostage":
        stages["fine bps (B8)"] = device_ms(lambda: bps_fine(
            eqp[:no], eqp[no:], ph1, chain.fine_cos, chain.fine_sin, chain.grid, chain.bps_N,
            chain.fine_d0, chain.fine_step), 20)
    stages["unwrap-derotate (B7)"] = device_ms(lambda: chain.unwrap_derotate(eqp, ph), 20)
    for k, v in stages.items():
        print("time blind %s stage %s: %.4f ms device (%.1f%% of the chain's stream time) [%s]"
              % (mode, k, v, 100 * v / t_full, card))
    print("time blind %s stages' device sum: %.4f ms vs chain stream time %.4f ms [%s]"
          % (mode, sum(stages.values()), t_full, card))
    return launches


def syncs_in(fn):
    """How many synchronising calls ``fn`` makes, as the CUDA sync debug mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message).splitlines()[0] for w in seen
            if "Synchronization debug mode is a prototype" not in str(w.message)]


def pilot_stages(chain, pr, pi):
    """The pilot chain's stages run one by one: a dict of every stage's inputs and outputs."""
    P = chain._planes(pr, pi)
    wxs, best_w = chain.sync_search(P)
    mode_order, shift, _, _ = chain.align(P, wxs, best_w)
    eqsh = chain._eq_shift(shift)
    taps = chain.ls_taps(P, eqsh, mode_order).index_select(1, torch.argsort(mode_order))
    out = chain.frame_filter(P, eqsh, taps)
    rows = out.shape[1] * out.shape[2]
    symr, symi = out[0].reshape(rows, -1), out[1].reshape(rows, -1)
    cargs = (symr, symi, chain.pil_r, chain.pil_i, chain.seq_len, chain.ins_rat, chain.n_head,
             chain.npts, chain.cpe_dx, chain.cpe_avg, chain.nbt)
    return dict(P=P, wxs=wxs, best_w=best_w, mode_order=mode_order, eqsh=eqsh, taps=taps,
                rows=rows, symr=symr, symi=symi, cargs=cargs)


def check_pilot_kernels(chain, st, card):
    """Phase 9: B2's frame entry, B5, B4 and B6 against their plain versions at the pilot shapes.

    The inputs are the pilot path's own (``st``, from :func:`pilot_stages`):
    the capture, the state the chain acquires on it, the filter output and
    the CPE coefficients built from it. Returns records keyed by (kernel,
    path): the serving path's shapes for "pilot" and the first
    ``PHASE_FRAMES`` frames for "pilot return_phase".
    """
    rec = {}
    P, eqsh, taps = st["P"], st["eqsh"], st["taps"]
    F, n, nr = chain.frame_len, chain.nmodes, PHASE_FRAMES

    # B2, frame entry: every frame of the dispatch against the reference's
    # form, nmodes^2 virtual input planes and block-diagonal taps through the
    # plain filter, one frame at a time
    offs = chain.frame_offsets(P, eqsh)
    got = apply_filter_frames_cuda(P, chain.os, taps, offs, F)
    wv = torch.zeros((n, n * n, chain.Ntaps), dtype=taps.dtype, device=P.device)
    for i in range(n):
        wv[i, i * n:(i + 1) * n] = taps[i]
    d_f, rms = [], 0.0
    for f, row in enumerate(offs.t().tolist()):
        sl = [P[:, o:o + chain.fr_len] for o in row]
        ref = apply_filter_plain(torch.cat([s[:n] for s in sl] + [s[n:] for s in sl]),
                                 chain.os, wv)
        d_f.append(float((got[:, :, f] - ref.reshape(2, n, F)).abs().max()))
        rms = max(rms, float(ref.pow(2).mean().sqrt()))
    print("B2 frames apply_filter_frames: %s max|d| %.3e over all %d frames, %.3e over the "
          "first %d, against the virtual-input form (tol %.0e x rms %.3f)"
          % (tuple(got.shape), max(d_f), len(d_f), max(d_f[:nr]), nr, TOL_FILTER_REL, rms))
    require(max(d_f) <= TOL_FILTER_REL * rms, "B2's frame entry disagrees with the plain form")
    for path, o, d in (("pilot", offs, max(d_f)),
                       ("pilot return_phase", offs[:, :nr].contiguous(), max(d_f[:nr]))):
        fargs = (P, chain.os, taps, o, F)
        nf = o.shape[1]
        # each input read once: the span of the capture that the frames' windows cover
        span = int(o.max() - o.min()) + chain.fr_len
        rec["B2 frames", path] = dict(
            **bound(4 * 2 * n * span + nbytes(taps, o) + 4 * 2 * n * nf * F,
                    OPS_FILTER_TAP * n * chain.Ntaps * n * nf * F),
            err=d, ms=device_ms(lambda: apply_filter_frames_cuda(*fargs), 20),
            plain_ms=device_ms(lambda: apply_filter_frames_plain(*fargs), 3),
            shape="%d frames" % nf)
        rec["B2 frames", path]["library_ms"] = frames_library(
            P, chain.os, taps, o, chain.fr_len, got[:, :, :nf])

    # B5 on all 480 rows of the filter output
    rows, symr, symi, cargs = st["rows"], st["symr"], st["symi"], st["cargs"]
    a_p, b_p = cpe_coeffs_plain(*cargs)
    a_k, b_k = cpe_coeffs_cuda(*cargs)
    d_a, d_b = float((a_k - a_p).abs().max()), float((b_k - b_p).abs().max())
    print("B5 cpe_coeffs: %d rows x %d pilots -> %s, max|da| %.3e (tol %.0e), max|db| %.3e "
          "(tol %.0e), |a| up to %.2f rad" % (rows, chain.nblk, tuple(a_k.shape), d_a, TOL_CPE_A,
                                              d_b, TOL_CPE_B, float(a_p.abs().max())))
    require(d_a <= TOL_CPE_A and d_b <= TOL_CPE_B, "B5 disagrees with its plain version")
    # of the filter output it reads the pilot samples only
    rec["B5", "pilot"] = dict(**bound(2 * 4 * rows * chain.nblk + nbytes(chain.pil_r, chain.pil_i,
                                                                         a_k, b_k),
                                      OPS_CPE_PILOT * rows * chain.nblk),
                              err=max(d_a, d_b), ms=device_ms(lambda: cpe_coeffs_cuda(*cargs), 50),
                              plain_ms=device_ms(lambda: cpe_coeffs_plain(*cargs), 10),
                              shape="%d rows" % rows)

    # B4 (sign -1, dx 32) with those coefficients
    rargs = (symr, symi, a_k, b_k, chain.cpe_dx, -1)
    r_p, i_p = interp_rotate_plain(*rargs)
    r_k, i_k = interp_rotate_cuda(*rargs)
    d_r = max(float((r_k - r_p).abs().max()), float((i_k - i_p).abs().max()))
    print("B4 interp_rotate (pilot CPE): %s max|d| %.3e (tol %.0e)"
          % (tuple(r_k.shape), d_r, TOL_ROTATE))
    require(d_r <= TOL_ROTATE, "B4 disagrees with its plain version on the pilot path")
    rec["B4", "pilot"] = dict(**bound(nbytes(symr, symi, a_k, b_k, r_k, i_k),
                                      (OPS_INTERP + OPS_ROTATE) * symr.numel()),
                              err=d_r, ms=device_ms(lambda: interp_rotate_cuda(*rargs), 50),
                              plain_ms=device_ms(lambda: interp_rotate_plain(*rargs), 10),
                              shape="%d rows" % rows)

    # B6 with the plain CPE trace: on all 480 rows, and on the rows of the
    # return_phase chain's first frames, which that path derotates
    out = torch.stack([symr, symi]).reshape(2, n, -1, F)
    sub = out[:, :, :nr].reshape(2, n * nr, F)
    for what, (zr, zi) in (("%d rows" % rows, (symr, symi)),
                           ("%d rows" % (n * nr), (sub[0].contiguous(), sub[1].contiguous()))):
        sargs = (zr, zi, chain.cpe_trace(zr, zi), -1)
        r_p, i_p = rotate_plain(*sargs)
        r_k, i_k = rotate_cuda(*sargs)
        d_s = max(float((r_k - r_p).abs().max()), float((i_k - i_p).abs().max()))
        print("B6 rotate: %s max|d| %.3e (tol %.0e), |phase| up to %.2f rad"
              % (tuple(r_k.shape), d_s, TOL_ROTATE, float(sargs[2].abs().max())))
        require(d_s <= TOL_ROTATE, "B6 disagrees with its plain version")
    rec["B6", "pilot return_phase"] = dict(
        **bound(nbytes(zr, zi, sargs[2], r_k, i_k), OPS_ROTATE * zr.numel()),
        err=d_s, ms=device_ms(lambda: rotate_cuda(*sargs), 50),
        plain_ms=device_ms(lambda: rotate_plain(*sargs), 10), shape=what)
    print_times(rec, card)
    return rec


def frames_library(P, os_, taps, offs, fr_len, want):
    """Time of one grouped ``conv1d(stride=os)`` that is the frame-batched filter.

    Each output mode's windows are gathered first (not timed): input
    (nframes, nout * 2 * nmodes, fr_len), one group per output mode with its
    [[wr, -wi], [wi, wr]] taps. Checked against ``want``, the kernel's
    (2, nout, nframes, frame_len) output, before it is timed.
    """
    nout, nmodes, _ = taps.shape
    nf = offs.shape[1]
    idx = offs[..., None] + torch.arange(fr_len, device=P.device)
    X = P[:, idx].permute(2, 1, 0, 3).reshape(nf, nout * 2 * nmodes, fr_len).contiguous()
    W = torch.cat([conv_taps(taps[i:i + 1]) for i in range(nout)])   # (nout * 2, 2 * nmodes, t)
    got = F.conv1d(X, W, stride=os_, groups=nout).reshape(nf, nout, 2, -1).permute(2, 1, 0, 3)
    rms = float(want.pow(2).mean().sqrt())
    require(float((got - want).abs().max()) <= 10 * TOL_FILTER_REL * rms,
            "the library convolution is not the frame filter")
    del got
    return device_ms(lambda: F.conv1d(X, W, stride=os_, groups=nout), 5)


def check_seq_kernel(dev, card):
    """Phase 13: B9 against its plain version, at the equaliser path's widths.

    ``make_tx(2**13)``, 17 taps, 2 samples per symbol, 64-QAM constants; the
    plain version is a Python loop of a few dozen small launches per symbol,
    so the length is cut to 4096 symbols. Returns (the worst differences, the
    kernel's and the plain version's time at that length).
    """
    E, _, _ = make_tx(SEQ_NSYM)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    w0 = torch.as_tensor(eqops._init_taps(EQ_CFG["Ntaps"], 2, 2, np.complex64), device=dev)
    syms = {m: eqops._reshape_symbols(None, m, 64, np.complex64, 2) for m in ("cma", "mcma", "rde")}
    _, w_conv, _ = train_seq_cuda(P, SEQ_TRS, 1, 2, 1e-3, w0, syms["mcma"], "mcma", True)
    cases = [(m, ad, "centre tap", w0, SEQ_TRS, 1) for m in ("cma", "mcma", "rde")
             for ad in (False, True)]
    cases += [("rde", True, "converged taps", w_conv, SEQ_TRS, 1),
              ("cma", True, "centre tap", w0, 1024, 3)]
    worst = dict(taps=0.0, mu=0.0, err=0.0)
    t_k = t_p = 0.0
    for method, adaptive, start, w, trs, niter in cases:
        args = (P, trs, niter, 2, 1e-3, w, syms[method], method, adaptive)
        (e_p, w_p, mu_p), ms_p = timed(lambda: train_seq_plain(*args))
        (e_k, w_k, mu_k), ms_k = timed(lambda: train_seq_cuda(*args))
        again = train_seq_cuda(*args)
        require(all(torch.equal(x, y) for x, y in zip((e_k, w_k, mu_k), again)),
                "two launches of B9 on one input differ")
        d = dict(taps=float((w_k - w_p).abs().max()),
                 mu=float(((mu_k - mu_p) / mu_p).abs().max()),
                 err=float((e_k - e_p).abs().max()))
        print("B9 train_seq %s%s from the %s, %d x %d symbols: taps max|d| %.3e (tol %.0e), mu "
              "rel %.3e (tol %.0e), err max|d| %.3e (tol %.0e); kernel %.3f ms, plain %.1f ms"
              % (method, " adaptive" if adaptive else "", start, niter, trs, d["taps"],
                 TOL_SEQ_TAPS, d["mu"], TOL_SEQ_MU_REL, d["err"], TOL_SEQ_ERR, ms_k, ms_p))
        require(e_k.shape == e_p.shape == (2, niter * trs), "B9 error trace shape")
        require(d["taps"] <= TOL_SEQ_TAPS and d["mu"] <= TOL_SEQ_MU_REL
                and d["err"] <= TOL_SEQ_ERR, "B9 disagrees with its plain version")
        worst = {k: max(worst[k], d[k]) for k in worst}
        if (method, adaptive, start) == ("mcma", True, "centre tap"):
            t_k, t_p = ms_k, ms_p
    print("B9 worst over %d cases: taps %.3e, mu rel %.3e, err %.3e [%s]"
          % (len(cases), worst["taps"], worst["mu"], worst["err"], card))
    return worst, t_k, t_p


def timed(fn):
    """(result, ms) of one call of ``fn`` on the card's stream, after it has finished."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


def check_block_methods(P, chain, card):
    """Phase 14: B1's cma, rde, sbd and dd against the plain block trainer (sgncma is cma).

    On the blind capture at the blind path's training shape; cma starts
    from the centre taps, the others from the taps of an mcma stage. rde
    runs RDE_BLOCKS blocks only: its ring decision makes the recurrence
    expand a rounding difference until a sample changes ring, and two
    float32 runs then part for good (two plain runs started 2e-7 apart do
    so after 10-20 blocks).
    """
    os_, mu, S, trs = CFG["os"], CFG["mu"], CFG["block_size"], CFG["TrSyms"]
    _, w1, _ = train_block_cuda(P, trs, 1, os_, mu, chain.w0, chain.specs[0], True, S)
    for method in ("cma", "rde", "sbd", "dd"):
        spec = eqops.err_spec(method, eqops._reshape_symbols(None, method, CFG["M"],
                                                             np.complex64, 2))
        n = RDE_BLOCKS * S if method == "rde" else trs
        args = (P, n, 1, os_, mu, chain.w0 if method == "cma" else w1, spec, True, S)
        e_p, w_p, mu_p = train_block_plain(*args)
        e_k, w_k, mu_k = train_block_cuda(*args)
        again = train_block_cuda(*args)
        require(all(torch.equal(x, y) for x, y in zip((e_k, w_k, mu_k), again)),
                "two launches of B1 on one input differ")
        d_taps = float((w_k - w_p).abs().max())
        d_mu = float(((mu_k - mu_p) / mu_p).abs().max())
        d_err = float((e_k - e_p).abs().max())
        print("B1 train_block %s, %d blocks: taps max|d| %.3e (tol %.0e), mu rel %.3e (tol %.0e), "
              "err max|d| %.3e (tol %.0e); kernel %.4f ms [%s]"
              % (method, n // S, d_taps, TOL_TAPS, d_mu, TOL_MU_REL, d_err, TOL_ERR,
                 device_ms(lambda: train_block_cuda(*args), 10), card))
        require(d_taps <= TOL_TAPS and d_mu <= TOL_MU_REL and d_err <= TOL_ERR,
                "B1 %s disagrees with its plain version" % method)


def equaliser_phases(dev, card, seq_check, lat):
    """Phase 15: the granular equaliser at 2^18 symbols through B9 and through B1.

    Returns (kernel records keyed by (kernel, path), launches per path).
    """
    worst, t_k4096, t_p4096 = seq_check
    t0 = time.perf_counter()
    E_h, syms_h, const = make_tx(EQ_NSYM)
    E = torch.as_tensor(E_h, device=dev)
    ref = torch.as_tensor(syms_h, device=dev)
    P = eqops.planes(E).contiguous()
    ntaps, (m1, m2) = EQ_CFG["Ntaps"], EQ_CFG["methods"]
    trs = eqops._cal_training_symbol_len(2, ntaps, E.shape[-1])
    print("equaliser tx: %d symbols x 2 pol, capture %s, %d training symbols per stage, %.2f s "
          "on the host" % (EQ_NSYM, tuple(E.shape), trs, time.perf_counter() - t0))
    cr = make_rx_chain(M=64, bps_angles=64, bps_N=14, bps_mode="single")
    require(cr.w0.device.type == "cuda", "make_rx_chain() did not build on the card")
    rec, path_launches, taps = {}, {}, {}
    nsym_tot = 2 * EQ_NSYM
    for path, kw, want in (("equaliser seq", dict(backend="cuda"), {"B9": 2, "B2": 1}),
                           ("equaliser block", dict(backend="cuda_block", block_size=EQ_BLOCK),
                            {"B1": 2, "B2": 1})):
        def call():
            return eqops.dual_mode_equalisation(E, 2, EQ_MU, 64, **EQ_CFG, **kw)
        (out, w, errs), launches = counted(call)
        print("%s launches: %s" % (path, launches))
        require(launches == expected(want), "the %s path did not launch each kernel as expected"
                % path)
        Lout = (E.shape[-1] - ntaps) // 2 + 1
        require(tuple(out.shape) == (2, Lout) and out.is_cuda and w.shape == (2, 2, ntaps),
                "%s output shape %s" % (path, tuple(out.shape)))
        require(bool(torch.isfinite(torch.view_as_real(out)).all()), "non-finite %s output" % path)
        eqp = eqops.planes(out).contiguous()
        outr, outi = cr.unwrap_derotate(eqp, cr.carrier_phase(eqp))
        ser = ser_gate(torch.complex(outr, outi), ref, const)
        t_call = cuda_ms(call, 3)
        print("%s: SER %.3e after the single-grid carrier recovery (gate %.0e) on %d x 2 symbols; "
              "dual_mode_equalisation %.4f ms, %.2f Msym/s [%s]"
              % (path, ser, EQ_SER_LIMIT, EQ_NSYM, t_call, nsym_tot / t_call / 1e3, card))
        require(ser <= EQ_SER_LIMIT, "%s SER gate failed" % path)
        path_launches[path], taps[path] = launches, (w, errs)

    # B9 at the path's shapes: per stage and method, and the first 4096 errors
    # of the full launch against the 4096-symbol launch held against the plain version
    w0 = torch.as_tensor(eqops._init_taps(ntaps, 2, 2, np.complex64), device=dev)
    s1, s2 = (eqops._reshape_symbols(None, m, 64, np.complex64, 2) for m in (m1, m2))
    a1 = (P, trs, 1, 2, EQ_MU[0], w0, s1, m1, True)
    e_full, w1, _ = train_seq_cuda(*a1)
    head = (P, SEQ_TRS, 1, 2, EQ_MU[0], w0, s1, m1, True)
    e_head, w_head, mu_head = train_seq_cuda(*head)
    e_plain, w_plain, mu_plain = train_seq_plain(*head)
    same = bool(torch.equal(e_full[:, :SEQ_TRS], e_head))
    d_head = float((w_head - w_plain).abs().max())
    print("B9 at the path's shape (%d symbols): first %d errors equal the %d-symbol launch's bit "
          "for bit: %s; that launch against the plain version: taps max|d| %.3e, err max|d| %.3e; "
          "stage-1 errors equal the path's: %s"
          % (trs, SEQ_TRS, SEQ_TRS, same, d_head, float((e_head - e_plain).abs().max()),
             bool(torch.equal(e_full, taps["equaliser seq"][1][0]))))
    require(same and d_head <= TOL_SEQ_TAPS
            and float((e_head - e_plain).abs().max()) <= TOL_SEQ_ERR
            and float(((mu_head - mu_plain) / mu_plain).abs().max()) <= TOL_SEQ_MU_REL,
            "B9 at the path's shape disagrees")
    a2 = (P, trs, 1, 2, EQ_MU[1], w1, s2, m2, True)
    t_b9 = {m1: device_ms(lambda: train_seq_cuda(*a1), 3),
            m2: device_ms(lambda: train_seq_cuda(*a2), 3)}
    for m, t in t_b9.items():
        print("time B9 train_seq %s adaptive, %d symbols: %.4f ms, %.1f ns per symbol [%s]"
              % (m, trs, t, t / trs * 1e6, card))
        print_chain("B9 train_seq %s" % m, lat, trs, seq_chain_cycles(lat, 2 * ntaps, m), t, card,
                    "symbol")
    rec["B9", "equaliser seq"] = dict(
        **trainer_bound(2, 2, ntaps, 2, trs, 1), err=max(worst["taps"], d_head),
        ms=t_b9[m1], plain_ms=t_p4096, ms_at_plain_shape=t_k4096,
        shape="%d symbols, %s; plain_ms and ms_at_plain_shape at %d symbols"
              % (trs, m1, SEQ_TRS))

    # B1 at the same length, against the plain block trainer
    specs = [eqops.err_spec(m, s) for m, s in ((m1, s1), (m2, s2))]
    b1 = (P, trs, 1, 2, EQ_MU[0], w0, specs[0], True, EQ_BLOCK)
    e_p, w_p, mu_p = train_block_plain(*b1)
    e_k, w_k, mu_k = train_block_cuda(*b1)
    # the rde stage over its first blocks only (see check_block_methods)
    b2nd = (P, RDE_BLOCKS * EQ_BLOCK, 1, 2, EQ_MU[1], w_k, specs[1], True, EQ_BLOCK)
    e2_p, w2_p, mu2_p = train_block_plain(*b2nd)
    e2_k, w2_k, mu2_k = train_block_cuda(*b2nd)
    d_taps = max(float((w_k - w_p).abs().max()), float((w2_k - w2_p).abs().max()))
    d_mu = max(float(((mu_k - mu_p) / mu_p).abs().max()),
               float(((mu2_k - mu2_p) / mu2_p).abs().max()))
    d_err = max(float((e_k - e_p).abs().max()), float((e2_k - e2_p).abs().max()))
    print("B1 train_block at the path's shape (%s over %d blocks of %d, then %s over %d): taps "
          "max|d| %.3e (tol %.0e), mu rel %.3e (tol %.0e), err max|d| %.3e (tol %.0e)"
          % (m1, trs // EQ_BLOCK, EQ_BLOCK, m2, RDE_BLOCKS, d_taps, TOL_TAPS, d_mu,
             TOL_SEQ_MU_REL, d_err, TOL_SEQ_ERR))
    # over 1023 dependent blocks one differing sign test moves mu by mu^2 |e|^2
    require(d_taps <= TOL_TAPS and d_mu <= TOL_SEQ_MU_REL and d_err <= TOL_SEQ_ERR,
            "B1 at the equaliser path's shape disagrees with its plain version")
    ts = (trs // EQ_BLOCK) * EQ_BLOCK
    rec["B1", "equaliser block"] = dict(
        **trainer_bound(2, 2, ntaps, 2, ts, 1), err=d_taps,
        ms=device_ms(lambda: train_block_cuda(*b1), 5),
        plain_ms=device_ms(lambda: train_block_plain(*b1), 1),
        shape="%d blocks of %d, %s" % (trs // EQ_BLOCK, EQ_BLOCK, m1))
    print("time B1 train_block %s adaptive, %d symbols in blocks of %d: %.4f ms; %s: %.4f ms [%s]"
          % (m1, ts, EQ_BLOCK, rec["B1", "equaliser block"]["ms"], m2,
             device_ms(lambda: train_block_cuda(P, trs, 1, 2, EQ_MU[1], w_k, specs[1], True,
                                                EQ_BLOCK), 5), card))
    print_chain("B1 train_block %s (equaliser block path)" % m1, lat, trs // EQ_BLOCK,
                block_chain_cycles(lat, 2 * ntaps, EQ_BLOCK), rec["B1", "equaliser block"]["ms"],
                card, "block")

    # B2 at the path's shape, with each path's taps
    for path in ("equaliser seq", "equaliser block"):
        w = taps[path][0]
        out_p = apply_filter_plain(P, 2, w)
        out_k = apply_filter_cuda(P, 2, w)
        rms = float(out_p.pow(2).mean().sqrt())
        d_out = float((out_k - out_p).abs().max())
        print("B2 apply_filter (%s): %s max|d| %.3e (tol %.0e x rms %.3f)"
              % (path, tuple(out_k.shape), d_out, TOL_FILTER_REL, rms))
        require(out_k.shape == out_p.shape and d_out <= TOL_FILTER_REL * rms,
                "B2 disagrees with its plain version on the %s path" % path)
        rec["B2", path] = dict(**filter_bound(P, w, out_k), err=d_out,
                               ms=device_ms(lambda: apply_filter_cuda(P, 2, w), 50),
                               plain_ms=device_ms(lambda: apply_filter_plain(P, 2, w), 10),
                               shape="2 x 2^19 samples in, no side output")
        rec["B2", path]["library_ms"] = filter_library(P, 2, w, out_k)
    print_times(rec, card)
    return rec, path_launches


def pilot_phases(dev, card):
    """Phases 9-12: the pilot serving chain. Returns (kernel records, launches per path)."""
    t0 = time.perf_counter()
    tx = make_pilot_tx(PILOT_TX_FRAMES, frame_len=PILOT_FRAME, seq_len=PILOT_SEQ,
                       ins_rat=PILOT_RAT)   # no device named: the card
    torch.cuda.synchronize()
    pr, pi = tx.planes[:2], tx.planes[2:]
    print("pilot tx: %d frames of SignalWithPilots(64, %d, %d, %d) x 2 pol, planes %s, "
          "%.2f s on the card" % (PILOT_TX_FRAMES, PILOT_FRAME, PILOT_SEQ, PILOT_RAT,
                                  tuple(tx.planes.shape), time.perf_counter() - t0))

    def build(frames, return_phase):
        return make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, PILOT_FRAME, PILOT_RAT,
                                   frames=range(frames), return_phase=return_phase,
                                   **PILOT_CFG)
    chain = build(PILOT_FRAMES, False)
    st = pilot_stages(chain, pr, pi)
    rec = check_pilot_kernels(chain, st, card)

    # phase 10: the main path, counted, gated, and its synchronising calls
    ((dr, di), info), launches = counted(lambda: chain.planes(pr, pi))
    print("pilot main path launches: %s" % launches)
    require(launches == expected({"B4": 1, "B2 frames": 1, "B5": 1}),
            "the pilot path did not launch each kernel as expected")
    nd = tx.idx_tx.shape[-1]
    require(tuple(dr.shape) == (2, PILOT_FRAMES * nd) and dr.shape == di.shape,
            "payload shape %s" % (tuple(dr.shape),))
    require(bool(torch.isfinite(dr).all() and torch.isfinite(di).all()), "non-finite payload")
    gate = ber_gate(dr, di, tx, info["sync_corr"])
    print("pilot main path: BER %.3e SER %.3e over 2 x %d x %d payload symbols, sync_corr %.1f, "
          "shift %s, mode_order %s" % (gate["ber"], gate["ser"], PILOT_FRAMES, nd,
                                       gate["sync_corr"], info["shift"].tolist(),
                                       info["mode_order"].tolist()))
    require(gate["ok"], "pilot BER gate failed (BER <= 1e-5 and sync_corr >= 120)")
    syncs = syncs_in(lambda: chain.planes(pr, pi))
    print("pilot dispatch: %d synchronising calls under torch.cuda.set_sync_debug_mode('warn')%s"
          % (len(syncs), "".join("\n  " + s for s in syncs)))

    # phase 11: return_phase=True at a smaller depth, tracking, card vs CPU
    phase_chain = build(PHASE_FRAMES, True)
    ((pdr, pdi), pinfo), launches_rp = counted(lambda: phase_chain.planes(pr, pi))
    print("return_phase=True chain (%d frames) launches: %s" % (PHASE_FRAMES, launches_rp))
    require(launches_rp == expected({"B2 frames": 1, "B6": 1}),
            "the return_phase path did not launch B6 alone")
    d_pay = max(float((pdr - dr[:, :PHASE_FRAMES * nd]).abs().max()),
                float((pdi - di[:, :PHASE_FRAMES * nd]).abs().max()))
    print("return_phase=True payload vs serving payload: max|d| %.3e (tol %.0e), phase %s"
          % (d_pay, TOL_PAYLOAD, tuple(pinfo["phase"].shape)))
    require(d_pay <= TOL_PAYLOAD, "the return_phase payload differs from the serving payload")
    (tr, ti), _ = chain.tracking_planes(pr, pi, info["taps"], info["shift"], info["mode_order"])
    exact = bool(torch.equal(tr, dr) and torch.equal(ti, di))
    print("pilot tracking_planes == planes payload: %s" % exact)
    require(exact, "pilot tracking output differs from the full chain")

    small = make_pilot_tx(6, frame_len=2 ** 14, seq_len=512, device="cpu")
    scfg = dict(PILOT_CFG, Ntaps=17, frames=(0, 1, 2), return_phase=False)
    runs = []
    for d in ("cpu", dev):
        sch = make_pilot_rx_chain(small.pilot_seq, small.ph_pilots, 2 ** 14, PILOT_RAT, **scfg,
                                  device=d)
        (sr, si), sinfo = sch.planes(small.planes[:2].to(d), small.planes[2:].to(d))
        runs.append((torch.complex(sr, si).cpu(), {k: v.cpu() for k, v in sinfo.items()}))
    coded = torch.as_tensor(small.coded)
    agree = float((decision_idx(runs[0][0], coded) == decision_idx(runs[1][0], coded))
                  .double().mean())
    same_state = all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in ("shift", "mode_order"))
    print("small pilot capture (2^14 frame, 512 sequence, 3 frames, 17 taps): card vs plain "
          "CPU chain agree on %.6f of decisions (min %.3f); shift/mode_order equal: %s; "
          "max|d| %.3e" % (agree, SMALL_AGREE, same_state,
                           float((runs[0][0] - runs[1][0]).abs().max())))
    require(agree >= SMALL_AGREE and same_state, "the card's pilot chain disagrees with the CPU's")

    # phase 12: times
    npay = 2 * PILOT_FRAMES * nd
    t_full = cuda_ms(lambda: chain.planes(pr, pi), 10)
    t_trk = cuda_ms(lambda: chain.tracking_planes(pr, pi, info["taps"], info["shift"],
                                                  info["mode_order"]), 10)
    h0 = time.perf_counter()
    for _ in range(5):
        chain.planes(pr, pi)
    torch.cuda.synchronize()
    t_host = (time.perf_counter() - h0) / 5 * 1e3
    busy, nk, events = device_busy(lambda: chain.planes(pr, pi), 3)
    busy_trk, nk_trk, _ = device_busy(lambda: chain.tracking_planes(
        pr, pi, info["taps"], info["shift"], info["mode_order"]), 3)
    print("time pilot chain.planes (%d frames): %.4f ms, %.1f payload Msym/s (host clock "
          "%.4f ms); device busy %.4f ms in %d device ops per call, busy share %.3f [%s]"
          % (PILOT_FRAMES, t_full, npay / t_full / 1e3, t_host, busy, nk, busy / t_full, card))
    print("time pilot chain.tracking_planes (%d frames): %.4f ms, %.1f payload Msym/s; device "
          "busy %.4f ms in %d device ops per call, busy share %.3f [%s]"
          % (PILOT_FRAMES, t_trk, npay / t_trk / 1e3, busy_trk, nk_trk, busy_trk / t_trk, card))
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / 3
    for name_k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print("time pilot dispatch device op %.4f ms per call: %s [%s]" % (ms, name_k[:90], card))
    P, wxs, best_w, mode_order, eqsh, taps, symr, symi, cargs = (st[k] for k in (
        "P", "wxs", "best_w", "mode_order", "eqsh", "taps", "symr", "symi", "cargs"))
    a, b = cpe_coeffs(*cargs)
    outr, outi = interp_rotate(symr, symi, a, b, chain.cpe_dx, -1)
    stages = {
        "sync search (%d windows, batched CMA)" % chain.W: lambda: chain.sync_search(P),
        "alignment (filter, FOE, xcorr, assignment)": lambda: chain.align(P, wxs, best_w),
        "LS solve": lambda: chain.ls_taps(P, eqsh, mode_order),
        "frame filter (B2 frames)": lambda: chain.frame_filter(P, eqsh, taps),
        "CPE coefficients (B5)": lambda: cpe_coeffs(*cargs),
        "derotation (B4)": lambda: interp_rotate(symr, symi, a, b, chain.cpe_dx, -1),
        "payload extraction": lambda: chain.payload(outr, outi),
    }
    total = 0.0
    for k, fn in stages.items():
        st_busy, st_nk, _ = device_busy(fn, 3)
        st_wall = cuda_ms(fn, 5)
        total += st_busy
        print("time pilot stage %s: device busy %.4f ms in %d device ops (%.1f%% of the "
              "dispatch's busy time), stream time alone %.4f ms [%s]"
              % (k, st_busy, st_nk, 100 * st_busy / busy, st_wall, card))
    print("time pilot stages' device busy sum: %.4f ms vs the dispatch's %.4f ms busy, %.4f ms "
          "stream time [%s]" % (total, busy, t_full, card))
    return rec, {"pilot": launches, "pilot return_phase": launches_rp}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card",
              file=sys.stderr)
        return 1
    # the plain versions run on the card too: keep their products in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print("device: %s (torch %s, CUDA %s)" % (name, torch.__version__, torch.version.cuda))
    print(card)

    t0 = time.perf_counter()
    _build.library()
    print("build: %.2f s (%s)" % (time.perf_counter() - t0, _build.build_dir()))
    trainer_build_report()
    lat = probe_phase(dev, card)

    t0 = time.perf_counter()
    E, syms, const = make_tx(NSYM)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    ref = torch.as_tensor(syms, device=dev)
    print("tx: %d symbols x 2 pol, planes %s, %.2f s on the host"
          % (NSYM, tuple(P.shape), time.perf_counter() - t0))
    chain = make_rx_chain(**CFG)          # no device named: the card

    rec = check_kernels(P, chain, card, lat)

    # phase 4: the main path, counted
    (outr, outi), launches = counted(lambda: chain.planes(P))
    print("main path launches: %s" % launches)
    require(launches == expected({"B1": 2, "B2": 1, "B3": 1, "B4": 1}),
            "the main path did not launch each kernel as expected")
    Lout = (P.shape[-1] - CFG["Ntaps"]) // CFG["os"] + 1
    require(tuple(outr.shape) == (2, Lout) and tuple(outi.shape) == (2, Lout),
            "output shape %s" % (tuple(outr.shape),))
    require(bool(torch.isfinite(outr).all() and torch.isfinite(outi).all()),
            "non-finite output")
    ser = ser_gate(torch.complex(outr, outi), ref, const)
    print("main path SER %.3e (gate %.0e) on %d x 2 symbols" % (ser, SER_LIMIT, NSYM))
    require(ser <= SER_LIMIT, "SER gate failed")

    # small capture: the card's chain against the plain chain on the CPU
    Es, syms_s, _ = make_tx(2 ** 15, seed=2)
    o_cpu = make_rx_chain(**CFG, device="cpu").forward(torch.as_tensor(Es))
    o_gpu = chain.forward(torch.as_tensor(Es, device=dev)).cpu()
    trim = slice(GATE_TRIM, -GATE_TRIM)
    agree = float((decide(o_cpu[:, trim], const) == decide(o_gpu[:, trim], const))
                  .double().mean())
    ser_s = [ser_gate(o, torch.as_tensor(syms_s), const) for o in (o_cpu, o_gpu)]
    print("small capture (2^15 x 2 symbols): card vs plain CPU chain agree on %.6f of "
          "decisions (min %.3f); SER cpu %.2e, card %.2e; max|d| %.3e"
          % (agree, SMALL_AGREE, ser_s[0], ser_s[1], float((o_cpu - o_gpu).abs().max())))
    require(agree >= SMALL_AGREE and max(ser_s) <= SER_LIMIT,
            "the card's chain disagrees with the plain chain")

    # phase 5: tracking contract
    (fr, fi), w = chain.planes_with_taps(P)
    tr, ti = chain.tracking_planes(P, w)
    exact = bool(torch.equal(tr, fr) and torch.equal(ti, fi))
    print("tracking_planes == planes_with_taps output: %s" % exact)
    require(exact, "tracking output differs from the full chain")

    # phase 6: times
    nsym_tot = NSYM * 2
    t_full = cuda_ms(lambda: chain.planes(P), 10)
    t_trk = cuda_ms(lambda: chain.tracking_planes(P, w), 20)
    h0 = time.perf_counter()
    for _ in range(10):
        chain.planes(P)
    torch.cuda.synchronize()
    t_host = (time.perf_counter() - h0) / 10 * 1e3
    print("time chain.planes: %.4f ms, %.1f Msym/s (host clock %.4f ms) [%s]"
          % (t_full, nsym_tot / t_full / 1e3, t_host, card))
    print("time chain.tracking_planes: %.4f ms, %.1f Msym/s [%s]"
          % (t_trk, nsym_tot / t_trk / 1e3, card))
    eqp, decp = chain.equalise(P, w)
    idxd = chain.phase_search(decp)
    no = eqp.shape[0] // 2
    er_p, ei_p, a, b = decimated_derotation_inputs(eqp[:no], eqp[no:], idxd, chain.lo_a,
                                                   chain.step_a, chain.dec)
    stages = {
        "train (2x B1 + guard)": device_ms(lambda: chain.train_taps(P), 10),
        "filter (B2)": device_ms(lambda: chain.equalise(P, w), 20),
        "bps (B3)": device_ms(lambda: chain.phase_search(decp), 20),
        "glue (unwrap, coeffs, pad)": device_ms(lambda: decimated_derotation_inputs(
            eqp[:no], eqp[no:], idxd, chain.lo_a, chain.step_a, chain.dec), 20),
        "interp-rotate (B4)": device_ms(lambda: interp_rotate(er_p, ei_p, a, b, chain.dec, 1),
                                      20),
    }
    for k, v in stages.items():
        print("time stage %s: %.4f ms device (%.1f%% of the chain's stream time) [%s]"
              % (k, v, 100 * v / t_full, card))
    print("time stages' device sum: %.4f ms vs chain stream time %.4f ms: %.4f ms host-bound "
          "gaps [%s]" % (sum(stages.values()), t_full, t_full - sum(stages.values()), card))

    # phases 7 and 8: the per-sample modes on the same capture; B1 runs there
    # at the blind path's shapes (the same training)
    rec = {(k, "blind"): dict(v, shape="blind path") for k, v in rec.items()}
    rec.update(check_sample_kernels(P, w, card))
    path_launches = {"blind": launches}
    for mode in ("twostage", "single"):
        path_launches["blind " + mode] = sample_path(mode, P, ref, const, card)
        rec["B1", "blind " + mode] = rec["B1", "blind"]

    prec, pilot_launches = pilot_phases(dev, card)
    rec.update(prec)
    path_launches.update(pilot_launches)

    # phases 13-15: the granular equaliser
    seq_check = check_seq_kernel(dev, card)
    check_block_methods(P, chain, card)
    del P
    erec, eq_launches = equaliser_phases(dev, card, seq_check, lat)
    rec.update(erec)
    path_launches.update(eq_launches)
    print("launches per path: %s" % path_launches)
    # one record per kernel and path that launched it: that path's count and
    # the error and times measured at that path's shapes
    kernels = [{"name": KERNELS[k][0], "path": path, "route": "cuda", "source": KERNELS[k][1],
                "replaces": KERNELS[k][2], "launches": path_launches[path][k],
                "max_abs_err": rec[k, path]["err"],
                **{key: val for key, val in rec[k, path].items() if key != "err"}}
               for path in PATHS for k in KERNELS if path_launches[path][k]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
