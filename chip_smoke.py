#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's blind receiver once on one CUDA card and check it.

Run from the repository root, with one card visible: ``python3 chip_smoke.py``.

Phases, each fatal on failure (the script then exits non-zero and prints no
result line):

1. device: a CUDA card must be present (no CPU fallback); prints its name
   and ``nvidia-smi``'s name and power limit;
2. build: compiles the four kernels (B1-B4) from ``qampy_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with the stated tolerance;
4. main path: ``workload.make_tx(2**20)`` through ``RxChain.planes`` on the
   card with the bench configuration; SER gate <= 1e-5, launch counts
   B1=2, B2=1, B3=1, B4=1 for that one call, and agreement with the plain
   chain on the CPU on a small capture;
5. tracking: ``tracking_planes`` with the chain's own taps equals the full
   output exactly;
6. times (CUDA events after warm-up): the chain and the tracking entry with
   their Msym/s as a caller sees them (back-to-back calls, host dispatch
   included), then the device time of each stage and of each kernel beside
   its plain version (calls queued behind a spacer kernel, host hidden).

The line before the last is ``{"kernels": [...]}``; the last line is the
device record ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.chain import decimated_derotation_inputs, make_rx_chain
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter_cuda, apply_filter_plain,
                                                train_block_cuda, train_block_plain)
from qampy_tpu_torch.ops.phase_cuda import (bps_search_cuda, bps_search_plain, interp_rotate,
                                            interp_rotate_cuda, interp_rotate_plain)
from qampy_tpu_torch.workload import GATE_TRIM, decide, make_tx, ser_gate

NSYM = 2 ** 20
CFG = dict(M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3, bps_angles=64,
           bps_N=12, block_size=256, TrSyms=2 ** 14, bps_mode="decimated16")
SER_LIMIT = 1e-5
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
# kernel: (wrapper name, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "B1": ("train_block", "qampy_tpu_torch/csrc/equaliser.cu",
           "qampy_tpu/ops/equaliser_pallas.py:296"),
    "B2": ("apply_filter", "qampy_tpu_torch/csrc/equaliser.cu",
           "qampy_tpu/ops/equaliser_pallas.py:539"),
    "B3": ("bps_search", "qampy_tpu_torch/csrc/phase.cu", "qampy_tpu/ops/phase_pallas.py:206"),
    "B4": ("interp_rotate", "qampy_tpu_torch/csrc/phase.cu",
           "qampy_tpu/ops/phase_pallas.py:695"),
}


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


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def check_kernels(P, chain, card):
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
        err=d_taps,
        ms=device_ms(lambda: train_block_cuda(P, trs, 1, os_, mu, w0, s1, True, S), 20),
        plain_ms=device_ms(lambda: train_block_plain(P, trs, 1, os_, mu, w0, s1, True, S), 3))

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
    rec["B2"] = dict(err=max(d_out, d_dec),
                     ms=device_ms(lambda: apply_filter_cuda(P, os_, w, chain.dec), 50),
                     plain_ms=device_ms(lambda: apply_filter_plain(P, os_, w, chain.dec), 10))

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
    rec["B3"] = dict(err=float(d_idx), ms=device_ms(lambda: bps_search_cuda(*args), 50),
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
    rec["B4"] = dict(err=d_rot, ms=device_ms(lambda: interp_rotate_cuda(*rargs), 50),
                     plain_ms=device_ms(lambda: interp_rotate_plain(*rargs), 10))
    for k, v in rec.items():
        print("time %s (device): kernel %.4f ms, plain %.4f ms [%s]"
              % (k, v["ms"], v["plain_ms"], card))
    return rec


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

    t0 = time.perf_counter()
    E, syms, const = make_tx(NSYM)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    ref = torch.as_tensor(syms, device=dev)
    print("tx: %d symbols x 2 pol, planes %s, %.2f s on the host"
          % (NSYM, tuple(P.shape), time.perf_counter() - t0))
    chain = make_rx_chain(**CFG, device=dev)

    rec = check_kernels(P, chain, card)

    # phase 4: the main path, counted
    counters = {"B1": train_block_cuda, "B2": apply_filter_cuda, "B3": bps_search_cuda,
                "B4": interp_rotate_cuda}
    for fn in counters.values():
        fn.launches = 0
    outr, outi = chain.planes(P)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    print("main path launches: %s" % launches)
    require(launches == {"B1": 2, "B2": 1, "B3": 1, "B4": 1},
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

    kernels = [{"name": name_k, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[k], "max_abs_err": rec[k]["err"], "ms": rec[k]["ms"],
                "plain_ms": rec[k]["plain_ms"]}
               for k, (name_k, source, replaces) in KERNELS.items()]
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
