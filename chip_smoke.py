#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's receivers once on one CUDA card and check them.

Run from the repository root, with one card visible: ``python3 chip_smoke.py``.

Phases, each fatal on failure (the script then exits non-zero and prints no
result line):

1. device: a CUDA card must be present (no CPU fallback); prints its name
   and ``nvidia-smi``'s name and power limit;
2. build: compiles the kernels (B1-B9, B2's frame entry and the latency
   probe) from ``qampy_tpu_torch/csrc``, one ``nvcc`` per source, and fails
   on a register spill in any instance of B1, B2, B3, B5, B7, B8 or B9; then the probe
   (``csrc/probe.cu``): the card's latencies of a dependent add, a shuffle
   and add, rde's register lookup and a CTA barrier, from which the chain
   bounds of the two trainers are reckoned, B9's straight-line division
   against ``__fdiv_rn`` on 2^22 operand pairs (none may differ), and the
   JAX package's cost probes asked of the H100 (K5: an empty launch, a copy
   of the pilot capture at two thread and CTA counts, an argmin over 64
   candidates, complex64 to planes), each beside its byte bound;
3. blind kernels: B1-B4 against their plain PyTorch versions on the card, at
   the blind path's shapes, with the stated tolerance (B2, at every path's
   shapes: two launches bit-equal, its launch plan printed beside its time);
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
   shapes, B8 and B7 against their plain versions at 2 x 2^20 samples (B7
   also bit for bit against B6 rotating by the plain unwrap), each with its
   launch plan;
8. blind twostage and blind single: the bench's attempts 3 and 4
   (``bps_mode="twostage"``/``"single"``, bps_N=14) through ``RxChain.planes``
   on the same capture; SER <= 1e-5 (twostage) and <= 1e-4 (single), launch
   counts B1=2, B2=1, B3=1, B8=1 (twostage only), B7=1, tracking bit-exact,
   decisions shared with the plain CPU chain on a small capture, and times
   (chain, tracking, each stage);
8b. the reference's last selectable modes on the same capture, each through
   ``RxChain.planes`` as phase 8 runs its modes (counted, gated, tracking
   bit-exact, shared with the plain CPU chain on a small capture, timed by
   stage): "blind decimated16 bf16" (the bench's headline mode with
   ``bps_win="bf16"``, SER <= 1e-5), "blind twostage bf16" (B3 and B8 with
   bf16 windows, <= 1e-5), "blind twostage-dec" (``bps_N=14``, B2's stride-8
   side output, <= 1e-4, the gate of ``single``), "blind fuse_derot off"
   (decimated16, whose derotation is B4 either way: bit-equal to phase 4's
   output, <= 1e-5) and "blind pallas off" (decimated16 without the kernels'
   filter: the reference's warning, then single with the unfused unwrap and
   B6, <= 1e-4); B3 and B8 with bf16 windows bit-equal to their bf16 twins at
   each path's shape, beside the float32 kernel's time and a bound in which
   the window adds count at the packed-bf16 rate; then a sweep of both at
   N = 1, 3, 4, 7, 8, 12, 14, 32, 60, 63, 64 (the reference tiles in turn):
   bit-equal or the run fails;
9. pilot kernels: ``workload.make_pilot_tx(244)`` built on the card; B2's
   frame entry (every one of the 240 frames; with its pilot side output the
   main output bit-equal to the entry's without it, and the side output
   bit-equal to the main output's pilot columns, both timed), B5 from that
   side output and strided from the filter output (its sector floor beside
   its byte bound), B4 and B6 against their plain versions at the pilot
   path's shapes (480 rows of 2^16 symbols); B5 at rows of 4,097, 8,160 and
   32,736 pilots in both forms;
10. pilot main path: one dispatch of the LS pilot chain over frames 0-239
   through ``PilotRxChain.planes``; BER <= 1e-5 with sync_corr >= 120,
   launch counts B2 frames=1, B5=1, B4=1 and no other kernel (B5 reads the
   frame filter's pilot side output), and the synchronising calls seen in
   that dispatch;
11. pilot variants: the ``return_phase=True`` chain over 8 frames (B6 once,
   B5 never, payload within 1e-4 of the serving chain's), tracking bit-exact,
   and the card's chain against the plain CPU chain on a small capture;
12. pilot times: the dispatch and the tracking entry in payload Msym/s, the
   device time of each stage, and each new kernel beside its plain version;
   then the path "pilot long frames": ``make_pilot_tx(20, frame_len=2**18)``
   (8,160 CPE pilots a row) over 16 frames through ``PilotRxChain.planes``,
   launches B2 frames=1, B5=1, B4=1, BER <= 1e-5 with sync_corr >= 120,
   tracking bit-exact, its kernels against their plain versions, and the
   capture of seed 3, whose frame sync fails in the reference too, held to
   the plain CPU chain (shift, mode_order, sync_corr, the gate's outcome);
12b. the pilot chain's other configurations, each counted, gated and held to
   its plain versions: "pilot lms", the bench's LMS chain (``eq_trainer="lms"``,
   mu (1e-3, 1e-3), Niter 30) over the same 240 frames, launches B1 = 3 (one
   batched launch a stage, a row per output mode), B2 frames, B5, B4 = 1,
   tracking bit-exact, B1 batched against the plain trainer's batch and
   each row bit-equal to a launch of its own, beside its chain bound, the
   dispatch timed and its LMS training beside the LS solve; "pilot
   non-blocked", ``cpe_pilot_rat=2`` over 16 frames (the general frame body:
   B2 frames and B6 once), and its card chain against the CPU's on a small
   capture; "pilot foe", ``make_pilot_tx(20, freq_off=20e6)`` through the
   LMS chain with ``foe_comp=True`` (B1 3, B2 frames, B5, B4), tracking with
   ``foe=info["foe_pil"]`` bit-exact, held to the plain CPU chain (seeds
   taken in order until one passes the gate; a capture whose frame sync
   fails must fail on the CPU too); "pilot granular", ``ops/pilots.py`` step
   by step on a small capture (``frame_sync``: B9 once a window, B2;
   ``equalize_pilot_sequence``: B1 a stage, B2; the frames filtered, B2;
   ``pilot_based_cpe``), under the BER gate, the search held to the CPU's;
12c. the pilot chain's frame schedules on the 240-frame cell, each timed
   beside ``"scan"`` in turn (scan, schedule, schedule, scan): "pilot span"
   (``frames_mode="span"``: the batched frame body, B2 frames, B5 and B4
   once each, on windows cut from one clamped span; payload within 1e-4 of
   the scan's, the reference's bound) and "pilot frames_pack 2" (the
   batched body over all the frames; payload bit-equal to the scan's);
   BER <= 1e-5 with sync_corr >= 120, no synchronising call, the tracking
   entry bit-exact; the kernels run at the scan's shapes, whose records
   phase 12 holds;
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
   repeat bit for bit; and each B9 stage with a fixed step in one launch
   against 64 launches of 4096 symbols that hand taps and step on, bit for
   bit), and the times of the calls, the stages and the kernels, B9's and
   B1's beside their chain bounds;
16. grid kernels: on a rectangular 8 x 4 grid, cross 32- and 128-QAM, the
   warped 64- and 256-point alphabets and 32-APSK (``workload.warped_qam``,
   ``apsk_const``), B3 at the single (64 angles, N=14) and the twostage
   coarse (16 angles, N=60) shape and B8 (8 offsets, N=14) on 2 x 2^20
   samples made on the card, indices and phases equal to the plain versions
   off near-ties; B1's sbd, mddma and dd over 8 blocks on a capture of each
   alphabet from the taps of its mcma stage (taps within 3e-7, two launches
   bit-equal);
17. grid paths: ``make_rx_chain(M=32)`` in ``single`` and ``decimated16``
   mode on ``make_tx(2**20, M=32)``, ``make_rx_chain(symbols=warped_qam(64))``
   in ``twostage`` (both searches on the fitted grid, B1 decides on the
   points) and ``single`` (B3 on the points) and
   ``make_rx_chain(symbols=apsk_const(32))`` in ``twostage`` (B3 and B8 on
   the points), methods (mcma, sbd): each counted (B1=2, B2=1, B3=1, then B7,
   B8 and B7, or B4), under the nearest-point SER gate <= 1e-4, tracking
   bit-exact, decisions shared with the plain CPU chain on a small capture,
   timed with its stage split, and each of its kernels against its plain
   version on that path's own inputs.
18. phase recovery (BASELINE config 3, ``examples/phase_recovery.py``) on the
   port's signal objects at 2 x 2^20 symbols, built on the card
   (``SignalQAMGrayCoded(..., fb=40e9)``: the bits on the host, the symbols,
   and ``core.impairments`` on the card's generator): "phase bps",
   ``phaserec.bps(sig, 64, 14)`` on 64-QAM at 30 dB and a 100 kHz linewidth
   (B3 and B6 once each, no synchronising call, SER <= 1e-4 per mode after
   20 edge symbols); "phase twostage", ``phaserec.bps_twostage(sig, 32, 14,
   B=8)`` on the same capture (B3, B8 and B6 once each, no synchronising
   call, the same gate); "phase vv", QPSK at 25 dB, 100 Hz and a 50 MHz
   offset through ``find_freq_offset(fft_size=2**16)`` (within 2 fb / 2^16),
   ``comp_freq_offset`` and ``viterbiviterbi(N=11)`` (SER <= 1e-3); "phase
   partition", 16-QAM at 30 dB and 50 Hz through
   ``phase_partition_16qam(Nblock=128)`` (SER <= 1e-2 after 200); "phase
   metrics", 16-QAM at 12 dB, noise only: ``cal_ser`` within 5 % of
   ``theory.ser_vs_es_over_n0_qam`` and ``est_snr`` within 0.3 dB, with
   ``cal_ber``, ``cal_evm`` and ``cal_gmi`` printed; each sub-path counted
   (the last three launch no kernel) and timed (CUDA events, and the device
   busy share from the profiler), B3 (A = 64 and 32, N = 14), B8 (B = 8, N =
   14) and B6 (full rate) against their plain versions on the path's own
   inputs (B6 bit for bit), and the plain unwrap timed.
19. the BASELINE configurations that start on the transmitter side, built
   by the port's signal objects and impairments on the card: "baseline cma"
   (config 1, ``examples/cma_equaliser.py``: QPSK at 2 x 2^20 symbols,
   ``resample(2 fb, beta=0.1)``, ``impairments.change_snr(14)``,
   ``apply_PMD(pi/5.65, 100 ps)``, then ``equalisation.equalise_signal(...,
   method="cma", adaptive_stepsize=True, apply=True)``: B1 and B2 once,
   SER <= 1e-4); "baseline pilot" (config 4, ``examples/sim_pilot_txrx.py``
   with 16 frames: ``simulate_transmission``, ``sync2frame`` (B9 a search
   window, B2), ``corr_foe``, ``pilot_equaliser`` (B1 a stage, B2 frames
   once), ``pilot_cpe``; then ``pilot_equaliser_nframes`` over frames 0-14,
   B2 frames once a frame) and "baseline tx" (config 5, the chain of
   ``examples/tx_impairment_simulation.py`` with 16 frames: the DAC's Bessel
   IIR, amplifier and modulator on 2 x 2^21 samples, then the same
   receiver). The pilot paths take the first seed that syncs and are gated
   at BER <= max(2 b, 1e-5), b the JAX example's mean BER, and GMI per mode
   (5.5; 5.4 for config 5, whose reference reaches 5.49). Each path runs
   under the sync debug mode (syncs reported), is counted, timed by stage
   (the DAC's IIR beside its byte bounds), held to the port's plain CPU run
   on a small capture (decisions shared >= 99.9 %, both under the gates),
   and each kernel it launched against its plain version at its first call.
20. the multi-device receivers on ``torch.distributed`` (see ``sharded_phase``).
21. profiling: ``profiling.run_benchmarks()`` at the reference's 2^18 symbols,
   each group's Msym/s with its route (B1 once a ``train_<method>``, B2
   once for ``apply_filter``, B3 once for ``bps``, no kernel in
   ``decision``, ``soft_llr``, ``select_angles``: counted), and B1 (40
   taps, os 2, blocks of 64: every method over 8 blocks within 3e-7, cma
   and mcma over the group's 1,023), B2 (within 1e-6 of the rms) and B3
   (equal off near-ties) against their plain versions at the groups'
   shapes; and the host's numpy PRBS at 2^20 bits.
22. long capture: tests/test_long_capture.py at its own size. "long blind":
   2^22 symbols of 16-QAM in 4 dispatches of 2^20 with the halo, one
   alignment for every chunk and SER < 5e-3 a chunk, launches B1/B2/B3/B7 =
   2/1/1/1 a dispatch; "long pilot": a 69-frame capture, the LMS chain in
   full over frames 0-16, then 3 tracking dispatches at ``_frame_base = d
   17 2^16 2``, each with launches B2 frames/B5/B4 = 1/1/1, no
   synchronising call, bit-equal to a chain built over its own frames, SER
   < 1e-2 on the first and last frame of every dispatch; times by CUDA
   events and each kernel at those shapes against its plain version.
23. examples: every ``examples_torch`` script's ``main`` on the card at its
   own sizes, its gated figures and wall time printed, failing on any gate.

Beside every kernel's time stand its bound (the larger of its bytes over
the card's 3.35 TB/s and its operations over the card's 67 TFLOP/s in
float32, both counted from this run's shapes; bf16 window adds at two per
float32 operation, the packed rate) and, where one PyTorch call
computes the same function (the filters: ``conv1d``), that call's time. The
trainers B1 and B9 are chains of dependent steps that no roofline bound
describes: beside their times stands a chain bound as well, the steps times
the latency of one step's critical path, from a written count of dependent
operations (``seq_chain_cycles``, ``block_chain_cycles``) and the latencies
the probe measured in this run.

Every time is printed with the card's name and power limit. The line before
the last is ``{"kernels": [...]}``, one record per kernel and path that
launched it, with the kind of constellation it decided on (``grid``), that
path's launch count and the error, times and bound at that path's shapes;
the last line is the device record ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import scipy.signal as scisig
import torch
import torch.nn.functional as F

from qampy_tpu_torch.core.metrics import decision_idx
from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.chain import (TWOSTAGE_B, TWOSTAGE_N1, cma_singularity_guard,
                                       decimated_derotation_inputs, make_rx_chain)
from qampy_tpu_torch.ops import equaliser_cuda as eqcuda
from qampy_tpu_torch.ops import phase_cuda as phcuda
from qampy_tpu_torch.ops import pilots
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter_cuda, apply_filter_frames,
                                                apply_filter_frames_cuda,
                                                apply_filter_frames_plain, apply_filter_plain,
                                                chain_latencies, div_check, filter_plan,
                                                train_block_cuda,
                                                train_block_plain, train_seq_cuda,
                                                train_seq_plain)
from qampy_tpu_torch.ops.phase_cuda import (bps_fine, bps_fine_cuda, bps_fine_plain, bps_plan,
                                            bps_search_cuda, bps_search_plain, cpe_coeffs,
                                            cpe_coeffs_cuda, cpe_coeffs_plain, cpe_plan,
                                            fine_plan,
                                            interp_rotate, interp_rotate_cuda,
                                            interp_rotate_plain, quarter_unwrap, rotate_cuda,
                                            rotate_plain, unwrap_derotate_cuda,
                                            unwrap_derotate_plain, unwrap_plan)
from qampy_tpu_torch import equalisation, helpers, phaserec, prbs, profiling, theory
from qampy_tpu_torch import impairments as port_imp
from qampy_tpu_torch.core import impairments as core_impairments
from qampy_tpu_torch.core.filter import prefix_powers
from qampy_tpu_torch.ops.pilot_chain import derotate_planes, make_pilot_rx_chain
from qampy_tpu_torch.parallel import init_distributed, make_mesh, sharded
from qampy_tpu_torch.signals import SignalQAMGrayCoded, SignalWithPilots, cal_pilot_idx
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.workload import (GATE_TRIM, apsk_const, ber_gate, decide, make_pilot_tx,
                                      make_tx, ser_gate, shared_decisions, warped_qam)

NSYM = 2 ** 20
CFG = dict(M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3, bps_angles=64,
           bps_N=12, block_size=256, TrSyms=2 ** 14, bps_mode="decimated16")
SER_LIMIT = 1e-5
# the bench's blind attempts 3 and 4 (bench.py:656-657, 182-185) and their gates
SAMPLE_CFG = dict(CFG, bps_N=14)
SAMPLE_GATES = {"twostage": 1e-5, "single": 1e-4}
# this slice (phases 16, 17): the reference's cross and general-alphabet benches
# (tools/qam32_bench.py, tools/genbench.py) and their gate
GRID_CFG = dict(Ntaps=17, os=2, methods=("mcma", "sbd"), mu=1.9e-3, bps_angles=64,
                block_size=256, TrSyms=2 ** 14)
GRID_SER_LIMIT = 1e-4
# (path, alphabet, the mode's arguments): every new branch of B1, B3 and B8 is launched by a
# chain. The warped alphabet's twostage searches run on its fitted grid (B1 alone decides on
# the points there); its single search and the ring alphabet's two stages run on the points
GRID_PATHS = (("cross32 single", "cross32", dict(bps_N=14, bps_mode="single")),
              ("cross32 decimated16", "cross32", dict(bps_N=12, bps_mode="decimated16")),
              ("warped64 twostage", "warped64", dict(bps_N=14, bps_mode="twostage")),
              ("warped64 single", "warped64", dict(bps_N=14, bps_mode="single")),
              ("apsk32 twostage", "apsk32", dict(bps_N=14, bps_mode="twostage")))
# seed of the 2^15-symbol capture for the card-against-CPU comparison: the blind mcma
# stage locks onto the ring alphabet on few short captures, in both packages (seed 4 of
# 1-5 at 2^15 symbols, seed 1 of 1-5 at 2^16); the 2^20-symbol capture of seed 1 does lock
SMALL_SEED = {"apsk32": 4}
GRID_BLOCKS = 8          # blocks over which B1's decision methods are held to the plain version
TOL_GRID_TAPS = 3e-7     # B1 taps after those blocks: what every method measured on the H100
TOL_GRID_ERR = 1e-5      # B1 per-sample error there
# B1 at a path's own depth of 64 blocks: a decision is discontinuous, so one rounding
# difference at a boundary moves one error by a level spacing and a tap by up to
# mu |d e| |x|, about 1.9e-3 x 0.4 x 2, which the recurrence then contracts. Where the two
# error traces never part the taps are held to the 8 blocks' bound (on the H100 none parted
# on any path), else to the step of one flipped decision; the outputs to shared decisions
TOL_GRID_TAPS_DEPTH = 2e-3
# kernel vs plain tolerances: float32 on both sides, summed in other orders
TOL_TAPS = 1e-4          # B1 taps after 64 dependent blocks
TOL_MU_REL = 1e-5        # B1 final step size
TOL_ERR = 1e-4           # B1 per-sample error
TOL_FILTER_REL = 1e-5    # B2, relative to the output rms
TOL_ROTATE = 1e-5        # B4, absolute (phases of many radians)
TIES_MAX = 1e-3          # B3, B8: share of near-tied positions allowed to differ
TIE_REL = 1e-5           # B3, B8: best two window sums within this are a near-tie
TIE_REL_GEN = 1e-6       # the same on a general alphabet's scores (see tie_rule),
TIES_MAX_GEN = 2e-2      # whose fine angles lie pi/256 apart
SMALL_AGREE = 0.999      # decided symbols shared with the plain chain on a small capture
SPACER_CYCLES = 200_000_000   # ~0.1 s at the H100's ~1.98 GHz boost clock
# the pilot serving chain (bench.py:425-435, 700): 240 frames per dispatch
PILOT_TX_FRAMES, PILOT_FRAMES, PILOT_FRAME, PILOT_SEQ, PILOT_RAT = 244, 240, 2 ** 16, 1024, 32
PILOT_CFG = dict(os=2, nmodes=2, sync_Ntaps=17, sync_mu=5e-3, sync_Niter=10, Ntaps=45,
                 cpe_avg=3, block_size=256, eq_trainer="ls")
PHASE_FRAMES = 8         # depth of the return_phase=True chain
# B5 at rows of more pilots than its first design took (4,096): (pilots, rows); 8,160 and
# 32,736 are frames of 2^18 and 2^20 symbols at ratio 32
CPE_LENGTHS = ((4097, 64), (8160, 64), (32736, 16))
# the path "pilot long frames": make_pilot_tx(20, frame_len=2^18), 16 frames a dispatch, the
# bench's other settings. At 2^18-symbol frames (511 sync windows) the frame sync fails on
# half the captures (seeds 2, 3, 5 and 8 of 1-8 on the card's generator: sync_corr 72-88 <
# 120), in the port's card and CPU chains alike and in the JAX reference wherever it was run
# on such a capture (ROADMAP queue C, C5): the path gates the first seed that syncs and runs
# the capture's default seed 3 beside it, holding the card's chain on it to the plain CPU chain
PILOT_LONG = dict(tx_frames=20, frames=16, frame_len=2 ** 18, seed=1, sync_fails_seed=3)
TOL_SYNC_CORR = 1e-4     # card vs CPU sync_corr, relative (the card test's bound)
LONG_AGREE = 0.999       # card vs CPU decisions on that capture (the card test's bound)
TOL_CPE_A = 1e-5         # B5 a: the same float32 formula; atan2 may differ by an ulp,
TOL_CPE_B = 1e-6         # which moves a (a few rad) by ~1e-6 and the slopes b by ~1e-7
TOL_PAYLOAD = 1e-4       # return_phase on/off, the reference's bound (test_pilot_chain.py:543)
# the pilot chain's other configurations. "pilot lms": the bench's LMS attempt
# (bench.py:428-435, 700-701) on the pilot cell's capture; "pilot foe": a 20 MHz carrier
# offset taken out by foe_comp; "pilot non-blocked": every other CPE pilot (cpe_pilot_rat=2),
# which the general frame body demodulates; "pilot granular": ops/pilots.py step by step
PILOT_LMS_CFG = dict(PILOT_CFG, eq_trainer="lms", mu=(1e-3, 1e-3), Niter=30)
PILOT_FOE = dict(tx_frames=20, frames=16, freq_off=20e6, seeds=(3, 1, 2, 4))
PILOT_NB = dict(frames=16, cpe_pilot_rat=2)
PILOT_GRAN = dict(tx_frames=6, frames=3, frame_len=2 ** 14, seq_len=512, Ntaps=45)
TOL_FOE = 1e-6           # card vs CPU pilot FOE, cycles per symbol (the CPU tests' bound)
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
# K5: the pilot capture's planes (244 frames of 2 x 65,536 symbols at os 2), the frame
# entry's grids before this design (480 rows x 256 tiles) and with it (240 frames x 52
# tiles), and probe_pallas_overhead.build_expand's argmin (A = 64, 2 x 2^21 samples)
K5_PLANES = (4, 31_981_568)
K5_COPY_CTAS = (122_880, 12_480)
K5_ARGMIN = (64, 2 * 2 ** 21)
OPS_BPS_SEARCH = 9       # per sample and angle: rotate 6, running window 2, compare 1
OPS_FINE_ANGLE = 6       # B8 per sample and offset: ph1 + delta by angle addition
# the distance per sample and angle: per axis decide 6 and offset 1, then squares and sum 3
# (square and rectangular: 17). Cross, as grid_dist<kCross> computes it: the offset's
# subtraction and floor(u + 0.5) once per axis (the rectangle's decide less its clamp of 2:
# 4 per axis), then 4 clamps of 2, 4 offsets, 6 for the two squared distances and their
# minimum 1: 8 + 8 + 4 + 6 + 1 = 27 (25 float instructions). A general alphabet 5 per point
# (two products, two sums, the maximum)
OPS_DECIDE = {"sq": 17, "r": 17, "x": 27}
OPS_GEN_POINT = 5
OPS_ROTATE = 8           # sin, cos and the rotation
OPS_INTERP = 2           # a + b j
OPS_UNWRAP = 6           # difference, quarter-turn count, prefix sum
OPS_CPE_PILOT = 20       # conjugate product, atan2, unwrap, average, coefficients
# the paths in the order they run; each is counted on its own (see counted())
# phase 18, BASELINE config 3 at the blind cells' size (examples/phase_recovery.py,
# tests/test_phaserec.py:81-125): (M, SNR dB, linewidth Hz, carrier offset Hz, gate, edges)
PHASE_NSYM, PHASE_FB, PHASE_SEED = 2 ** 20, 40e9, 3
PHASE_SIGS = {"bps": (64, 30, 100e3, None, 1e-4, 20), "vv": (4, 25, 100, 50e6, 1e-3, 20),
              "partition": (16, 30, 50, None, 1e-2, 200), "metrics": (16, 12, None, None, None, 0)}
PHASE_BPS = (64, 14)             # phaserec.bps(sig, 64, 14)
PHASE_TWOSTAGE = (32, 14, 8)     # phaserec.bps_twostage(sig, 32, 14, B=8)
VV_N, VV_FFT, PART_BLOCK = 11, 2 ** 16, 128
METRIC_SER_REL, METRIC_SNR_DB = 0.05, 0.3   # the verify skill's theory anchors
# phase 19, BASELINE configs 1, 4 and 5 on the port's own signals: examples/cma_equaliser.py
# with 2^20 symbols (the example's 2^16 raised to the blind cells' size),
# examples/sim_pilot_txrx.py and the chain of examples/tx_impairment_simulation.py with 16
# frames (the examples' 3 and 2 raised); nothing else changed. The pilot paths gate the first
# seed whose frame sync succeeds (ROADMAP C5), the example's own first
BASE_CMA = dict(N=2 ** 20, fb=40e9, beta=0.1, snr=14, pmd=(np.pi / 5.65, 100e-12), seed=1,
                small_N=2 ** 17)
BASE_CMA_SER = 1e-4              # the equaliser path's gate
BASE_PILOT = dict(frame_len=2 ** 16, seq_len=2 ** 10, ins=32, nframes=16, fb=24e9, beta=0.01,
                  snr=25, dgd=10e-12, freq_off=100e6, lwdth=100e3, modal_delay=(2000, 2000),
                  seeds=(4, 1, 2, 3), nframes_eq=15, small_frames=3)
BASE_TX = dict(frame_len=2 ** 16, seq_len=1024, ins=32, nframes=16, fb=40e9, beta=0.5,
               roll=10000, enob=6, cutoff=16e9, volt=1.0, snr=35, seeds=(2, 1, 3, 4),
               small_frames=3)
# b: the JAX examples' mean BER per mode at these settings over seeds 1-5 on the CPU
# (tools/baseline_reference_ber.py, its output in CHANGES.md); config 5 over two runs, since
# its pilots are drawn unseeded (from_symbol_array, as in the example), so each run is new
# captures. The gate is max(2 b, 1e-5) per mode
BASE_REF_BER = {"baseline pilot": 2.2951e-03, "baseline tx": 1.6355e-02}
# GMI per mode: config 4 the reference's pilot-equaliser tolerance (test/test_equalisation.py:164).
# Config 5's chain stays under it in the JAX package too: its 20 per-mode readings of the same
# runs span 5.4612-5.5089, so its path is held to their least less their spread, a reading
# further below the reference's range than the range is wide
BASE_REF_GMI_TX = (5.461239801479016, 5.508876266482114)
BASE_GMI = {"baseline pilot": 5.5,
            "baseline tx": BASE_REF_GMI_TX[0] - (BASE_REF_GMI_TX[1] - BASE_REF_GMI_TX[0])}
BASE_BLOCK = 128                 # the block size of "auto" on the card, which the CPU run takes
# phase 8b: (path, chain arguments, SER gate, launches): the reference's last selectable modes
MODE_PATHS = (
    ("blind decimated16 bf16", dict(CFG, bps_win="bf16"), SER_LIMIT,
     {"B1": 2, "B2": 1, "B3": 1, "B4": 1}),
    ("blind twostage bf16", dict(SAMPLE_CFG, bps_mode="twostage", bps_win="bf16"), 1e-5,
     {"B1": 2, "B2": 1, "B3": 1, "B8": 1, "B7": 1}),
    ("blind twostage-dec", dict(SAMPLE_CFG, bps_mode="twostage-dec"), 1e-4,
     {"B1": 2, "B2": 1, "B3": 1, "B8": 1, "B7": 1}),
    ("blind fuse_derot off", dict(CFG, fuse_derot=False), SER_LIMIT,
     {"B1": 2, "B2": 1, "B3": 1, "B4": 1}),
    ("blind pallas off", dict(CFG, pallas=False), 1e-4, {"B1": 2, "B2": 1, "B3": 1, "B6": 1}),
)
BF16_WIDEN = 1.5         # per sample and angle: round to bf16 (packed: 0.5), widen to compare (1)
# phase 8b's sweep of B3 and B8 with bf16 windows: every residue-class and ring case of the walk
# (top level 2 to 128, the components of 2N above and below 8), the reference tiles in turn
BF16_SWEEP_N = (1, 3, 4, 7, 8, 12, 14, 32, 60, 63, 64)
BF16_SWEEP_T = (256, 384, 2048, 8192, 16384)
PACK = 2                 # phase 12c: frames a pack
TOL_SPAN = 1e-4          # span against scan, the reference's bound (test_pilot_chain.py:126-129)
PATHS = ("blind", "blind twostage", "blind single") + tuple(p for p, _, _, _ in MODE_PATHS) + (
         "pilot", "pilot return_phase", "pilot span", "pilot frames_pack %d" % PACK,
         "pilot long frames", "pilot lms", "pilot foe", "pilot non-blocked", "pilot granular",
         "equaliser seq", "equaliser block") + tuple(
             p for p, _, _ in GRID_PATHS) + ("phase bps", "phase twostage", "phase vv",
                                             "phase partition", "phase metrics", "baseline cma",
                                             "baseline pilot", "baseline pilot nframes",
                                             "baseline tx", "sharded blind nccl1",
                                             "sharded blind gloo4", "sharded blind gloo4 single",
                                             "sharded pilot gloo4",
                                             "sharded pilot gloo4 shard_prefix") + tuple(
             "profiling " + g for g in ("bps", "apply_filter") + tuple(
                 "train_" + m for m in profiling.GROUP_METHODS)) + ("long blind", "long pilot",
                                                                     "long pilot full")
# phase 20, the multi-device receivers: "sharded blind nccl1" is the blind decimated16 cell's
# chain over one NCCL rank (rounds=1: one round of each training, as the single-card chain);
# the gloo paths run four ranks on the one card, 2^18 symbols a shard, rounds=2, and the
# single mode at bps_N=14 (the bench's attempt 4), under the tighter gate SER <= 1e-4 per mode
# (the reference's own multi-process leg gates at 1e-3); the sweep: the same chain at shorter
# shards, trained over at most the shard; the pilot path: 60 frames a rank of the pilot cell
SHARD_CFG = dict(os=2, mu1=1.9e-3, mu2=1.9e-3, M=64, Ntaps=17, methods=("mcma", "mddma"),
                 TrSyms_loc=2 ** 14, Niter=1, rounds=1, bps_angles=64, bps_N=12, block_size=256,
                 bps_mode="decimated16")
SHARD_GLOO = dict(SHARD_CFG, rounds=2)
SHARD_SINGLE = dict(SHARD_GLOO, bps_mode="single", bps_N=14)
SHARD_RANKS, SHARD_SER_GLOO, SHARD_PILOT_K = 4, 1e-4, 60
# the reference's multi-process leg's gate (__graft_entry__.py:199). Both gates are printed for
# the data-parallel chains as they hold or fail, their SER recorded: on make_tx(2^20) the
# reference's own sharded chain reads SER 0.90 on mode 1 at these settings (the mddma stage
# of ranks 1 and 3 locks onto a lattice of gain ~0.8, and the average inherits it), as the
# port does on the CPU and the card. The tracking entries, with the single-card chain's taps,
# are held to 1e-4: they run every exchange of the shards
SHARD_SER_REF = 1e-3
SHARD_SWEEP = (2 ** 11, 2 ** 13, 2 ** 15)     # symbols a rank, beside the gloo path's 2^18
SHARD_EDGE = 512         # symbols off each shard boundary that the sweep's interior SER leaves
SHARD_CALLS = 5          # calls timed by the host clock, between two barriers
SHARD_TIMEOUT = 900      # seconds the four ranks may take in all
NCCL1_AGREE = 0.9999     # decisions shared with RxChain off the edges (near-ties of B3 only)
TOL_NCCL1_TAPS = 1e-6    # taps against RxChain's where its CMA guard does not fire
PILOT_TAPS_REL = 1e-3    # the sharded prefix's LS taps against the replicated prefix's, relative
                         # to the largest tap: one system a rank against a batch of two
REPO = os.path.dirname(os.path.abspath(__file__))
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


CARD = []                        # nvidia-smi's name and power limit, read once in main()


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


def trainer_bound(nmodes, nout, ntaps, os_, nsyms, niter, decide_ops=0):
    """Roofline bound of a trainer (B1, B9): the capture prefix in, taps in and out, the error out.

    The trainers are chains of dependent steps, one SM per output mode, so
    their time is set by latency and lies far above this bound; the bound
    to hold them against is the chain bound (:func:`seq_chain_cycles`,
    :func:`block_chain_cycles`), printed beside their times. ``decide_ops``:
    the operations of a decision method's decision, per sample.
    """
    K = nmodes * ntaps
    moved = 4 * (2 * nmodes * (nsyms * os_ + ntaps - 1) + 2 * nout * nsyms * niter + 4 * nout * K)
    return bound(moved, niter * nsyms * nout * (OPS_TRAIN_TAP * K + OPS_TRAIN_ERR + decide_ops))


def trainer_build_report():
    """What ptxas said of the trainers', B2's, B3's, B5's, B7's and B8's instances, from the
    build's log: registers and spills (B3 and B8 keep their run's best sums and indices in
    registers, B2 its run's sums and window; B5's registers set how many CTAs share an SM)."""
    log = (_build.build_dir() / "build.log").read_text()
    entries = re.findall(r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, (\d+) bytes "
                         r"spill stores, (\d+) bytes spill loads.*?Used (\d+) registers", log, re.S)
    for kernel, name in (("train_seq_kernel", "B9"), ("train_block_kernel", "B1"),
                         ("bps_kernel", "B3"), ("bps_fine_kernel", "B8"), ("unwrap_kernel", "B7"),
                         ("cpe_coeffs_kernel", "B5"),
                         ("apply_filter_kernel", "B2"),
                         ("apply_filter_frames_kernel", "B2 frames")):
        mine = [(int(st), int(ss), int(sl), int(r)) for fn, st, ss, sl, r in entries
                if kernel in fn]
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
    k5_probes(dev, card)
    return lat


def k5_probes(dev, card):
    """Phase 2: the JAX package's cost probes asked again of the H100 (K5), beside byte bounds.

    ``tools/probe_pallas_overhead.py``'s questions: the launch latency of an
    empty kernel; a copy over the pilot capture's planes at 256 and 1,024
    threads per CTA and at the frame entry's old and new CTA counts (the cost
    of a CTA); an argmin over A candidates per sample (its reduce and
    write). ``tools/probe_interleave.py``'s: complex64 samples written as
    float32 planes in a kernel, against the port's ``planes`` (real, imag,
    cat). ``csrc/probe.cu``; nothing on a path runs these.
    """
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = 1000
    t_dev = device_ms(lambda: _build.check(lib.qtt_probe_empty(n, stream), "probe_empty"), 3) / n
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    _build.check(lib.qtt_probe_empty(n, stream), "probe_empty")
    t_host = (time.perf_counter() - h0) / n * 1e3
    torch.cuda.synchronize()
    print("K5 empty kernel: %.2f us per launch on the card back to back, %.2f us to enqueue one "
          "from C [%s]" % (t_dev * 1e3, t_host * 1e3, card))
    numel = K5_PLANES[0] * K5_PLANES[1]
    src = torch.randn(numel, device=dev)
    dst = torch.empty_like(src)
    t_b = bound(2 * nbytes(src), 0)["bound_ms"]
    for threads in (256, 1024):
        for ctas in K5_COPY_CTAS:
            def copy(threads=threads, ctas=ctas):
                _build.check(lib.qtt_probe_copy(src.data_ptr(), dst.data_ptr(), numel, threads,
                                                ctas, stream), "probe_copy")
            copy()
            require(torch.equal(dst, src), "the copy probe did not copy")
            ms = device_ms(copy, 5)
            print("K5 copy of the pilot capture's planes %s (%d MB each way), %d threads x %d "
                  "CTAs: %.4f ms, bound %.4f ms by bytes (%.1f%%), %.1f ns per CTA [%s]"
                  % (K5_PLANES, nbytes(src) >> 20, threads, ctas, ms, t_b, 100 * t_b / ms,
                     ms * 1e6 / ctas, card))
    del src, dst
    A, ns = K5_ARGMIN
    x = torch.randn(ns, device=dev)
    idx = torch.empty(ns, dtype=torch.int32, device=dev)

    def argmin():
        _build.check(lib.qtt_probe_argmin(x.data_ptr(), idx.data_ptr(), ns, A, stream),
                     "probe_argmin")
    argmin()
    require(torch.equal(idx, torch.where(x < 0, A - 1, 0).to(torch.int32)),
            "the argmin probe is wrong")
    b = bound(nbytes(x, idx), 2 * A * ns)
    ms = device_ms(argmin, 20)
    print("K5 argmin over A = %d candidates of %d samples: %.4f ms, bound %.4f ms by %s [%s]"
          % (A, ns, ms, b["bound_ms"], b["bound_by"], card))
    z = torch.complex(x[:ns // 2], x[ns // 2:]).reshape(2, -1)
    out = torch.empty((4, z.shape[1]), device=dev)

    def deint():
        _build.check(lib.qtt_probe_deinterleave(torch.view_as_real(z).data_ptr(), out.data_ptr(),
                                                2, z.shape[1], stream), "probe_deinterleave")
    deint()
    require(torch.equal(out, eqops.planes(z)), "the deinterleave probe is wrong")
    b = bound(2 * nbytes(out), 0)["bound_ms"]
    print("K5 complex64 (2, %d) to float32 planes: kernel %.4f ms, the port's planes() %.4f ms, "
          "bound %.4f ms by bytes [%s]" % (z.shape[1], device_ms(deint, 20),
                                           device_ms(lambda: eqops.planes(z), 20), b, card))


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

    # B2 with the trained taps and its stride-16 side output, B3 on that side
    # output, B4 with the coefficients the chain builds from B3's indices
    rec["B2"], (out_k, dec_k) = b2_record(P, os_, w2_k, chain.dec, "stride-16 side output",
                                          "blind path")
    no = dec_k.shape[0] // 2
    rec["B3"], idx_k = b3_record(dec_k[:no].contiguous(), dec_k[no:].contiguous(), chain.bps_cos,
                                 chain.bps_sin, chain.grid, chain.bps_N, None, "blind", (50, 10))
    rec["B4"] = b4_record(out_k, idx_k, chain, "blind")
    print_times({(k, "blind"): dict(v, shape="blind path") for k, v in rec.items()}, card)
    return rec


def print_times(rec, card):
    """One line per record: the kernel's time beside its bound, plain version and library call."""
    for (k, path), v in rec.items():
        lib = "none" if v["library_ms"] is None else "%.4f ms" % v["library_ms"]
        f32 = ", float32 windows %.4f ms" % v["f32_ms"] if "f32_ms" in v else ""
        print("time %s (%s path, device, %s): kernel %.4f ms%s, bound %.5f ms by %s, plain "
              "%.4f ms, library call %s [%s]" % (k, path, v["shape"], v["ms"], f32, v["bound_ms"],
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


def bps_ops(grid, A, samples, fine=False):
    """Float operations of a phase search over ``A`` angles on ``grid``: B3, or B8 (``fine``,
    A = B) with each offset's angle formed per sample."""
    kind, p = phops.grid_decision_info(grid)
    per_angle = OPS_BPS_SEARCH + (OPS_GEN_POINT * len(p[0]) if kind == "gen"
                                  else OPS_DECIDE[kind]) + (OPS_FINE_ANGLE if fine else 0)
    return per_angle * A * samples


def tie_rule(grid):
    """(relative band of a near-tie, allowed share of near-tied positions) on ``grid``.

    A general alphabet's distance is a score that carries each sample's
    -|z|^2: the windows' magnitudes, to which a float32 sum's rounding is
    relative, are ~100 times the gap of two angles, so its band is a
    float32 sum's own rounding and more positions fall into it.
    """
    gen = phops.grid_decision_info(grid)[0] == "gen"
    return (TIE_REL_GEN, TIES_MAX_GEN) if gen else (TIE_REL, TIES_MAX)


def plan_text(plan):
    """A B2 launch plan as printed beside its times."""
    return ("plan run %d, tile %d, chunk %d, %d threads, segment %d, %d B shared, %d CTAs"
            % tuple(plan))


def b2_record(P, os_, w, dec, what, shape):
    """B2 against its plain version, with or without the stride-``dec`` side output; two
    launches bit-equal; the launch plan beside its time."""
    plain = apply_filter_plain(P, os_, w, dec)
    kern = apply_filter_cuda(P, os_, w, dec)
    outs_p, outs_k = (plain, kern) if dec else ((plain,), (kern,))
    again = apply_filter_cuda(P, os_, w, dec)
    same = all(torch.equal(a, b) for a, b in zip(outs_k, again if dec else (again,)))
    rms = float(outs_p[0].pow(2).mean().sqrt())
    d = max(float((k - q).abs().max()) for k, q in zip(outs_k, outs_p))
    plan = filter_plan(w.shape[1], w.shape[0], w.shape[2], os_, outs_k[0].shape[-1])
    print("B2 apply_filter (%s): out %s%s max|d| %.3e (tol %.0e x rms %.3f), two launches "
          "bit-equal: %s; %s" % (what, tuple(outs_k[0].shape),
                                 ", dec %s" % (tuple(outs_k[1].shape),) if dec else "", d,
                                 TOL_FILTER_REL, rms, same, plan_text(plan)))
    require(all(k.shape == q.shape for k, q in zip(outs_k, outs_p)), "B2 output shapes differ")
    require(d <= TOL_FILTER_REL * rms, "B2 disagrees with its plain version (%s)" % what)
    require(same, "two B2 launches differ (%s)" % what)
    rec = dict(**filter_bound(P, w, *outs_k), err=d,
               ms=device_ms(lambda: apply_filter_cuda(P, os_, w, dec), 50),
               plain_ms=device_ms(lambda: apply_filter_plain(P, os_, w, dec), 10),
               shape="%s; %s" % (shape, plan_text(plan)))
    rec["library_ms"] = filter_library(P, os_, w, outs_k[0])
    return rec, outs_k


def b3_record(er, ei, cos_t, sin_t, grid, N, points, what, reps=(20, 5), share_max=None):
    """B3 against its plain version off near-ties; returns (record, the kernel's indices).

    ``share_max``: the share of near-tied positions allowed, if not the grid's (:func:`tie_rule`).
    """
    A, L = cos_t.shape[0], er.shape[-1]
    rel, share_grid = tie_rule(grid)
    share_max = share_grid if share_max is None else share_max
    idx_p = bps_search_plain(er, ei, cos_t, sin_t, grid, N)
    idx_k = bps_search_cuda(er, ei, cos_t, sin_t, grid, N, points)
    ties = phops.bps_near_ties(er, ei, cos_t, sin_t, grid, N, rel)
    differ = idx_k != idx_p
    tie_share = float(ties.double().mean())
    off_tie = bool((differ & ~ties).any())
    kind = phops.grid_decision_info(grid)[0]
    npts = len(grid[1]) if kind == "gen" else 0
    print("B3 bps_search (%s: grid %s, A=%d, N=%d): %s, %d positions differ, %s off near-ties; "
          "near-tie share %.2e (max %.0e)" % (what, kind, A, N, tuple(idx_k.shape),
                                              int(differ.sum()), "some" if off_tie else "none",
                                              tie_share, share_max))
    require(not off_tie and tie_share <= share_max,
            "B3 disagrees with its plain version off near-ties (%s, A=%d, N=%d)" % (what, A, N))
    rec = dict(**bound(nbytes(er, ei, idx_k), bps_ops(grid, A, er.numel())),
               err=float((idx_k - idx_p).abs()[~ties].max()),
               ms=device_ms(lambda: bps_search_cuda(er, ei, cos_t, sin_t, grid, N, points),
                            reps[0]),
               plain_ms=device_ms(lambda: bps_search_plain(er, ei, cos_t, sin_t, grid, N), reps[1]),
               shape="grid %s, A=%d N=%d, 2 x %d samples, tiles of %d" % (
                   kind, A, N, L, bps_plan(er.shape[0], L, N, npts).tile), grid=kind)
    return rec, idx_k


def b8_record(er, ei, ph1, cd, sd, grid, N, d0f, ddf, points, what, reps=(20, 5)):
    """B8 against its plain version off near-ties; returns (record, the kernel's phases)."""
    B, L = cd.shape[0], er.shape[-1]
    rel, share_max = tie_rule(grid)
    fargs = (er, ei, ph1, cd, sd, grid, N, d0f, ddf)
    f_p = bps_fine_plain(*fargs)
    f_k = bps_fine_cuda(*fargs, points)
    ties = phops.bps_fine_near_ties(*fargs[:7], rel)
    differ = f_k != f_p
    tie_share = float(ties.double().mean())
    off_tie = bool((differ & ~ties).any())
    kind = phops.grid_decision_info(grid)[0]
    print("B8 bps_fine (%s: grid %s, B=%d, N=%d): %s, %d phases differ, %s off near-ties; "
          "near-tie share %.2e (max %.0e); max|d| %.3e"
          % (what, kind, B, N, tuple(f_k.shape), int(differ.sum()), "some" if off_tie else "none",
             tie_share, share_max, float((f_k - f_p).abs().max())))
    require(not off_tie and tie_share <= share_max,
            "B8 disagrees with its plain version off near-ties (%s)" % what)
    plan = fine_plan(er.shape[0], L, N, len(grid[1]) if kind == "gen" else 0)
    print("B8 bps_fine (%s): plan run %d, tile %d, %d offsets per slot, %d B shared, %d CTAs"
          % (what, *plan))
    rec = dict(**bound(nbytes(er, ei, ph1, f_k), bps_ops(grid, B, er.numel(), fine=True)
                       + OPS_ROTATE * er.numel()),
               err=float((f_k - f_p).abs()[~ties].max()),
               ms=device_ms(lambda: bps_fine_cuda(*fargs, points), reps[0]),
               plain_ms=device_ms(lambda: bps_fine_plain(*fargs), reps[1]),
               shape="grid %s, B=%d N=%d, 2 x %d samples, plan run %d, tile %d, chunk %d, "
                     "%d CTAs" % (kind, B, N, L, plan.run, plan.tile, plan.chunk, plan.ctas),
               grid=kind)
    return rec, f_k


def b7_record(er, ei, ph, what):
    """B7 against its plain version within the bound of two float32 rotations."""
    r_p, i_p = unwrap_derotate_plain(er, ei, ph)
    r_k, i_k = unwrap_derotate_cuda(er, ei, ph)
    r_6, i_6 = rotate_cuda(er, ei, quarter_unwrap(ph), 1)
    same6 = bool(torch.equal(r_k, r_6) and torch.equal(i_k, i_6))
    plan = unwrap_plan(*er.shape)
    print("B7 unwrap_derotate (%s): plan tile %d, %d tiles per row, %d CTAs, %d scratch words; "
          "equal to B6 rotating by the plain unwrap: %s" % (what, *plan, same6))
    require(same6, "B7 differs from B6 rotating by the plain unwrap (%s)" % what)
    dist = torch.sqrt((r_k - r_p) ** 2 + (i_k - i_p) ** 2)
    rot_bound = rotation_bound(er, ei, quarter_unwrap(ph))
    d_rot = max(float((r_k - r_p).abs().max()), float((i_k - i_p).abs().max()))
    print("B7 unwrap_derotate (%s): %s max|d| %.3e, worst share of the bound "
          "2|z|(ulp32(|u|) + 2^-23) %.3f, |u| up to %.2f rad"
          % (what, tuple(r_k.shape), d_rot, float((dist / rot_bound).max()),
             float(quarter_unwrap(ph).abs().max())))
    require(bool((dist <= rot_bound).all()), "B7 disagrees with its plain version (%s)" % what)
    return dict(**bound(nbytes(er, ei, ph, r_k, i_k), (OPS_UNWRAP + OPS_ROTATE) * er.numel()),
                err=d_rot, ms=device_ms(lambda: unwrap_derotate_cuda(er, ei, ph), 50),
                plain_ms=device_ms(lambda: unwrap_derotate_plain(er, ei, ph), 10),
                shape="2 x %d samples, plan tile %d, %d CTAs" % (er.shape[-1], plan.tile,
                                                                 plan.ctas))


def b4_record(eqp, idxd, chain, what):
    """B4 against its plain version, with the coefficients the chain builds from B3's indices."""
    no = eqp.shape[0] // 2
    er_p, ei_p, a, b = decimated_derotation_inputs(eqp[:no], eqp[no:], idxd, chain.lo_a,
                                                   chain.step_a, chain.dec)
    return args_b4_record((er_p, ei_p, a, b, chain.dec, 1), what)


def check_sample_kernels(P, w, card):
    """Phase 7: B2 (no side output), B3, B8 and B7 at the per-sample paths' shapes.

    P: the blind capture; w: taps trained on it. Returns records keyed by
    (kernel, path) for "blind twostage" and "blind single".
    """
    rec = {}
    b2, (out_k,) = b2_record(P, CFG["os"], w, None, "no side output",
                             "2 x 2^21 samples in, no side output")
    no = out_k.shape[0] // 2
    er, ei = out_k[:no], out_k[no:]
    for mode in ("twostage", "single"):
        path = "blind " + mode
        chain = make_rx_chain(**dict(SAMPLE_CFG, bps_mode=mode), device=P.device)
        rec["B2", path] = b2
        rec["B3", path], idx_k = b3_record(er, ei, chain.bps_cos, chain.bps_sin, chain.grid,
                                           chain.search_N, None, path)
        ph = chain.lo_a + chain.step_a * idx_k.to(torch.float32)
        if mode == "twostage":
            rec["B8", path], ph = b8_record(er, ei, ph, chain.fine_cos, chain.fine_sin,
                                            chain.grid, chain.bps_N, chain.fine_d0,
                                            chain.fine_step, None, path)
        rec["B7", path] = b7_record(er, ei, ph, mode + " phase")
    print_times(rec, card)
    return rec


def quiet_chain(cfg, device):
    """``make_rx_chain(**cfg)`` on ``device`` and the fallback warning it gave, if any."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        chain = make_rx_chain(**cfg, device=device)
    fell = [str(c.message) for c in caught if "falling back" in str(c.message)]
    return chain, fell[0] if fell else None


def chain_path(path, cfg, gate, P, ref, const, small_tx, card, want=None):
    """One blind chain counted, gated, compared and timed: phases 8 and 8b, and 17 per path.

    ``cfg``: the arguments of ``make_rx_chain``; ``small_tx``: the arguments
    (alphabet and seed) of the 2^15-symbol capture on which the card's
    chain is held against the plain chain on the CPU; ``want``: the
    launches, if not the mode's own. Returns (launch counts, the chain, its
    taps, its output planes).
    """
    dev = P.device
    chain, fell = quiet_chain(cfg, dev)
    mode = chain.mode
    print("%s: %s%s" % (path, chain.backend_info, "; warned: " + fell if fell else ""))
    (outr, outi), launches = counted(lambda: chain.planes(P))
    print("%s launches: %s" % (path, launches))
    if want is None:
        want = {"B1": 2, "B2": 1, "B3": 1, "B4" if mode == "decimated" else "B7": 1}
        if mode in ("twostage", "twostage-dec"):
            want["B8"] = 1
    require(launches == expected(want), "the %s path did not launch each kernel as expected"
            % path)
    Lout = (P.shape[-1] - cfg["Ntaps"]) // cfg["os"] + 1
    require(tuple(outr.shape) == (2, Lout) and outr.shape == outi.shape,
            "%s output shape %s" % (path, tuple(outr.shape)))
    require(bool(torch.isfinite(outr).all() and torch.isfinite(outi).all()),
            "non-finite %s output" % path)
    ser = ser_gate(torch.complex(outr, outi), ref, const)
    print("%s SER %.3e (gate %.0e; against 1e-5: %s) on %d x 2 symbols"
          % (path, ser, gate, "pass" if ser <= 1e-5 else "fail", NSYM))
    require(ser <= gate, "%s SER gate failed" % path)

    (fr, fi), w = chain.planes_with_taps(P)
    tr, ti = chain.tracking_planes(P, w)
    exact = bool(torch.equal(tr, fr) and torch.equal(ti, fi))
    print("%s tracking_planes == planes_with_taps output: %s" % (path, exact))
    require(exact, "%s tracking output differs from the full chain" % path)

    Es, syms_s, _ = make_tx(2 ** 15, **small_tx)
    o_cpu = quiet_chain(cfg, "cpu")[0].forward(torch.as_tensor(Es))
    o_gpu = chain.forward(torch.as_tensor(Es, device=dev)).cpu()
    trim = slice(GATE_TRIM, -GATE_TRIM)
    agree = shared_decisions(o_cpu[:, trim], o_gpu[:, trim], const)
    ser_s = [ser_gate(o, torch.as_tensor(syms_s), const) for o in (o_cpu, o_gpu)]
    print("%s small capture (2^15 x 2 symbols): card vs plain CPU chain share %.6f of "
          "decisions, each mode at its best quarter turn (min %.3f); SER cpu %.2e, card %.2e"
          % (path, agree, SMALL_AGREE, ser_s[0], ser_s[1]))
    require(agree >= SMALL_AGREE and max(ser_s) <= gate,
            "the card's %s chain disagrees with the plain chain" % path)

    nsym_tot = NSYM * 2
    t_full = cuda_ms(lambda: chain.planes(P), 10)
    t_trk = cuda_ms(lambda: chain.tracking_planes(P, w), 20)
    print("time %s chain.planes: %.4f ms, %.1f Msym/s [%s]"
          % (path, t_full, nsym_tot / t_full / 1e3, card))
    print("time %s chain.tracking_planes: %.4f ms, %.1f Msym/s [%s]"
          % (path, t_trk, nsym_tot / t_trk / 1e3, card))
    eqp, decp = chain.equalise(P, w)
    no = eqp.shape[0] // 2
    searched = eqp if decp is None else decp
    idx = chain.phase_search(searched)
    bf16 = chain.bps_win == "bf16"
    stages = {
        "train (2x B1 + guard)": device_ms(lambda: chain.train_taps(P), 10),
        "filter (B2)": device_ms(lambda: chain.equalise(P, w), 20),
        "bps (B3, grid %s, A=%d, N=%d%s)" % (phops.grid_decision_info(chain.search_grid)[0],
                                             chain.bps_cos.shape[0], chain.search_N,
                                             ", bf16 windows" if bf16 else ""):
            device_ms(lambda: chain.phase_search(searched), 20),
    }
    if mode == "decimated":
        er_p, ei_p, a, b = decimated_derotation_inputs(eqp[:no], eqp[no:], idx, chain.lo_a,
                                                       chain.step_a, chain.dec)
        stages["glue (unwrap, coeffs, pad)"] = device_ms(lambda: decimated_derotation_inputs(
            eqp[:no], eqp[no:], idx, chain.lo_a, chain.step_a, chain.dec), 20)
        stages["interp-rotate (B4)"] = device_ms(
            lambda: interp_rotate(er_p, ei_p, a, b, chain.dec, 1), 20)
    else:
        ph1 = coarse_phase(chain, idx, eqp)
        ph = chain.carrier_phase(eqp, decp)
        stages["index to phase (plain)"] = device_ms(lambda: coarse_phase(chain, idx, eqp), 20)
        if mode in ("twostage", "twostage-dec"):
            stages["fine bps (B8, grid %s%s)" % (phops.grid_decision_info(chain.fine_grid)[0],
                                                 ", bf16 windows" if bf16 else "")] = \
                device_ms(lambda: bps_fine(eqp[:no], eqp[no:], ph1, chain.fine_cos,
                                           chain.fine_sin, chain.fine_grid, chain.bps_N,
                                           chain.fine_d0, chain.fine_step, chain.gen_points,
                                           chain._bf16(chain.bps_tile)), 20)
        fused = chain.pallas and chain.fuse_derot
        stages["unwrap-derotate (B7)" if fused else "unwrap (plain) and rotation (B6)"] = \
            device_ms(lambda: chain.unwrap_derotate(eqp, ph), 20)
    for k, v in stages.items():
        print("time %s stage %s: %.4f ms device (%.1f%% of the chain's stream time) [%s]"
              % (path, k, v, 100 * v / t_full, card))
    print("time %s stages' device sum: %.4f ms vs chain stream time %.4f ms [%s]"
          % (path, sum(stages.values()), t_full, card))
    return launches, chain, w, (outr, outi)


def coarse_phase(chain, idx, eqp):
    """The phase around which B8 searches, from B3's indices: lo + step idx, held over the side
    output's stride in twostage-dec (reference chain.py:377-383)."""
    ph = chain.lo_a + chain.step_a * idx.to(torch.float32)
    if chain.mode != "twostage-dec":
        return ph
    no = ph.shape[0]
    return ph[:, :, None].expand(-1, -1, chain.dec).reshape(no, -1)[:, :eqp.shape[-1]].contiguous()


def bps_ops_bf16(grid, A, samples, N, fine=False):
    """:func:`bps_ops` with bf16 windows: the rotation, distance and compare in float32, the
    bf16 rounding and widening, and the window's adds (the doubling levels to the largest
    power of two in 2N, then one per further component) at two per float32 operation, the
    packed-bf16 rate."""
    kind, p = phops.grid_decision_info(grid)
    N2 = 2 * N
    adds = N2.bit_length() - 1 + bin(N2).count("1") - 1
    per_angle = (OPS_BPS_SEARCH - 2 + BF16_WIDEN + adds / 2
                 + (OPS_GEN_POINT * len(p[0]) if kind == "gen" else OPS_DECIDE[kind])
                 + (OPS_FINE_ANGLE if fine else 0))
    return per_angle * A * samples


def b3_bf16_record(er, ei, cos_t, sin_t, grid, N, T, points, what, reps=(20, 5)):
    """B3 with bf16 windows at tile T against its bf16 twin, bit for bit; beside it the float32
    kernel's time and the share of positions where the two window types choose apart."""
    A, (nmodes, L) = cos_t.shape[0], er.shape
    idx_p = bps_search_plain(er, ei, cos_t, sin_t, grid, N, T)
    idx_k = bps_search_cuda(er, ei, cos_t, sin_t, grid, N, points, T)
    same = bool(torch.equal(idx_k, idx_p))
    f32 = bps_search_cuda(er, ei, cos_t, sin_t, grid, N, points)
    kind = phops.grid_decision_info(grid)[0]
    plan = phcuda.bf16_plan(nmodes, L, N, T, len(grid[1]) if kind == "gen" else 0)
    print("B3 bps_search bf16 (%s: grid %s, A=%d, N=%d, T=%d): %s bit-equal to its bf16 twin: "
          "%s; %.2e of the positions choose apart from the float32 windows; plan run %d, tile "
          "%d, %d B shared, %d CTAs" % (what, kind, A, N, T, tuple(idx_k.shape), same,
                                        float((idx_k != f32).double().mean()), plan.run,
                                        plan.tile, plan.smem, plan.ctas))
    require(same, "B3 with bf16 windows differs from its twin (%s)" % what)
    rec = dict(**bound(nbytes(er, ei, idx_k), bps_ops_bf16(grid, A, er.numel(), N)), err=0.0,
               ms=device_ms(lambda: bps_search_cuda(er, ei, cos_t, sin_t, grid, N, points, T),
                            reps[0]),
               f32_ms=device_ms(lambda: bps_search_cuda(er, ei, cos_t, sin_t, grid, N, points),
                                reps[0]),
               plain_ms=device_ms(lambda: bps_search_plain(er, ei, cos_t, sin_t, grid, N, T),
                                  reps[1]),
               shape="grid %s, A=%d N=%d, bf16 windows at T=%d, 2 x %d samples, tiles of %d"
                     % (kind, A, N, T, L, plan.tile), grid=kind)
    return rec, idx_k


def b8_bf16_record(er, ei, ph1, cd, sd, grid, N, d0f, ddf, T, points, what, reps=(20, 5)):
    """B8 with bf16 windows at tile T against its bf16 twin, bit for bit, as B3's."""
    B, (nmodes, L) = cd.shape[0], er.shape
    fargs = (er, ei, ph1, cd, sd, grid, N, d0f, ddf)
    f_p = bps_fine_plain(*fargs, T)
    f_k = bps_fine_cuda(*fargs, points, T)
    same = bool(torch.equal(f_k, f_p))
    f32 = bps_fine_cuda(*fargs, points)
    kind = phops.grid_decision_info(grid)[0]
    plan = phcuda.bf16_plan(nmodes, L, N, T, len(grid[1]) if kind == "gen" else 0, fine=True)
    print("B8 bps_fine bf16 (%s: grid %s, B=%d, N=%d, T=%d): %s bit-equal to its bf16 twin: "
          "%s; %.2e of the phases apart from the float32 windows'; plan run %d, tile %d, %d B "
          "shared, %d CTAs" % (what, kind, B, N, T, tuple(f_k.shape), same,
                               float((f_k != f32).double().mean()), plan.run, plan.tile,
                               plan.smem, plan.ctas))
    require(same, "B8 with bf16 windows differs from its twin (%s)" % what)
    rec = dict(**bound(nbytes(er, ei, ph1, f_k), bps_ops_bf16(grid, B, er.numel(), N, fine=True)
                       + OPS_ROTATE * er.numel()), err=0.0,
               ms=device_ms(lambda: bps_fine_cuda(*fargs, points, T), reps[0]),
               f32_ms=device_ms(lambda: bps_fine_cuda(*fargs, points), reps[0]),
               plain_ms=device_ms(lambda: bps_fine_plain(*fargs, T), reps[1]),
               shape="grid %s, B=%d N=%d, bf16 windows at T=%d, 2 x %d samples, tiles of %d"
                     % (kind, B, N, T, L, plan.tile), grid=kind)
    return rec, f_k


def mode_paths(P, ref, const, card, rec, blind_out):
    """Phase 8b: the reference's last selectable modes (``MODE_PATHS``) on the blind capture.

    Each path through :func:`chain_path`; then its kernels against their plain versions at
    its own inputs (B3 and B8 with bf16 windows bit-equal to their twins), or the record of
    an earlier path where the inputs have its shapes. Returns (records, launches per path).
    """
    recs, launches_all = {}, {}
    for path, cfg, gate, want in MODE_PATHS:
        launches_all[path], chain, w, out = chain_path(path, cfg, gate, P, ref, const,
                                                       dict(seed=2), card, want)
        if path == "blind fuse_derot off":
            same = bool(torch.equal(out[0], blind_out[0]) and torch.equal(out[1], blind_out[1]))
            print("%s: output bit-equal to the blind path's (decimated16 derotates by B4 "
                  "either way): %s" % (path, same))
            require(same, "fuse_derot=False changed the decimated16 chain")
        eqp, decp = chain.equalise(P, w)
        no = eqp.shape[0] // 2
        er, ei = eqp[:no], eqp[no:]
        recs["B1", path] = rec["B1", "blind"]
        if chain.dec == 8:
            recs["B2", path], _ = b2_record(P, CFG["os"], w, 8, path,
                                            "2 x 2^21 samples in, side output stride 8")
        else:
            recs["B2", path] = rec["B2", "blind" if chain.dec else "blind single"]
        x = eqp if decp is None else decp
        xr, xi = x[:no], x[no:]
        if chain.bps_win == "bf16":
            recs["B3", path], idx = b3_bf16_record(xr, xi, chain.bps_cos, chain.bps_sin,
                                                   chain.search_grid, chain.search_N,
                                                   chain.search_tile, None, path)
        else:
            recs["B3", path], idx = b3_record(xr, xi, chain.bps_cos, chain.bps_sin,
                                              chain.search_grid, chain.search_N, None, path)
        if chain.mode == "decimated":
            recs["B4", path] = b4_record(eqp, idx, chain, path)
            continue
        ph = coarse_phase(chain, idx, eqp)
        if chain.mode in ("twostage", "twostage-dec"):
            fargs = (er, ei, ph, chain.fine_cos, chain.fine_sin, chain.fine_grid, chain.bps_N,
                     chain.fine_d0, chain.fine_step)
            if chain.bps_win == "bf16":
                recs["B8", path], ph = b8_bf16_record(*fargs, chain.bps_tile, None, path)
            else:
                recs["B8", path], ph = b8_record(*fargs, None, path)
            if chain.mode == "twostage-dec":
                # its shapes with bf16 windows (no path launches them): bit-equal, timed
                what = path + " shapes, bf16 windows"
                r3, i3 = b3_bf16_record(xr, xi, chain.bps_cos, chain.bps_sin, chain.search_grid,
                                        chain.search_N, chain.search_tile, None, what)
                r8, _ = b8_bf16_record(er, ei, coarse_phase(chain, i3, eqp), *fargs[3:],
                                       chain.bps_tile, None, what)
                for k, r in (("B3", r3), ("B8", r8)):
                    print("time %s (%s, device, %s): kernel %.4f ms, float32 %.4f ms, bound "
                          "%.5f ms by %s, plain %.4f ms [%s]" % (k, what, r["shape"], r["ms"],
                                                                r["f32_ms"], r["bound_ms"],
                                                                r["bound_by"], r["plain_ms"],
                                                                card))
        if chain.pallas and chain.fuse_derot:
            recs["B7", path] = rec["B7", "blind twostage"]
        else:
            recs["B6", path] = b6_record(er, ei, chain.unwrap_unfused(ph), path)
    print_times(recs, card)
    bf16_sweep(const, card)
    return recs, launches_all


def bf16_sweep(const, card):
    """Phase 8b's sweep: B3 (13 angles) and B8 (8 offsets around B3's bf16 coarse phase of 16
    angles, N=60) with bf16 windows at every half-window of ``BF16_SWEEP_N`` (each residue-class
    and ring case of the walk), the reference tiles in turn, on 2 x (2^17 + 77) samples of
    ``const``: bit for bit their twins, or the run fails."""
    dev = torch.device("cuda", 0)
    grid = phops.detect_grid(const)
    er, ei = synth_planes(const, 2 ** 17 + 77, dev, 11)
    cos1, sin1 = (torch.as_tensor(t, device=dev) for t in phops.bps_tables(
        np.linspace(-np.pi / 4, np.pi / 4, 16, endpoint=False, dtype=np.float32), grid))
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in phops.bps_tables(
        np.linspace(-np.pi / 4, np.pi / 4, 13, endpoint=False, dtype=np.float32), grid))
    cd, sd, d0f, ddf = phops.fine_tables(16, 8, grid)
    cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
    for i, N in enumerate(BF16_SWEEP_N):
        T = BF16_SWEEP_T[i % len(BF16_SWEEP_T)]
        same3 = bool(torch.equal(bps_search_cuda(er, ei, cos_t, sin_t, grid, N, None, T),
                                 bps_search_plain(er, ei, cos_t, sin_t, grid, N, T)))
        ph1 = (-np.pi / 4 + np.pi / 32 * bps_search_cuda(er, ei, cos1, sin1, grid, TWOSTAGE_N1,
                                                          None, T).float()).contiguous()
        fargs = (er, ei, ph1, cd, sd, grid, N, d0f, ddf)
        same8 = bool(torch.equal(bps_fine_cuda(*fargs, None, T), bps_fine_plain(*fargs, T)))
        print("bf16 sweep N=%d T=%d (2 x %d samples): B3 (13 angles) bit-equal to its twin: %s; "
              "B8 (8 offsets) bit-equal: %s [%s]" % (N, T, er.shape[1], same3, same8, card))
        require(same3 and same8, "B3 or B8 with bf16 windows differs from its twin at N=%d, T=%d"
                % (N, T))


# ---------------------------------------------------------------------------
# phases 16 and 17: constellations that are not a square grid
# ---------------------------------------------------------------------------

def grid_alphabets():
    """The alphabets of phases 16 and 17 by key, with their kind and their ``make_tx`` arguments."""
    re, im = np.meshgrid(0.5 * (np.arange(8) - 3.5), 0.5 * (np.arange(4) - 1.5), indexing="ij")
    rect = (re + 1j * im).astype(np.complex64).reshape(-1)
    rect /= np.sqrt(np.mean(np.abs(rect) ** 2))

    def qam(M):
        return (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
    out = {"rect 8x4": (rect, dict(const=rect)), "cross32": (qam(32), dict(M=32)),
           "cross128": (qam(128), dict(M=128)), "warped64": (warped_qam(64), None),
           "apsk32": (apsk_const(32), None), "warped256": (warped_qam(256), None)}
    return {k: (c, dict(const=c) if tx is None else tx) for k, (c, tx) in out.items()}


def synth_planes(const, L, dev, seed):
    """Two modes of ``const`` on the card with a random-walk carrier phase and noise: (er, ei).

    The input of a phase search as the filter leaves it: 24 dB SNR and a
    phase step of 0.01 rad per sample, made on the card from a seed.
    """
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.as_tensor(const, device=dev)
    syms = c[torch.randint(0, c.shape[0], (2, L), generator=g, device=dev)]
    ph = torch.cumsum(0.01 * torch.randn(2, L, generator=g, device=dev), -1)
    noise = 10 ** (-24 / 20) / np.sqrt(2) * torch.complex(
        torch.randn(2, L, generator=g, device=dev), torch.randn(2, L, generator=g, device=dev))
    z = syms * torch.polar(torch.ones_like(ph), ph) + noise
    return z.real.contiguous(), z.imag.contiguous()


def grid_trainer_check(what, P, chain, card, nblocks=GRID_BLOCKS):
    """B1's sbd, mddma and dd on the chain's constellation against the plain block trainer.

    From the taps of the chain's own first stage, over ``nblocks`` blocks:
    a decision is discontinuous, so a rounding difference at a boundary
    moves one error by a level spacing and long runs part, as rde's do.
    Returns (worst tap difference, the first stage's taps).
    """
    os_, mu, S, trs = GRID_CFG["os"], GRID_CFG["mu"], GRID_CFG["block_size"], GRID_CFG["TrSyms"]
    pts = chain.gen_points
    _, w1, _ = train_block_cuda(P, trs, 1, os_, mu, chain.w0, chain.specs[0], True, S)
    w1 = cma_singularity_guard(w1)
    kind = chain.backend_info["grid_kind"]
    worst = 0.0
    for method in ("sbd", "mddma", "dd"):
        spec = eqops.ErrSpec(method, chain.grid)
        args = (P, nblocks * S, 1, os_, mu, w1, spec, True, S)
        e_p, w_p, mu_p = train_block_plain(*args)
        got = train_block_cuda(*args, pts)
        e_k, w_k, mu_k = got
        require(all(torch.equal(x, y) for x, y in zip(got, train_block_cuda(*args, pts))),
                "two launches of B1 on one input differ (%s, %s)" % (what, method))
        d_taps = float((w_k - w_p).abs().max())
        d_mu = float(((mu_k - mu_p) / mu_p).abs().max())
        d_err = float((e_k - e_p).abs().max())
        print("B1 train_block %s on %s (grid %s), %d blocks: taps max|d| %.3e (tol %.0e), mu rel "
              "%.3e (tol %.0e), err max|d| %.3e (tol %.0e); kernel %.4f ms over %d blocks [%s]"
              % (method, what, kind, nblocks, d_taps, TOL_GRID_TAPS, d_mu, TOL_MU_REL, d_err,
                 TOL_GRID_ERR, device_ms(lambda: train_block_cuda(
                     P, trs, 1, os_, mu, w1, spec, True, S, pts), 10), trs // S, card))
        require(d_taps <= TOL_GRID_TAPS and d_mu <= TOL_MU_REL and d_err <= TOL_GRID_ERR,
                "B1 %s disagrees with its plain version on %s" % (method, what))
        worst = max(worst, d_taps)
    return worst, w1


def check_grid_kernels(dev, card):
    """Phase 16: B3, B8 and B1 on every kind of constellation against their plain versions.

    B3 at the single (64 angles, N = 14) and the twostage coarse (16 angles,
    N = 60) shape and B8 (8 offsets, N = 14) on 2 x 2^20 synthetic samples
    of each alphabet; B1's three decision methods over 8 blocks on a
    2^15-symbol capture of it.
    """
    rec = {}
    for key, (const, txkw) in grid_alphabets().items():
        sel = dict(M=txkw["M"]) if "M" in txkw else dict(symbols=const)
        single = make_rx_chain(**GRID_CFG, bps_N=14, bps_mode="single", **sel, device=dev)
        grid, pts = single.grid, single.gen_points
        require(single.search_grid is grid, "the single mode searches the alphabet itself")
        er, ei = synth_planes(const, NSYM, dev, 7)
        slow = (5, 1) if pts is not None else (20, 5)
        rec["B3", key + " A=64"], _ = b3_record(er, ei, single.bps_cos, single.bps_sin, grid, 14,
                                                pts, key, slow)
        ang = np.linspace(-np.pi / 4, np.pi / 4, 16, endpoint=False, dtype=np.float32)
        cos1, sin1 = (torch.as_tensor(t, device=dev) for t in phops.bps_tables(ang, grid))
        rec["B3", key + " A=16"], idx1 = b3_record(er, ei, cos1, sin1, grid, TWOSTAGE_N1, pts, key,
                                                   slow)
        ph1 = -np.pi / 4 + np.pi / 2 / 16 * idx1.to(torch.float32)
        cd, sd, d0f, ddf = phops.fine_tables(16, TWOSTAGE_B, grid)
        rec["B8", key], _ = b8_record(er, ei, ph1, torch.as_tensor(cd, device=dev),
                                      torch.as_tensor(sd, device=dev), grid, 14, d0f, ddf, pts,
                                      key, slow)
        del er, ei
        E, _, _ = make_tx(2 ** 15, **txkw)
        P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
        grid_trainer_check(key, P, single, card)
    print_times(rec, card)


def grid_trainer_depth_check(path, P, chain, w1, const):
    """B1's second stage at the path's own 64 blocks against the plain trainer, from taps ``w1``.

    Where :func:`grid_trainer_check` holds 8 blocks to 3e-7, this holds the
    launch that the path times: the two error traces up to the first sample
    where they part (a decision that fell the other way), the taps within
    the 8 blocks' bound if they never part and within the step of one
    flipped decision if they do, and the symbols that the chain recovers
    with either taps to shared decisions. Returns (taps max|d|, its
    tolerance, share of decisions).
    """
    os_, mu, S, trs = GRID_CFG["os"], GRID_CFG["mu"], GRID_CFG["block_size"], GRID_CFG["TrSyms"]
    args = (P, trs, 1, os_, mu, w1, chain.specs[1], True, S)
    e_p, w_p, mu_p = train_block_plain(*args)
    e_k, w_k, mu_k = train_block_cuda(*args, chain.gen_points)
    parted = ((e_k - e_p).abs() > TOL_GRID_ERR).any(0).nonzero()
    first = int(parted[0]) if parted.numel() else trs
    d_taps = float((w_k - w_p).abs().max())
    tol = TOL_GRID_TAPS if first == trs else TOL_GRID_TAPS_DEPTH
    outs = [torch.complex(*chain.tracking_planes(P, w_)) for w_ in (w_k, w_p)]
    trim = slice(GATE_TRIM, -GATE_TRIM)
    share = shared_decisions(outs[0][:, trim], outs[1][:, trim], const)
    print("B1 train_block %s on %s (grid %s), %d blocks: errors within %.0e up to sample %d of "
          "%d (%s), taps max|d| %.3e (tol %.0e), mu rel %.3e; the chain's output with either taps "
          "shares %.6f of its decisions (min %.3f)"
          % (chain.specs[1].method, path, chain.backend_info["grid_kind"], trs // S, TOL_GRID_ERR,
             first, trs, "no decision parts" if first == trs else "a decision parts there", d_taps,
             tol, float(((mu_k - mu_p) / mu_p).abs().max()), share, SMALL_AGREE))
    require(first >= GRID_BLOCKS * S and d_taps <= tol and share >= SMALL_AGREE,
            "B1 %s disagrees with its plain version over %d blocks on %s"
            % (chain.specs[1].method, trs // S, path))
    return d_taps, tol, share


def grid_path_records(path, chain, P, w, const, card):
    """The kernels of one phase-17 path against their plain versions on that path's own inputs."""
    rec = {}
    d_taps8, w1 = grid_trainer_check(path, P, chain, card)
    d_taps, tol, share = grid_trainer_depth_check(path, P, chain, w1, const)
    os_, mu, S, trs = GRID_CFG["os"], GRID_CFG["mu"], GRID_CFG["block_size"], GRID_CFG["TrSyms"]
    b1 = (P, trs, 1, os_, mu, w1, chain.specs[1], True, S)
    kind, p = phops.grid_decision_info(chain.grid)
    decide_ops = OPS_GEN_POINT * len(p[0]) if kind == "gen" else OPS_DECIDE[kind]
    rec["B1"] = dict(**trainer_bound(2, 2, GRID_CFG["Ntaps"], os_, trs, 1, decide_ops),
                     err=d_taps,
                     ms=device_ms(lambda: train_block_cuda(*b1, chain.gen_points), 20),
                     plain_ms=device_ms(lambda: train_block_plain(*b1), 2),
                     shape="%s on grid %s, 64 blocks of 256: max_abs_err is the taps' there (tol "
                           "%.0e, decisions shared %.6f); over %d blocks the worst of sbd, mddma, "
                           "dd is %.3e (tol %.0e)"
                           % (chain.specs[1].method, chain.backend_info["grid_kind"],
                              tol, share, GRID_BLOCKS, d_taps8, TOL_GRID_TAPS))
    rec["B2"], outs = b2_record(P, os_, w, chain.dec, path,
                                "2 x 2^21 samples in, %s" % ("stride-%d side output" % chain.dec
                                                             if chain.dec else "no side output"))
    eqp = outs[0]
    no = eqp.shape[0] // 2
    er, ei = eqp[:no], eqp[no:]
    pts = chain.gen_points
    if chain.mode == "decimated":
        decp = outs[1]
        rec["B3"], idx = b3_record(decp[:no].contiguous(), decp[no:].contiguous(), chain.bps_cos,
                                   chain.bps_sin, chain.search_grid, chain.search_N, pts, path,
                                   (50, 10))
        rec["B4"] = b4_record(eqp, idx, chain, path)
    else:
        slow = (5, 1) if phops.grid_decision_info(chain.search_grid)[0] == "gen" else (20, 5)
        rec["B3"], idx = b3_record(er, ei, chain.bps_cos, chain.bps_sin, chain.search_grid,
                                   chain.search_N, pts, path, slow)
        ph = chain.lo_a + chain.step_a * idx.to(torch.float32)
        if chain.mode == "twostage":
            rec["B8"], ph = b8_record(er, ei, ph, chain.fine_cos, chain.fine_sin, chain.fine_grid,
                                      chain.bps_N, chain.fine_d0, chain.fine_step, pts, path)
        rec["B7"] = b7_record(er, ei, ph, path)
    rec = {(k, path): dict(v, grid=v.get("grid", chain.backend_info["grid_kind"]))
           for k, v in rec.items()}
    print_times(rec, card)
    return rec


def grid_phases(dev, card):
    """Phases 16 and 17. Returns (kernel records keyed by (kernel, path), launches per path)."""
    check_grid_kernels(dev, card)
    alphabets = grid_alphabets()
    rec, path_launches = {}, {}
    captures = {}
    for path, key, kw in GRID_PATHS:
        const, txkw = alphabets[key]
        if key not in captures:
            t0 = time.perf_counter()
            captures.clear()              # one 2^20-symbol capture on the card at a time
            E, syms, coded = make_tx(NSYM, **txkw)
            captures[key] = (
                torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev),
                torch.as_tensor(syms, device=dev), coded)
            print("tx %s: %d symbols x 2 pol, %d points, %.2f s on the host"
                  % (key, NSYM, coded.size, time.perf_counter() - t0))
        P, ref, coded = captures[key]
        sel = dict(M=txkw["M"]) if "M" in txkw else dict(symbols=const)
        launches, chain, w, _ = chain_path(path, dict(GRID_CFG, **kw, **sel), GRID_SER_LIMIT, P,
                                           ref, coded, dict(txkw, seed=SMALL_SEED.get(key, 2)),
                                           card)
        path_launches[path] = launches
        rec.update(grid_path_records(path, chain, P, w, coded, card))
    return rec, path_launches


def with_syncs(fn):
    """(``fn()``, the synchronising calls it made as the CUDA sync debug mode reports them)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return res, [str(w.message).splitlines()[0] for w in seen
                 if "Synchronization debug mode is a prototype" not in str(w.message)]


def syncs_in(fn):
    """How many synchronising calls ``fn`` makes, as the CUDA sync debug mode reports them."""
    return with_syncs(fn)[1]


def pilot_stages(chain, pr, pi, frame_base=0):
    """The pilot chain's stages run one by one: a dict of every stage's inputs and outputs.

    ``segs`` are the pilot segments the trainer takes, ``P`` the capture the
    frame body reads (derotated by the pilot FOE on a ``foe_comp`` chain).
    In the serving form ``cargs`` are B5's arguments as the chain gives them
    (the frame filter's pilot side output, read contiguous) and ``sargs`` the
    same pilots read strided from the filter output (B5's other form).
    """
    P = chain._planes(pr, pi)
    wxs, best_w = chain.sync_search(P)
    mode_order, shift, _, _ = chain.align(P, wxs, best_w)
    eqsh = chain._eq_shift(shift)
    segs = chain.segments(P, eqsh, mode_order)
    if chain.eq_trainer == "ls":
        w, foe = chain.ls_taps(segs), None
    else:
        w, foe = chain.lms_taps(segs)
    if chain.foe_comp:
        P = derotate_planes(P, foe, chain.os)
    taps = w.index_select(1, torch.argsort(mode_order))
    offs = chain.frame_offsets(P, eqsh, frame_base)
    st = dict(P=P, wxs=wxs, best_w=best_w, mode_order=mode_order, eqsh=eqsh, segs=segs,
              taps=taps, foe=foe, offs=offs)
    if not chain.kernel_interp:
        out = apply_filter_frames(P, chain.os, taps, offs, chain.frame_len)
        return dict(st, out=out, rows=out.shape[1] * out.shape[2])
    out, side = apply_filter_frames(P, chain.os, taps, offs, chain.frame_len, pilot_side(chain))
    rows = out.shape[1] * out.shape[2]
    symr, symi = out[0].reshape(rows, -1), out[1].reshape(rows, -1)
    zr, zi = side[0].reshape(rows, -1), side[1].reshape(rows, -1)
    tail = (chain.n_head, chain.npts, chain.cpe_dx, chain.cpe_avg, chain.nbt)
    cargs = (zr, zi, chain.pil_r, chain.pil_i, 0, 1, *tail)
    sargs = (symr, symi, chain.pil_r, chain.pil_i, chain.seq_len, chain.ins_rat, *tail)
    return dict(st, rows=rows, out=out, side=side, symr=symr, symi=symi, cargs=cargs,
                sargs=sargs)


def plain_trace(chain, zr, zi):
    """The plain CPE trace of (rows, frame_len) planes whose rows run (mode, frame)."""
    n, F_ = chain.nmodes, chain.frame_len
    return chain.cpe_trace(zr.reshape(n, -1, F_), zi.reshape(n, -1, F_)).reshape(zr.shape)


def pilot_side(chain):
    """The frame filter's pilot side output of ``chain``: (poff, pstride, npil)."""
    return chain.seq_len, chain.ins_rat, chain.nblk


def b2_frames_record(chain, st, offs, what, err):
    """B2's frame entry on ``offs``: with the pilot side output (the serving path's form) and
    without, the main outputs bit-equal and the side output bit-equal to the main output's pilot
    columns; times of both beside the bound, the plain version and the grouped ``conv1d``.
    ``err``: the main output's error against the plain version, measured by the caller."""
    P, taps, F_ = st["P"], st["taps"], chain.frame_len
    n, nf = taps.shape[0], offs.shape[1]
    pil = pilot_side(chain)
    poff, pstride, npil = pil
    got, side = apply_filter_frames_cuda(P, chain.os, taps, offs, F_, pil)
    bare = apply_filter_frames_cuda(P, chain.os, taps, offs, F_)
    same_main = torch.equal(got, bare)
    same_side = torch.equal(side, got[..., poff::pstride][..., :npil])
    print("B2 frames (%s, %d frames): main output with the pilot side output bit-equal to it "
          "without: %s; side output %s bit-equal to the main output's columns %d + %d p: %s"
          % (what, nf, same_main, tuple(side.shape), poff, pstride, same_side))
    require(same_main, "B2's frame entry changes its main output with the side output (%s)" % what)
    require(same_side, "B2's pilot side output is not the pilot columns (%s)" % what)
    del bare
    # each input read once: the span of the capture that the frames' windows cover
    span = int(offs.max() - offs.min()) + chain.fr_len
    plan = filter_plan(n, n, chain.Ntaps, chain.os, F_, nf)
    print("B2 frames (%s, %d frames): %s" % (what, nf, plan_text(plan)))
    fargs = (P, chain.os, taps, offs, F_)
    rec = dict(**bound(4 * 2 * n * span + nbytes(taps, offs, got, side),
                       OPS_FILTER_TAP * n * chain.Ntaps * n * nf * F_),
               err=err, ms=device_ms(lambda: apply_filter_frames_cuda(*fargs, pil), 20),
               ms_without_side=device_ms(lambda: apply_filter_frames_cuda(*fargs), 20),
               plain_ms=device_ms(lambda: apply_filter_frames_plain(*fargs, pil), 3),
               shape="%d frames, pilot side output (2, %d, %d, %d); %s"
                     % (nf, n, nf, npil, plan_text(plan)))
    rec["library_ms"] = frames_library(P, chain.os, taps, offs, chain.fr_len, got)
    print("time B2 frames (%s, device, %d frames): with the pilot side output %.4f ms, without "
          "%.4f ms, bound %.5f ms by %s" % (what, nf, rec["ms"], rec["ms_without_side"],
                                            rec["bound_ms"], rec["bound_by"]))
    return rec


def b5_record(chain, st, card, what):
    """B5 against its plain version in both forms: from the side output (the chain's) and
    strided from the filter output; its bound (4 bytes a pilot and plane) and, for the strided
    form, the sector floor (a 32-byte sector a pilot and plane)."""
    rows, cargs, sargs = st["rows"], st["cargs"], st["sargs"]
    npil = chain.nblk
    a_p, b_p = cpe_coeffs_plain(*cargs)
    a_s, b_s = cpe_coeffs_plain(*sargs)
    require(torch.equal(a_p, a_s) and torch.equal(b_p, b_s),
            "the plain B5 differs between the side output and the strided pilots")
    errs = []
    for form, args in (("side output", cargs), ("strided", sargs)):
        a_k, b_k = cpe_coeffs_cuda(*args)
        d_a, d_b = float((a_k - a_p).abs().max()), float((b_k - b_p).abs().max())
        errs.append(max(d_a, d_b))
        print("B5 cpe_coeffs (%s, %s): %d rows x %d pilots -> %s, max|da| %.3e (tol %.0e), "
              "max|db| %.3e (tol %.0e), |a| up to %.2f rad"
              % (what, form, rows, npil, tuple(a_k.shape), d_a, TOL_CPE_A, d_b, TOL_CPE_B,
                 float(a_p.abs().max())))
        require(d_a <= TOL_CPE_A and d_b <= TOL_CPE_B,
                "B5 disagrees with its plain version (%s, %s)" % (what, form))
    rest = nbytes(chain.pil_r, chain.pil_i, a_k, b_k)
    plan = cpe_plan(rows, npil, chain.cpe_avg, chain.npts)
    floor_ms = (2 * 32 * rows * npil + rest) / HBM_BYTES_PER_S * 1e3
    rec = dict(**bound(2 * 4 * rows * npil + rest, OPS_CPE_PILOT * rows * npil),
               err=max(errs), ms=device_ms(lambda: cpe_coeffs_cuda(*cargs), 50),
               strided_ms=device_ms(lambda: cpe_coeffs_cuda(*sargs), 50),
               plain_ms=device_ms(lambda: cpe_coeffs_plain(*cargs), 10),
               shape="%d rows x %d pilots, from the side output; plan %d tiles of %d, %d B "
                     "shared, opt-in %s" % (rows, npil, plan.tiles, plan.tile, plan.smem,
                                            plan.opt_in))
    print("time B5 (%s, device, %d rows x %d pilots): side output %.4f ms beside its bound "
          "%.5f ms (bytes); strided %.4f ms beside its sector floor %.5f ms [%s]"
          % (what, rows, npil, rec["ms"], rec["bound_ms"], rec["strided_ms"], floor_ms, card))
    return rec


def b4_pilot_record(chain, st, what):
    """B4 (sign -1) against its plain version with the coefficients B5 builds on the path."""
    a, b = cpe_coeffs_cuda(*st["cargs"])
    return args_b4_record((st["symr"], st["symi"], a, b, chain.cpe_dx, -1), what + ", pilot CPE")


def synth_cpe_rows(dev, rows, npil, seed, R=PILOT_RAT, seq_len=PILOT_SEQ):
    """(rows, seq_len + R npil) symbol planes on the card whose pilots carry a random-walk phase,
    and the known pilots: the input of B5 at ``npil`` pilots a row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    frame = seq_len + R * npil
    pil = torch.polar(torch.ones(2, npil, device=dev),
                      (torch.randint(0, 4, (2, npil), generator=g, device=dev) + 0.5) * np.pi / 2)
    walk = torch.cumsum(0.05 * torch.randn(rows, npil, generator=g, device=dev), -1)
    sym = torch.complex(torch.randn(rows, frame, generator=g, device=dev),
                        torch.randn(rows, frame, generator=g, device=dev))
    sym[:, seq_len::R] = pil.repeat_interleave(rows // 2, 0) * torch.polar(torch.ones_like(walk),
                                                                          walk)
    return (sym.real.contiguous(), sym.imag.contiguous(), pil.real.contiguous(),
            pil.imag.contiguous())


def check_cpe_lengths(dev, card):
    """Phase 9: B5 at rows of more pilots than its first design took, both forms."""
    for npil, rows in CPE_LENGTHS:
        symr, symi, pr, pi = synth_cpe_rows(dev, rows, npil, npil)
        tail = (PILOT_SEQ // PILOT_RAT + 1, npil - 2, PILOT_RAT, 3, PILOT_SEQ // PILOT_RAT + npil)
        zr, zi = (x[:, PILOT_SEQ::PILOT_RAT].contiguous() for x in (symr, symi))
        for form, args in (("contiguous", (zr, zi, pr, pi, 0, 1, *tail)),
                           ("strided", (symr, symi, pr, pi, PILOT_SEQ, PILOT_RAT, *tail))):
            a_p, b_p = cpe_coeffs_plain(*args)
            a_k, b_k = cpe_coeffs_cuda(*args)
            d_a, d_b = float((a_k - a_p).abs().max()), float((b_k - b_p).abs().max())
            ms = device_ms(lambda: cpe_coeffs_cuda(*args), 20)
            print("B5 cpe_coeffs (%d rows x %d pilots, %s): max|da| %.3e (tol %.0e), max|db| "
                  "%.3e (tol %.0e), %d tiles a row; %.4f ms [%s]"
                  % (rows, npil, form, d_a, TOL_CPE_A, d_b, TOL_CPE_B,
                     cpe_plan(rows, npil, 3).tiles, ms, card))
            require(d_a <= TOL_CPE_A and d_b <= TOL_CPE_B,
                    "B5 disagrees with its plain version at %d pilots (%s)" % (npil, form))


def check_pilot_kernels(chain, st, card):
    """Phase 9: B2's frame entry, B5, B4 and B6 against their plain versions at the pilot shapes.

    The inputs are the pilot path's own (``st``, from :func:`pilot_stages`):
    the capture, the state the chain acquires on it, the filter output and
    its pilot side output, and the CPE coefficients built from it. Returns
    records keyed by (kernel, path): the serving path's shapes for "pilot"
    and the first ``PHASE_FRAMES`` frames for "pilot return_phase".
    """
    rec = {}
    P, eqsh, taps = st["P"], st["eqsh"], st["taps"]
    F, n, nr = chain.frame_len, chain.nmodes, PHASE_FRAMES

    # B2, frame entry: every frame of the dispatch against the reference's
    # form, nmodes^2 virtual input planes and block-diagonal taps through the
    # plain filter, one frame at a time
    offs = chain.frame_offsets(P, eqsh)
    got = st["out"]
    same = torch.equal(got, apply_filter_frames_cuda(P, chain.os, taps, offs, F,
                                                     pilot_side(chain))[0])
    d_modes = (offs[1] - offs[0]).abs()
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
          "first %d, against the virtual-input form (tol %.0e x rms %.3f); two launches "
          "bit-equal: %s; the output modes' windows %d-%d samples apart"
          % (tuple(got.shape), max(d_f), len(d_f), max(d_f[:nr]), nr, TOL_FILTER_REL, rms, same,
             int(d_modes.min()), int(d_modes.max())))
    require(max(d_f) <= TOL_FILTER_REL * rms, "B2's frame entry disagrees with the plain form")
    require(same, "two launches of B2's frame entry differ")
    rec["B2 frames", "pilot"] = b2_frames_record(chain, st, offs, "pilot", max(d_f))
    # the return_phase chain's frames take no side output
    o = offs[:, :nr].contiguous()
    fargs = (P, chain.os, taps, o, F)
    span = int(o.max() - o.min()) + chain.fr_len
    plan = filter_plan(n, n, chain.Ntaps, chain.os, F, nr)
    print("B2 frames (pilot return_phase, %d frames): %s" % (nr, plan_text(plan)))
    rec["B2 frames", "pilot return_phase"] = dict(
        **bound(4 * 2 * n * span + nbytes(taps, o) + 4 * 2 * n * nr * F,
                OPS_FILTER_TAP * n * chain.Ntaps * n * nr * F),
        err=max(d_f[:nr]), ms=device_ms(lambda: apply_filter_frames_cuda(*fargs), 20),
        plain_ms=device_ms(lambda: apply_filter_frames_plain(*fargs), 3),
        shape="%d frames; %s" % (nr, plan_text(plan)))
    rec["B2 frames", "pilot return_phase"]["library_ms"] = frames_library(
        P, chain.os, taps, o, chain.fr_len, got[:, :, :nr])

    # B5 on all 480 rows, in both forms; then at rows of more pilots
    rec["B5", "pilot"] = b5_record(chain, st, card, "pilot")
    check_cpe_lengths(P.device, card)

    # B4 (sign -1, dx 32) with those coefficients
    rec["B4", "pilot"] = b4_pilot_record(chain, st, "pilot")

    # B6 with the plain CPE trace: on all 480 rows, and on the rows of the
    # return_phase chain's first frames, which that path derotates
    symr, symi, rows = st["symr"], st["symi"], st["rows"]
    out = torch.stack([symr, symi]).reshape(2, n, -1, F)
    sub = out[:, :, :nr].reshape(2, n * nr, F)
    for what, (zr, zi) in (("%d rows" % rows, (symr, symi)),
                           ("%d rows" % (n * nr), (sub[0].contiguous(), sub[1].contiguous()))):
        sargs = (zr, zi, plain_trace(chain, zr, zi), -1)
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
    plain version's time at that length). The kernel's time printed here is one
    call's, the host's dispatch and a first launch included; the equaliser
    phase times it over repeated calls with the host hidden (``device_ms``).
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
    t_p = 0.0
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
            t_p = ms_p
    print("B9 worst over %d cases: taps %.3e, mu rel %.3e, err %.3e [%s]"
          % (len(cases), worst["taps"], worst["mu"], worst["err"], card))
    return worst, t_p


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
    worst, t_p4096 = seq_check
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
    # the whole stage against the same stage cut into launches of 4096 symbols that hand
    # the taps and the step on: with a fixed step the two are the same recurrence, so they
    # must agree bit for bit at every chunk end (the adaptive rule also keeps the previous
    # error, which a launch starts anew, so its cut run is another recurrence)
    for m, sy in ((m1, s1), (m2, s2)):
        e_whole, w_whole, mu_whole = train_seq_cuda(P, trs, 1, 2, EQ_MU[0], w0, sy, m, False)
        w_c, mu_c, e_c = w0, EQ_MU[0], []
        for start in range(0, trs, SEQ_TRS):
            e, w_c, mu_c = train_seq_cuda(P[:, 2 * start:].contiguous(), min(SEQ_TRS, trs - start),
                                          1, 2, mu_c, w_c, sy, m, False)
            e_c.append(e)
        same_cut = bool(torch.equal(torch.cat(e_c, dim=-1), e_whole)
                        and torch.equal(w_c, w_whole) and torch.equal(mu_c, mu_whole))
        print("B9 train_seq %s, fixed step: %d symbols in one launch against %d launches of %d "
              "that hand taps and step on: errors, taps and step bit-equal: %s"
              % (m, trs, len(e_c), SEQ_TRS, same_cut))
        require(same_cut, "B9 cut into launches differs from the whole stage (%s)" % m)
    a2 = (P, trs, 1, 2, EQ_MU[1], w1, s2, m2, True)
    t_b9 = {m1: device_ms(lambda: train_seq_cuda(*a1), 3),
            m2: device_ms(lambda: train_seq_cuda(*a2), 3)}
    for m, t in t_b9.items():
        print("time B9 train_seq %s adaptive, %d symbols: %.4f ms, %.1f ns per symbol [%s]"
              % (m, trs, t, t / trs * 1e6, card))
        print_chain("B9 train_seq %s" % m, lat, trs, seq_chain_cycles(lat, 2 * ntaps, m), t, card,
                    "symbol")
    # B9's bound at each shape the table keeps (the same for either stage's method) and its
    # chain bound at the 4096-symbol launch held against the plain version
    b_path, b_head = (trainer_bound(2, 2, ntaps, 2, n, 1) for n in (trs, SEQ_TRS))
    print("bound B9 train_seq (equaliser seq): %d symbols %.5f ms by %s, %d symbols %.7f ms by "
          "%s" % (trs, b_path["bound_ms"], b_path["bound_by"], SEQ_TRS, b_head["bound_ms"],
                  b_head["bound_by"]))
    t_k4096 = device_ms(lambda: train_seq_cuda(*head), 10)
    busy4096, ops4096, _ = device_busy(lambda: train_seq_cuda(*head), 10)
    print("time B9 train_seq %s adaptive, %d symbols: %.4f ms with the host hidden, device busy "
          "%.4f ms in %.1f ops a call [%s]" % (m1, SEQ_TRS, t_k4096, busy4096, ops4096, card))
    print_chain("B9 train_seq %s at %d symbols" % (m1, SEQ_TRS), lat, SEQ_TRS,
                seq_chain_cycles(lat, 2 * ntaps, m1), t_k4096, card, "symbol")
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
        rec["B2", path], _ = b2_record(P, 2, taps[path][0], None, path,
                                       "2 x 2^19 samples in, no side output")
    print_times(rec, card)
    return rec, path_launches


def small_pilot_check(path, cfg, dev):
    """A path's pilot chain on the card against the plain CPU chain on a small capture.

    ``make_pilot_tx(6, 2**14, 512)`` on the CPU, frames 0-2, 17 taps, the
    path's other settings ``cfg``: the same shift and mode order, and the
    decisions shared at least ``SMALL_AGREE``.
    """
    small = make_pilot_tx(6, frame_len=2 ** 14, seq_len=512, device="cpu")
    scfg = dict(cfg, Ntaps=17, frames=(0, 1, 2))
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
    print("%s, small capture (2^14 frame, 512 sequence, 3 frames, 17 taps): card vs plain CPU "
          "chain agree on %.6f of decisions (min %.3f); shift/mode_order equal: %s; max|d| %.3e"
          % (path, agree, SMALL_AGREE, same_state, float((runs[0][0] - runs[1][0]).abs().max())))
    require(agree >= SMALL_AGREE and same_state,
            "the card's %s chain disagrees with the CPU's" % path)


def pilot_phases(dev, card, lat):
    """Phases 9-12: the pilot chains. Returns (kernel records, launches per path)."""
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
    print("pilot main path: the frame filter hands B5 its pilot side output %s (pilots %d + %d p)"
          % (tuple(st["side"].shape), chain.seq_len, chain.ins_rat))
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

    small_pilot_check("pilot", dict(PILOT_CFG, return_phase=False), dev)

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
    P, wxs, best_w, mode_order, eqsh, segs, taps, offs, symr, symi, cargs = (st[k] for k in (
        "P", "wxs", "best_w", "mode_order", "eqsh", "segs", "taps", "offs", "symr", "symi",
        "cargs"))
    a, b = cpe_coeffs(*cargs)
    outr, outi = interp_rotate(symr, symi, a, b, chain.cpe_dx, -1)
    stages = {
        "sync search (%d windows, batched CMA)" % chain.W: lambda: chain.sync_search(P),
        "alignment (filter, FOE, xcorr, assignment)": lambda: chain.align(P, wxs, best_w),
        "pilot segments": lambda: chain.segments(P, eqsh, mode_order),
        "LS solve": lambda: chain.ls_taps(segs),
        "frame filter (B2 frames, with the pilot side output)":
            lambda: apply_filter_frames(P, chain.os, taps, offs, chain.frame_len,
                                        pilot_side(chain)),
        "CPE coefficients (B5, from the side output)": lambda: cpe_coeffs(*cargs),
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
    payload_forms(chain, outr, outi, card)
    del st, stages, outr, outi, a, b, P, wxs, segs, symr, symi, cargs
    launches_all = {"pilot": launches, "pilot return_phase": launches_rp}
    lms_rec, launches_all["pilot lms"] = pilot_lms_path(tx, chain, card, lat)
    rec.update(lms_rec)
    nb_rec, launches_all["pilot non-blocked"] = pilot_nonblocked_path(tx, card)
    rec.update(nb_rec)
    sch_launches = pilot_schedule_paths(tx, chain, (dr, di), card)
    launches_all.update(sch_launches)
    for path in sch_launches:       # the scan's kernels at the scan's shapes: phase 12's records
        rec.update({(k, path): rec[k, "pilot"] for k in ("B2 frames", "B5", "B4")})
    del tx, chain, dr, di, pdr, pdi
    long_rec, launches_all["pilot long frames"] = pilot_long_path(card)
    rec.update(long_rec)
    foe_rec, launches_all["pilot foe"] = pilot_foe_path(card, lat)
    rec.update(foe_rec)
    gran_rec, launches_all["pilot granular"] = pilot_granular_path(dev, card, lat)
    rec.update(gran_rec)
    return rec, launches_all


def pilot_schedule_paths(tx, scan, scan_out, card):
    """Phase 12c: the frame schedules "span" and "pack" on the 240-frame cell, beside ``scan``.

    Both run the batched frame body (B2 frames, B5 and B4 once each, at the scan's shapes):
    span with its windows cut from one clamped span, a pack as the whole batch. Each: counted,
    under the BER gate, its payload against the scan's (span within the reference's 1e-4, pack
    bit for bit), no synchronising call, the tracking entry bit-exact (the complex one for
    span: ``tracking_planes`` takes scan and vmap only), timed in turn with the scan. Returns
    the launches per path.
    """
    pr, pi = tx.planes[:2], tx.planes[2:]
    nd = tx.idx_tx.shape[-1]
    npay = 2 * PILOT_FRAMES * nd
    launches_all = {}
    want = {"B2 frames": 1, "B5": 1, "B4": 1}
    for path, kw in (("pilot span", dict(frames_mode="span")),
                     ("pilot frames_pack %d" % PACK, dict(frames_pack=PACK))):
        chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, PILOT_FRAME, PILOT_RAT,
                                    frames=range(PILOT_FRAMES), return_phase=False,
                                    **PILOT_CFG, **kw)
        span = chain.schedule == "span"
        ((dr, di), info), launches = counted(lambda: chain.planes(pr, pi))
        print("%s (schedule %s) launches: %s" % (path, chain.schedule, launches))
        require(launches == expected(want), "the %s path did not launch each kernel as expected"
                % path)
        gate = ber_gate(dr, di, tx, info["sync_corr"])
        d = max(float((dr - scan_out[0]).abs().max()), float((di - scan_out[1]).abs().max()))
        tol = TOL_SPAN if span else 0.0
        print("%s: BER %.3e SER %.3e, sync_corr %.1f; payload against the scan's max|d| %.3e "
              "(tol %.0e)" % (path, gate["ber"], gate["ser"], gate["sync_corr"], d, tol))
        require(gate["ok"], "%s BER gate failed (BER <= 1e-5 and sync_corr >= 120)" % path)
        require(d <= tol, "%s payload departs from the scan's" % path)
        syncs = syncs_in(lambda: chain.planes(pr, pi))
        print("%s dispatch: %d synchronising calls" % (path, len(syncs)))
        require(not syncs, "%s synchronises the host" % path)
        targs = (info["taps"], info["shift"], info["mode_order"])
        E = torch.complex(pr, pi)
        if span:
            tout = chain.tracking(E, *targs)[0]
            exact = bool(torch.equal(tout, torch.complex(dr, di)))
        else:
            tr, ti = chain.tracking_planes(pr, pi, *targs)[0]
            exact = bool(torch.equal(tr, dr) and torch.equal(ti, di))
        print("%s tracking == planes payload: %s" % (path, exact))
        require(exact, "%s tracking output differs from the full chain" % path)
        t = [cuda_ms(lambda: scan.planes(pr, pi), 5), cuda_ms(lambda: chain.planes(pr, pi), 5),
             cuda_ms(lambda: chain.planes(pr, pi), 5), cuda_ms(lambda: scan.planes(pr, pi), 5)]
        t_trk = [cuda_ms(lambda: scan.tracking_planes(pr, pi, *targs), 10),
                 cuda_ms((lambda: chain.tracking(E, *targs)) if span
                         else (lambda: chain.tracking_planes(pr, pi, *targs)), 10)]
        print("time %s chain.planes: %.4f, %.4f ms (%.1f payload Msym/s) beside scan %.4f, %.4f "
              "ms (%.1f); tracking %.4f ms beside scan's %.4f ms [%s]"
              % (path, t[1], t[2], npay / min(t[1:3]) / 1e3, t[0], t[3],
                 npay / min(t[0], t[3]) / 1e3, t_trk[1], t_trk[0], card))
        launches_all[path] = launches
        del dr, di, info, E
    return launches_all


def payload_forms(chain, outr, outi, card, rounds=3):
    """The payload of the blocked layout two ways, alternated: the gather at the data positions
    (the chain's form for every layout) and a strided reshape that drops each block's pilot."""
    n, F_ = chain.nmodes, chain.frame_len

    def gather(x):
        return x.reshape(n, -1, F_).index_select(-1, chain.dat_idx).reshape(n, -1)

    def strided(x):
        x = x.reshape(n, -1, F_)[..., chain.seq_len:]
        return x.reshape(n, -1, chain.nblk, chain.ins_rat)[..., 1:].reshape(n, -1)
    require(torch.equal(gather(outr), strided(outr)), "the two payload forms differ")
    for r in range(rounds):
        for name, f in (("gather", gather), ("strided reshape", strided)):
            fn = lambda: (f(outr), f(outi))   # noqa: E731
            b, nk, _ = device_busy(fn, 3)
            print("time pilot payload form %s (round %d): device busy %.4f ms in %d device ops, "
                  "stream time alone %.4f ms [%s]" % (name, r, b, nk, cuda_ms(fn, 5), card))


def pilot_long_path(card):
    """The path "pilot long frames": frames of 2^18 symbols, 8,160 CPE pilots a row.

    One dispatch of 16 frames through ``PilotRxChain.planes``, counted (B2
    frames, B5, B4 once each), under the BER gate, tracking bit-exact, and its
    kernels against their plain versions on its own inputs; then the capture
    of seed 3, on which the frame sync fails as the reference's does (see
    ``PILOT_LONG``), counted and held to the port's plain CPU chain: the same
    shift and mode order, sync_corr within 1e-4, the same outcome of the BER
    gate and 99.9 % of the decisions. Returns (records, launches).
    """
    path, cfg = "pilot long frames", PILOT_LONG
    F_ = cfg["frame_len"]

    def dispatch(seed):
        t0 = time.perf_counter()
        tx = make_pilot_tx(cfg["tx_frames"], frame_len=F_, seed=seed)   # on the card
        chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, F_, PILOT_RAT,
                                    frames=range(cfg["frames"]), return_phase=False, **PILOT_CFG)
        pr, pi = tx.planes[:2], tx.planes[2:]
        ((dr, di), info), launches = counted(lambda: chain.planes(pr, pi))
        nd = tx.idx_tx.shape[-1]
        require(launches == expected({"B4": 1, "B2 frames": 1, "B5": 1}),
                "the %s path did not launch each kernel once (seed %d): %s"
                % (path, seed, launches))
        require(tuple(dr.shape) == (2, cfg["frames"] * nd) and dr.shape == di.shape
                and bool(torch.isfinite(dr).all() and torch.isfinite(di).all()),
                "%s payload of shape %s, or not finite" % (path, tuple(dr.shape)))
        gate = ber_gate(dr, di, tx, info["sync_corr"])
        print("%s, seed %d: %d frames of SignalWithPilots(64, %d, %d, %d) statistics, %d CPE "
              "pilots a row, launches %s; BER %.3e SER %.3e over 2 x %d x %d payload symbols, "
              "sync_corr %.1f, shift %s, mode_order %s (%.2f s with the capture)"
              % (path, seed, cfg["tx_frames"], F_, PILOT_SEQ, PILOT_RAT, chain.nblk, launches,
                 gate["ber"], gate["ser"], cfg["frames"], nd, gate["sync_corr"],
                 info["shift"].tolist(), info["mode_order"].tolist(),
                 time.perf_counter() - t0))
        return tx, chain, (dr, di), info, launches, gate

    tx, chain, (dr, di), info, launches, gate = dispatch(cfg["seed"])
    require(gate["ok"], "the %s BER gate failed (BER <= 1e-5 and sync_corr >= 120)" % path)
    pr, pi = tx.planes[:2], tx.planes[2:]
    (tr, ti), _ = chain.tracking_planes(pr, pi, info["taps"], info["shift"], info["mode_order"])
    exact = bool(torch.equal(tr, dr) and torch.equal(ti, di))
    print("%s tracking_planes == planes payload: %s" % (path, exact))
    require(exact, "the %s tracking output differs from the full chain" % path)
    npay = dr.numel()
    t_trk = cuda_ms(lambda: chain.tracking_planes(pr, pi, info["taps"], info["shift"],
                                                  info["mode_order"]), 5)
    print("time %s chain.tracking_planes (%d frames): %.4f ms, %.1f payload Msym/s [%s]"
          % (path, cfg["frames"], t_trk, npay / t_trk / 1e3, card))

    st = pilot_stages(chain, pr, pi)
    offs = chain.frame_offsets(st["P"], st["eqsh"])
    ref = apply_filter_frames_plain(st["P"], chain.os, st["taps"], offs, F_)
    rms = float(ref.pow(2).mean().sqrt())
    d_f = float((st["out"] - ref).abs().max())
    del ref
    print("B2 frames (%s): %s max|d| %.3e against the plain version (tol %.0e x rms %.3f)"
          % (path, tuple(st["out"].shape), d_f, TOL_FILTER_REL, rms))
    require(d_f <= TOL_FILTER_REL * rms, "B2's frame entry disagrees on the %s path" % path)
    rec = {("B2 frames", path): b2_frames_record(chain, st, offs, path, d_f),
           ("B5", path): b5_record(chain, st, card, path),
           ("B4", path): b4_pilot_record(chain, st, path)}
    print_times(rec, card)
    del st, tx, chain, dr, di, tr, ti

    # the capture whose frame sync fails in the reference too: the card's chain held to the
    # port's plain CPU chain on it, state, sync_corr and the BER gate's outcome
    seed = cfg["sync_fails_seed"]
    tx, chain, (dr, di), info, _, gate = dispatch(seed)
    t0 = time.perf_counter()
    cpu = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, F_, PILOT_RAT,
                              frames=range(cfg["frames"]), return_phase=False, **PILOT_CFG,
                              device="cpu")
    (cr, ci), cinfo = cpu.planes(tx.planes[:2].cpu(), tx.planes[2:].cpu())
    cgate = ber_gate(cr.to(dr.device), ci.to(dr.device), tx, cinfo["sync_corr"])
    same_state = all(cinfo[k].tolist() == info[k].tolist() for k in ("shift", "mode_order"))
    d_corr = abs(float(cinfo["sync_corr"]) - float(info["sync_corr"]))
    agree = float((decide(torch.complex(dr, di).cpu(), tx.coded)
                   == decide(torch.complex(cr, ci), tx.coded)).double().mean())
    print("%s, seed %d: plain CPU chain (%.2f s): shift %s, mode_order %s, sync_corr %.4f (card "
          "%.4f, |d| %.3e, tol %.0e relative), BER %.3e, BER gate %s (card: %s), decisions "
          "agree on %.6f (min %.3f); the frame sync itself fails on this capture, in the JAX "
          "reference too (ROADMAP queue C, C5)"
          % (path, seed, time.perf_counter() - t0, cinfo["shift"].tolist(),
             cinfo["mode_order"].tolist(), float(cinfo["sync_corr"]), float(info["sync_corr"]),
             d_corr, TOL_SYNC_CORR, cgate["ber"], "held" if cgate["ok"] else "failed",
             "held" if gate["ok"] else "failed", agree, LONG_AGREE))
    require(same_state and d_corr <= TOL_SYNC_CORR * abs(float(cinfo["sync_corr"]))
            and cgate["ok"] == gate["ok"] and agree >= LONG_AGREE,
            "the card's %s chain disagrees with the plain CPU chain on seed %d" % (path, seed))
    return rec, launches


def b1_batch_record(chain, segs, path, card, lat):
    """B1 at the LMS pilot trainer's shape: each stage as one launch over the output modes.

    One batch row per output mode (its own segment and taps), against the
    plain block trainer with the same batch and against one launch per row,
    bit for bit; every stage from the kernel's taps of the stage before. The
    first stage is timed beside its bound and its chain bound.
    """
    n, rows = chain.nmodes, segs.shape[0]
    w = chain.w0_eq
    d_taps = d_err = d_mu = 0.0
    per_row_same = True
    for k in range(3):
        spec = chain.stage_specs[k]
        require(spec is not None, "B1 does not take LMS stage %d of the %s path" % (k, path))
        args = (segs, chain.TrS_eq, chain.Niter, chain.os, chain.stages[k][0], w, spec, True,
                chain.block_size)
        e_p, w_p, mu_p = train_block_plain(*args)
        e_k, w_k, mu_k = train_block_cuda(*args)
        for r in range(rows):
            one = train_block_cuda(segs[r], *args[1:5], w[r], *args[6:])
            per_row_same &= all(torch.equal(x, y[r]) for x, y in zip(one, (e_k, w_k, mu_k)))
        d_taps = max(d_taps, float((w_k - w_p).abs().max()))
        d_err = max(d_err, float((e_k - e_p).abs().max()))
        d_mu = max(d_mu, float(((mu_k - mu_p) / mu_p).abs().max()))
        if k == 0:
            args0 = args
        w = w_k
    S, nb = min(chain.block_size, chain.TrS_eq), chain.TrS_eq // min(chain.block_size,
                                                                     chain.TrS_eq)
    steps = chain.Niter * nb
    print("B1 train_block batched (%s): %d rows x 1 output x %d taps, %d blocks of %d, 3 stages: "
          "taps max|d| %.3e (tol %.0e), mu rel %.3e (tol %.0e), err max|d| %.3e (tol %.0e) "
          "against the plain trainer's batch; each row bit-equal to its own launch: %s"
          % (path, rows, n * chain.Ntaps, steps, S, d_taps, TOL_TAPS, d_mu, TOL_SEQ_MU_REL,
             d_err, TOL_SEQ_ERR, per_row_same))
    require(d_taps <= TOL_TAPS and d_mu <= TOL_SEQ_MU_REL and d_err <= TOL_SEQ_ERR,
            "batched B1 disagrees with the plain trainer (%s)" % path)
    require(per_row_same, "a batched B1 row differs from its own launch (%s)" % path)
    K, Ts = n * chain.Ntaps, nb * S
    moved = 4 * (rows * 2 * n * chain.seg_len + 2 * rows * Ts * chain.Niter + 4 * rows * K)
    rec = dict(**bound(moved, chain.Niter * Ts * rows * (OPS_TRAIN_TAP * K + OPS_TRAIN_ERR)),
               err=d_taps, ms=device_ms(lambda: train_block_cuda(*args0), 10),
               plain_ms=device_ms(lambda: train_block_plain(*args0), 2),
               shape="%d rows x 1 output x %d taps, %d blocks of %d, one stage"
                     % (rows, K, steps, S))
    print_chain("B1 train_block batched (%s)" % path, lat, steps, block_chain_cycles(lat, K, S),
                rec["ms"], card, "block")
    return rec


def frames_check(chain, st, path, nframes=PHASE_FRAMES):
    """B2's frame entry against its plain version on a path's first ``nframes`` frames: max|d|."""
    o = st["offs"][:, :nframes].contiguous()
    ref = apply_filter_frames_plain(st["P"], chain.os, st["taps"], o, chain.frame_len)
    d = float((st["out"][:, :, :nframes] - ref).abs().max())
    rms = float(ref.pow(2).mean().sqrt())
    print("B2 frames (%s): first %d frames max|d| %.3e against the plain version (tol %.0e x "
          "rms %.3f)" % (path, nframes, d, TOL_FILTER_REL, rms))
    require(d <= TOL_FILTER_REL * rms, "B2's frame entry disagrees on the %s path" % path)
    return d


def pilot_lms_path(tx, ls_chain, card, lat):
    """The path "pilot lms": the bench's LMS pilot chain over the pilot cell's 240 frames.

    Counted (B1 3, one batched launch a stage; B2 frames, B5, B4 once), under
    the BER gate, tracking bit-exact; B1 batched against the plain trainer
    and against one launch per row; the frame body's kernels against their
    plain versions on this path's own inputs, and timed there; the
    dispatch, its LMS training beside the LS solve, and the tracking entry
    timed.
    """
    path = "pilot lms"
    pr, pi = tx.planes[:2], tx.planes[2:]
    chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, PILOT_FRAME, PILOT_RAT,
                                frames=range(PILOT_FRAMES), return_phase=False, **PILOT_LMS_CFG)
    ((dr, di), info), launches = counted(lambda: chain.planes(pr, pi))
    print("%s launches: %s" % (path, launches))
    require(launches == expected({"B1": 3, "B2 frames": 1, "B5": 1, "B4": 1}),
            "the %s path did not launch each kernel as expected" % path)
    nd = tx.idx_tx.shape[-1]
    require(tuple(dr.shape) == (2, PILOT_FRAMES * nd) and dr.shape == di.shape
            and bool(torch.isfinite(dr).all() and torch.isfinite(di).all()),
            "%s payload of shape %s, or not finite" % (path, tuple(dr.shape)))
    gate = ber_gate(dr, di, tx, info["sync_corr"])
    print("%s: BER %.3e SER %.3e over 2 x %d x %d payload symbols, sync_corr %.1f, shift %s, "
          "mode_order %s" % (path, gate["ber"], gate["ser"], PILOT_FRAMES, nd,
                             gate["sync_corr"], info["shift"].tolist(),
                             info["mode_order"].tolist()))
    require(gate["ok"], "the %s BER gate failed (BER <= 1e-5 and sync_corr >= 120)" % path)
    trk = (info["taps"], info["shift"], info["mode_order"])
    (tr, ti), _ = chain.tracking_planes(pr, pi, *trk)
    exact = bool(torch.equal(tr, dr) and torch.equal(ti, di))
    print("%s tracking_planes == planes payload: %s" % (path, exact))
    require(exact, "the %s tracking output differs from the full chain" % path)
    del tr, ti
    syncs = syncs_in(lambda: chain.planes(pr, pi))
    print("%s dispatch: %d synchronising calls under torch.cuda.set_sync_debug_mode('warn')%s"
          % (path, len(syncs), "".join("\n  " + s for s in syncs)))

    st = pilot_stages(chain, pr, pi)
    rec = {("B1", path): b1_batch_record(chain, st["segs"], path, card, lat)}
    rec["B2 frames", path] = b2_frames_record(chain, st, st["offs"], path,
                                              frames_check(chain, st, path))
    rec["B5", path] = b5_record(chain, st, card, path)
    rec["B4", path] = b4_pilot_record(chain, st, path)
    print_times(rec, card)
    small_pilot_check(path, dict(PILOT_LMS_CFG, return_phase=False), pr.device)

    npay = dr.numel()
    t_full = cuda_ms(lambda: chain.planes(pr, pi), 5)
    t_trk = cuda_ms(lambda: chain.tracking_planes(pr, pi, *trk), 10)
    busy, nk, _ = device_busy(lambda: chain.planes(pr, pi), 2)
    busy_trk, nk_trk, _ = device_busy(lambda: chain.tracking_planes(pr, pi, *trk), 3)
    print("time %s chain.planes (%d frames): %.4f ms, %.1f payload Msym/s; device busy %.4f ms in "
          "%d device ops per call, busy share %.3f [%s]"
          % (path, PILOT_FRAMES, t_full, npay / t_full / 1e3, busy, nk, busy / t_full, card))
    print("time %s chain.tracking_planes (%d frames): %.4f ms, %.1f payload Msym/s; device busy "
          "%.4f ms in %d device ops per call, busy share %.3f [%s]"
          % (path, PILOT_FRAMES, t_trk, npay / t_trk / 1e3, busy_trk, nk_trk, busy_trk / t_trk,
             card))
    segs = st["segs"]
    for what, fn in (("LMS training (3 B1 stages)", lambda: chain.lms_taps(segs)),
                     ("LS solve (the pilot path's trainer)", lambda: ls_chain.ls_taps(segs))):
        st_busy, st_nk, _ = device_busy(fn, 3)
        print("time %s stage %s: device busy %.4f ms in %d device ops, stream time alone %.4f ms "
              "[%s]" % (path, what, st_busy, st_nk, cuda_ms(fn, 5), card))
    return rec, launches


def pilot_nonblocked_path(tx, card):
    """The path "pilot non-blocked": every other CPE pilot, the general frame body.

    The pilot cell's settings with ``cpe_pilot_rat=2`` over the capture's
    first 16 frames: B2's frame entry without the side output and B6 once
    each, under the BER gate, tracking bit-exact; B2 frames and B6 against
    their plain versions on this path's inputs and timed; the card's chain
    against the plain CPU chain on a small capture.
    """
    path, nf = "pilot non-blocked", PILOT_NB["frames"]
    pr, pi = tx.planes[:2], tx.planes[2:]
    cfg = dict(PILOT_CFG, cpe_pilot_rat=PILOT_NB["cpe_pilot_rat"], return_phase=False)
    chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, PILOT_FRAME, PILOT_RAT,
                                frames=range(nf), **cfg)
    require(not chain.kernel_interp and not chain.blocked, "the %s chain is blocked" % path)
    ((dr, di), info), launches = counted(lambda: chain.planes(pr, pi))
    print("%s launches: %s" % (path, launches))
    require(launches == expected({"B2 frames": 1, "B6": 1}),
            "the %s path did not launch each kernel as expected" % path)
    nd = tx.idx_tx.shape[-1]
    require(tuple(dr.shape) == (2, nf * nd) and bool(torch.isfinite(dr).all()
                                                     and torch.isfinite(di).all()),
            "%s payload of shape %s, or not finite" % (path, tuple(dr.shape)))
    gate = ber_gate(dr, di, tx, info["sync_corr"])
    print("%s: %d CPE pilots a row (every %d-th symbol), BER %.3e SER %.3e over 2 x %d x %d "
          "payload symbols, sync_corr %.1f" % (path, chain.ph_idx.numel(), chain.cpe_dx,
                                               gate["ber"], gate["ser"], nf, nd,
                                               gate["sync_corr"]))
    require(gate["ok"], "the %s BER gate failed (BER <= 1e-5 and sync_corr >= 120)" % path)
    trk = (info["taps"], info["shift"], info["mode_order"])
    (tr, ti), _ = chain.tracking_planes(pr, pi, *trk)
    exact = bool(torch.equal(tr, dr) and torch.equal(ti, di))
    print("%s tracking_planes == planes payload: %s" % (path, exact))
    require(exact, "the %s tracking output differs from the full chain" % path)

    st = pilot_stages(chain, pr, pi)
    d2 = frames_check(chain, st, path, nf)
    o, n, F_ = st["offs"], chain.nmodes, chain.frame_len
    fargs = (st["P"], chain.os, st["taps"], o, F_)
    plan = filter_plan(n, n, chain.Ntaps, chain.os, F_, nf)
    span = int(o.max() - o.min()) + chain.fr_len
    rec = {("B2 frames", path): dict(
        **bound(4 * 2 * n * span + nbytes(st["taps"], o, st["out"]),
                OPS_FILTER_TAP * n * chain.Ntaps * n * nf * F_),
        err=d2, ms=device_ms(lambda: apply_filter_frames_cuda(*fargs), 20),
        plain_ms=device_ms(lambda: apply_filter_frames_plain(*fargs), 3),
        shape="%d frames, no side output; %s" % (nf, plan_text(plan)))}
    rec["B2 frames", path]["library_ms"] = frames_library(*fargs[:4], chain.fr_len, st["out"])
    zr, zi = st["out"][0].reshape(-1, F_), st["out"][1].reshape(-1, F_)
    sargs = (zr, zi, plain_trace(chain, zr, zi), -1)
    r_p, i_p = rotate_plain(*sargs)
    r_k, i_k = rotate_cuda(*sargs)
    d6 = max(float((r_k - r_p).abs().max()), float((i_k - i_p).abs().max()))
    print("B6 rotate (%s): %s max|d| %.3e (tol %.0e)" % (path, tuple(r_k.shape), d6, TOL_ROTATE))
    require(d6 <= TOL_ROTATE, "B6 disagrees with its plain version on the %s path" % path)
    rec["B6", path] = dict(**bound(nbytes(zr, zi, sargs[2], r_k, i_k), OPS_ROTATE * zr.numel()),
                           err=d6, ms=device_ms(lambda: rotate_cuda(*sargs), 50),
                           plain_ms=device_ms(lambda: rotate_plain(*sargs), 10),
                           shape="%d rows" % zr.shape[0])
    npay = dr.numel()
    t_trk = cuda_ms(lambda: chain.tracking_planes(pr, pi, *trk), 10)
    print("time %s chain.tracking_planes (%d frames): %.4f ms, %.1f payload Msym/s [%s]"
          % (path, nf, t_trk, npay / t_trk / 1e3, card))
    print_times(rec, card)

    small_pilot_check(path, cfg, pr.device)
    return rec, launches


def pilot_foe_path(card, lat):
    """The path "pilot foe": a 20 MHz carrier offset, taken out by the LMS chain's pilot FOE.

    ``make_pilot_tx(20, freq_off=20e6)``, 16 frames, ``foe_comp=True``:
    counted (B1 3, B2 frames, B5, B4), under the BER gate, tracking with
    ``foe=info["foe_pil"]`` bit-exact, held to the plain CPU chain on the
    same capture (state, pilot FOE, decisions, the gate's outcome), and its
    kernels against their plain versions on its own inputs. The seeds are
    taken in order until one passes the gate: a capture whose frame sync
    fails (ROADMAP C5) must fail in the plain CPU chain too.
    """
    path, cfg = "pilot foe", PILOT_FOE
    kw = dict(PILOT_LMS_CFG, frames=range(cfg["frames"]), return_phase=False, foe_comp=True)
    fo_sym = cfg["freq_off"] / 24e9
    for seed in cfg["seeds"]:
        t0 = time.perf_counter()
        tx = make_pilot_tx(cfg["tx_frames"], frame_len=PILOT_FRAME, freq_off=cfg["freq_off"],
                           seed=seed)   # on the card
        chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, PILOT_FRAME, PILOT_RAT, **kw)
        pr, pi = tx.planes[:2], tx.planes[2:]
        ((dr, di), info), launches = counted(lambda: chain.planes(pr, pi))
        gate = ber_gate(dr, di, tx, info["sync_corr"])
        print("%s, seed %d: %d frames with a %.0f MHz offset (%.4e cycles per symbol), launches "
              "%s; pilot FOE %.6e, coarse + pilot %.6e; BER %.3e SER %.3e, sync_corr %.1f, shift "
              "%s (%.2f s with the capture)"
              % (path, seed, cfg["frames"], cfg["freq_off"] / 1e6, fo_sym, launches,
                 float(info["foe_pil"]), float(info["foe"]), gate["ber"], gate["ser"],
                 gate["sync_corr"], info["shift"].tolist(), time.perf_counter() - t0))
        require(launches == expected({"B1": 3, "B2 frames": 1, "B5": 1, "B4": 1}),
                "the %s path did not launch each kernel as expected" % path)
        t0 = time.perf_counter()
        cpu = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, PILOT_FRAME, PILOT_RAT, **kw,
                                  device="cpu")
        (cr, ci), cinfo = cpu.planes(pr.cpu(), pi.cpu())
        cgate = ber_gate(cr.to(dr.device), ci.to(dr.device), tx, cinfo["sync_corr"])
        same_state = all(cinfo[k].tolist() == info[k].tolist() for k in ("shift", "mode_order"))
        d_foe = abs(float(cinfo["foe_pil"]) - float(info["foe_pil"]))
        agree = float((decide(torch.complex(dr, di).cpu(), tx.coded)
                       == decide(torch.complex(cr, ci), tx.coded)).double().mean())
        print("%s, seed %d: plain CPU chain (%.2f s): shift/mode_order equal: %s, pilot FOE |d| "
              "%.3e (tol %.0e), decisions agree on %.6f (min %.3f), BER gate %s (card: %s)"
              % (path, seed, time.perf_counter() - t0, same_state, d_foe, TOL_FOE, agree,
                 LONG_AGREE, "held" if cgate["ok"] else "failed",
                 "held" if gate["ok"] else "failed"))
        require(same_state and d_foe <= TOL_FOE and agree >= LONG_AGREE
                and cgate["ok"] == gate["ok"],
                "the card's %s chain disagrees with the plain CPU chain (seed %d)" % (path, seed))
        del cpu, cr, ci
        if gate["ok"]:
            break
    require(gate["ok"], "the %s BER gate failed on every seed (BER <= 1e-5 and sync_corr >= "
            "120)" % path)
    trk = (info["taps"], info["shift"], info["mode_order"])
    (tr, ti), _ = chain.tracking_planes(pr, pi, *trk, foe=info["foe_pil"])
    exact = bool(torch.equal(tr, dr) and torch.equal(ti, di))
    print("%s tracking_planes(foe=info['foe_pil']) == planes payload: %s" % (path, exact))
    require(exact, "the %s tracking output differs from the full chain" % path)
    del tr, ti

    st = pilot_stages(chain, pr, pi)
    rec = {("B1", path): b1_batch_record(chain, st["segs"], path, card, lat)}
    ref = apply_filter_frames_plain(st["P"], chain.os, st["taps"], st["offs"], PILOT_FRAME)
    d_f = float((st["out"] - ref).abs().max())
    rms = float(ref.pow(2).mean().sqrt())
    del ref
    print("B2 frames (%s): %s max|d| %.3e against the plain version (tol %.0e x rms %.3f)"
          % (path, tuple(st["out"].shape), d_f, TOL_FILTER_REL, rms))
    require(d_f <= TOL_FILTER_REL * rms, "B2's frame entry disagrees on the %s path" % path)
    rec["B2 frames", path] = b2_frames_record(chain, st, st["offs"], path, d_f)
    rec["B5", path] = b5_record(chain, st, card, path)
    rec["B4", path] = b4_pilot_record(chain, st, path)
    npay = dr.numel()
    t_trk = cuda_ms(lambda: chain.tracking_planes(pr, pi, *trk, foe=info["foe_pil"]), 5)
    print("time %s chain.tracking_planes (%d frames, derotation included): %.4f ms, %.1f payload "
          "Msym/s [%s]" % (path, cfg["frames"], t_trk, npay / t_trk / 1e3, card))
    print_times(rec, card)
    return rec, launches


def pilot_granular_path(dev, card, lat):
    """The path "pilot granular": ``ops/pilots.py`` step by step on a small capture.

    ``frame_sync`` (B9 once a search window, B2 for each mode's segment),
    ``equalize_pilot_sequence`` (``backend="auto"``: B1 a stage, B2 for its
    first stage's output), the frames filtered with its taps (B2 a mode) and
    ``pilot_based_cpe``; counted, the payload under the BER gate (sync_corr
    standing for the search's own verdict), the search held to the plain
    CPU search; B9 and B1 against their plain versions at this path's shapes.
    """
    path, cfg = "pilot granular", PILOT_GRAN
    F_, seq_len, NT, nf = cfg["frame_len"], cfg["seq_len"], cfg["Ntaps"], cfg["frames"]
    tx = make_pilot_tx(cfg["tx_frames"], frame_len=F_, seq_len=seq_len, device=dev)
    E = torch.complex(tx.planes[:2], tx.planes[2:])
    _, idx_dat, idx_pil = cal_pilot_idx(F_, seq_len, PILOT_RAT)
    dat_idx = torch.as_tensor(np.nonzero(idx_dat)[0], device=dev)

    def receive():
        shift, foe, mo, _, ok = pilots.frame_sync(E, tx.pilot_seq, 2, frame_len=F_, device=dev)
        E2 = E[torch.as_tensor(mo, device=dev)]
        sh = pilots.correct_shifts(shift, (17, NT), 2)
        sh = np.where(sh < 0, sh + F_ * 2, sh)
        taps, _ = pilots.equalize_pilot_sequence(E2, tx.pilot_seq, sh, 2, Ntaps=NT)
        w = torch.as_tensor(taps, device=dev)
        sym = torch.cat([eqops.apply_filter(E2[:, sh[i]: sh[i] + nf * F_ * 2 + NT - 1], 2, w,
                                            modes=[i]) for i in range(2)])
        out, _ = pilots.pilot_based_cpe(sym, tx.ph_pilots, np.nonzero(idx_pil)[0][seq_len:], F_,
                                        num_average=3, nframes=nf)
        pay = out.reshape(2, nf, F_).index_select(-1, dat_idx).reshape(2, -1)
        return pay, shift, mo, ok, sh, w

    t0 = time.perf_counter()
    (pay, shift, mo, ok, sh, w), launches = counted(receive)
    t_call = time.perf_counter() - t0
    W = (F_ * 2) // seq_len + 1 - 2
    per_mode = len(set(sh.tolist())) > 1
    want = {"B9": W, "B1": 6 if per_mode else 3, "B2": 2 + (2 if per_mode else 1) + 2}
    gate = ber_gate(pay.real.contiguous(), pay.imag.contiguous(), tx,
                    pilots.FRAME_SYNC_THRS if ok else 0.0)
    print("%s: frame_sync -> equalize_pilot_sequence -> filter -> pilot_based_cpe on %d frames "
          "of SignalWithPilots(64, %d, %d, %d) statistics: launches %s (expected %s), shift %s, "
          "mode order %s, sync %s; BER %.3e SER %.3e (%.2f s host clock) [%s]"
          % (path, nf, F_, seq_len, PILOT_RAT, launches, want, shift.tolist(), mo.tolist(), ok,
             gate["ber"], gate["ser"], t_call, card))
    require(launches == expected(want), "the %s path did not launch each kernel as expected"
            % path)
    require(gate["ok"], "the %s BER gate failed" % path)

    # the search on the CPU: the plain per-symbol trainer in every window
    t0 = time.perf_counter()
    c = pilots.frame_sync(E.cpu(), tx.pilot_seq, 2, frame_len=F_, device="cpu")
    g = pilots.frame_sync(E, tx.pilot_seq, 2, frame_len=F_, device=dev)
    same = (np.array_equal(c[0], g[0]) and np.array_equal(c[2], g[2]) and c[4] == g[4]
            and np.array_equal(c[1], g[1]))
    d_w = float(np.abs(c[3] - g[3]).max())
    print("%s: frame_sync on the card vs the plain CPU search (%.2f s): shift, mode order, flag "
          "and coarse FOE equal: %s; taps max|d| %.3e (tol %.0e)"
          % (path, time.perf_counter() - t0, same, d_w, TOL_SEQ_TAPS))
    require(same and d_w <= TOL_SEQ_TAPS, "the card's frame_sync disagrees with the CPU's")

    # B9 in the search's first window; B1 in the pilot equaliser's first stage
    P = torch.cat([E.real, E.imag]).contiguous()
    sw = seq_len * 2
    trs = eqops._cal_training_symbol_len(2, 17, sw)
    w0 = torch.as_tensor(eqops._init_taps(17, 2, 2, np.complex64), device=dev)
    syms = eqops._reshape_symbols(None, "cma", 4, np.complex64, 2)
    win = P[:, 2 * (sw // 2): 2 * (sw // 2) + sw].contiguous()
    args = (win, trs, 1, 2, 1e-3, w0, syms, "cma", False)
    e_p, w_p, mu_p = train_seq_plain(*args)
    e_k, w_k, mu_k = train_seq_cuda(*args)
    d9 = float((w_k - w_p).abs().max())
    d9e = float((e_k - e_p).abs().max())
    print("B9 train_seq (%s, one window of %d symbols, cma): taps max|d| %.3e (tol %.0e), err "
          "max|d| %.3e (tol %.0e)" % (path, trs, d9, TOL_SEQ_TAPS, d9e, TOL_SEQ_ERR))
    require(d9 <= TOL_SEQ_TAPS and d9e <= TOL_SEQ_ERR, "B9 disagrees on the %s path" % path)
    rec = {("B9", path): dict(**trainer_bound(2, 2, 17, 2, trs, 1), err=d9,
                              ms=device_ms(lambda: train_seq_cuda(*args), 20),
                              plain_ms=device_ms(lambda: train_seq_plain(*args), 1),
                              shape="one of %d windows, %d symbols, 2 x 2 x 17 taps" % (W, trs))}
    print_chain("B9 train_seq (%s)" % path, lat, trs, seq_chain_cycles(lat, 34, "cma"),
                rec["B9", path]["ms"], card, "symbol")
    E2 = E[torch.as_tensor(mo, device=dev)]
    seg = eqops.planes(E2[:, sh[0]: sh[0] + seq_len * 2 + NT - 1]).contiguous()
    trs1 = eqops._cal_training_symbol_len(2, NT, seg.shape[-1])
    wq = torch.as_tensor(eqops._init_taps(NT, 2, 2, np.complex64), device=dev)
    spec = eqops.err_spec("cma", eqops._reshape_symbols(None, "cma", 4, np.complex64, 2))
    b1 = (seg, trs1, 30, 2, 1e-4, wq, spec, True, 128)
    e_p, w_p, mu_p = train_block_plain(*b1)
    e_k, w_k, mu_k = train_block_cuda(*b1)
    d1 = float((w_k - w_p).abs().max())
    d1e = float((e_k - e_p).abs().max())
    print("B1 train_block (%s, the pilot equaliser's first stage, 30 passes of %d blocks of 128): "
          "taps max|d| %.3e (tol %.0e), err max|d| %.3e (tol %.0e)"
          % (path, trs1 // 128, d1, TOL_TAPS, d1e, TOL_ERR))
    require(d1 <= TOL_TAPS and d1e <= TOL_ERR, "B1 disagrees on the %s path" % path)
    rec["B1", path] = dict(**trainer_bound(2, 2, NT, 2, (trs1 // 128) * 128, 30), err=d1,
                           ms=device_ms(lambda: train_block_cuda(*b1), 10),
                           plain_ms=device_ms(lambda: train_block_plain(*b1), 2),
                           shape="2 x 2 x %d taps, 30 x %d blocks of 128" % (NT, trs1 // 128))
    print_chain("B1 train_block (%s)" % path, lat, 30 * (trs1 // 128),
                block_chain_cycles(lat, 2 * NT, 128), rec["B1", path]["ms"], card, "block")
    Es = E2[:, sh[0]: sh[0] + nf * F_ * 2 + NT - 1]
    rec["B2", path], _ = b2_record(eqops.planes(Es).contiguous(), 2, w[:1], None, path,
                                   "%d frames of 2^14 symbols, one output mode" % nf)
    print_times(rec, card)
    return rec, launches


def phase_signal(kind, dev):
    """The capture of one phase sub-path, made by the port on the card: a signal object.

    ``SignalQAMGrayCoded(M, PHASE_NSYM, nmodes=2, fb=PHASE_FB, seed=PHASE_SEED)`` (the bits
    on the host, the symbols on the card), then ``core.impairments`` on the card's generator:
    the SNR, the laser phase noise, the carrier offset.
    """
    M, snr, lw, fo, _, _ = PHASE_SIGS[kind]
    sig = SignalQAMGrayCoded(M, PHASE_NSYM, nmodes=2, fb=PHASE_FB, seed=PHASE_SEED)
    gen = torch.Generator(device=dev).manual_seed(PHASE_SEED)
    x = core_impairments.change_snr(sig.samples, snr, sig.fb, sig.fs, gen)
    if lw is not None:
        x = core_impairments.apply_phase_noise(x, lw, sig.fs, gen)
    if fo is not None:
        x = core_impairments.add_carrier_offset(x, fo, sig.fs)
    return sig.replace(samples=x)


def gated_ser(rec, edges):
    """Per-mode SER of a recovered signal after ``edges`` symbols at each end, as a list."""
    return rec.replace(samples=helpers.dump_edges(rec.samples, edges)).cal_ser().tolist()


def driver_times(path, fn, card):
    """A driver's time per call (CUDA events, back to back) and its device busy share."""
    ms = cuda_ms(fn, 10)
    busy, nk, _ = device_busy(fn, 3)
    print("time %s: %.4f ms per call, %.1f Msym/s, device busy %.4f ms (%.1f%%, %.1f device "
          "ops per call) [%s]" % (path, ms, 2 * PHASE_NSYM / ms / 1e3, busy, 100 * busy / ms, nk,
                                  card))
    return ms


def b6_record(er, ei, ph, what):
    """B6 at full rate against its plain version, bit for bit."""
    r_p, i_p = rotate_plain(er, ei, ph, 1)
    r_k, i_k = rotate_cuda(er, ei, ph, 1)
    same = bool(torch.equal(r_k, r_p) and torch.equal(i_k, i_p))
    d = max(float((r_k - r_p).abs().max()), float((i_k - i_p).abs().max()))
    print("B6 rotate (%s): %s bit-equal to its plain version: %s (max|d| %.3e), |phase| up to "
          "%.2f rad" % (what, tuple(r_k.shape), same, d, float(ph.abs().max())))
    require(same, "B6 differs from its plain version (%s)" % what)
    return dict(**bound(nbytes(er, ei, ph, r_k, i_k), OPS_ROTATE * er.numel()), err=d,
                ms=device_ms(lambda: rotate_cuda(er, ei, ph, 1), 50),
                plain_ms=device_ms(lambda: rotate_plain(er, ei, ph, 1), 10),
                shape="2 x %d samples, full rate" % er.shape[-1])


def phase_search_path(path, rx, fn, want, card):
    """"phase bps" or "phase twostage": counted, checked for synchronising calls, gated, timed."""
    gate, edges = PHASE_SIGS["bps"][4:]
    (rec, ph), launches = counted(fn)
    syncs = syncs_in(fn)
    ser = gated_ser(rec, edges)
    print("%s: launches %s (expected %s), synchronising calls %d %s, SER per mode %s (gate %.0e "
          "after %d edge symbols), recovered %s, M %d, fb %.0f [%s]"
          % (path, launches, want, len(syncs), syncs[:3], ser, gate, edges,
             type(rec).__name__, rec.M, rec.fb, card))
    require(launches == expected(want), "the %s path did not launch each kernel as expected"
            % path)
    require(not syncs, "the %s driver synchronised the host: %s" % (path, syncs[:3]))
    require(all(x <= gate for x in ser), "the %s SER gate failed: %s" % (path, ser))
    require(isinstance(rec, SignalQAMGrayCoded) and rec.M == 64 and rec.fb == PHASE_FB,
            "the %s path lost the signal's attributes" % path)
    require(bool(torch.isfinite(ph).all()) and tuple(ph.shape) == (2, PHASE_NSYM),
            "the %s phase is not finite of shape (2, %d)" % (path, PHASE_NSYM))
    driver_times(path, fn, card)
    return launches, ph


def phase_phases(dev, card):
    """Phase 18: phase recovery on the port's signal objects (BASELINE config 3).

    Returns records keyed by (kernel, path) and each sub-path's launch counts.
    """
    t0 = time.perf_counter()
    rx = phase_signal("bps", dev)
    torch.cuda.synchronize()
    print("phase: SignalQAMGrayCoded(64, %d, nmodes=2, fb=%.0f, seed=%d) with 30 dB and a "
          "100 kHz linewidth built on the card in %.2f s (host clock)"
          % (PHASE_NSYM, PHASE_FB, PHASE_SEED, time.perf_counter() - t0))
    const = rx.coded_symbols_host
    grid = phops.search_grid(const)
    er, ei = rx.samples.real.contiguous(), rx.samples.imag.contiguous()
    rec, launches = {}, {}

    A, N = PHASE_BPS
    launches["phase bps"], ph = phase_search_path(
        "phase bps", rx, lambda: phaserec.bps(rx, A, N), {"B3": 1, "B6": 1}, card)
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in phops.bps_tables(ang, grid))
    rec["B3", "phase bps"], idx = b3_record(er, ei, cos_t, sin_t, grid, N, None, "phase bps")
    raw = -np.pi / 4 + (np.pi / 2 / A) * idx.to(torch.float32)
    raw[:, N:-N] = phops.unwrap(raw[:, N:-N] * 4) / 4
    d_ph = float((raw - ph).abs().max())
    print("phase bps: the driver's phase against B3's indices mapped and unwrapped by hand: "
          "max|d| %.3e" % d_ph)
    require(d_ph == 0.0, "the bps driver's phase differs from its steps")
    rec["B6", "phase bps"] = b6_record(er, ei, ph, "phase bps")
    t_unwrap = device_ms(lambda: phops.unwrap(ph * 4) / 4, 20)
    print("time plain unwrap (phase bps, device, 2 x %d samples): %.4f ms [%s]"
          % (PHASE_NSYM, t_unwrap, card))

    A, N, B = PHASE_TWOSTAGE
    launches["phase twostage"], ph2 = phase_search_path(
        "phase twostage", rx, lambda: phaserec.bps_twostage(rx, A, N, B=B),
        {"B3": 1, "B8": 1, "B6": 1}, card)
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos1, sin1 = (torch.as_tensor(t, device=dev) for t in phops.bps_tables(ang, grid))
    rec["B3", "phase twostage"], idx1 = b3_record(er, ei, cos1, sin1, grid, N, None,
                                                  "phase twostage")
    cd_h, sd_h, d0f, ddf = phops.fine_tables(A, B, grid)
    cd, sd = torch.as_tensor(cd_h, device=dev), torch.as_tensor(sd_h, device=dev)
    ph1 = -np.pi / 4 + (np.pi / 2 / A) * idx1.to(torch.float32)
    rec["B8", "phase twostage"], phf = b8_record(er, ei, ph1, cd, sd, grid, N, d0f, ddf, None,
                                                 "phase twostage")
    d_ph = float((phops.unwrap(phf * 4) / 4 - ph2).abs().max())
    print("phase twostage: the driver's phase against B3 and B8 unwrapped by hand: max|d| %.3e"
          % d_ph)
    require(d_ph == 0.0, "the bps_twostage driver's phase differs from its steps")
    rec["B6", "phase twostage"] = b6_record(er, ei, ph2, "phase twostage")
    t_unwrap = device_ms(lambda: phops.unwrap(ph2 * 4) / 4, 20)
    print("time plain unwrap (phase twostage, device, 2 x %d samples): %.4f ms [%s]"
          % (PHASE_NSYM, t_unwrap, card))
    del rx, er, ei

    # Viterbi-Viterbi after the blind FOE, on QPSK with a 50 MHz offset
    path = "phase vv"
    M, snr, lw, fo, gate, edges = PHASE_SIGS["vv"]
    q = phase_signal("vv", dev)

    def vv():
        est = phaserec.find_freq_offset(q, fft_size=VV_FFT)
        return phaserec.viterbiviterbi(phaserec.comp_freq_offset(q, est), VV_N), est
    ((rec_vv, _), est), launches[path] = counted(vv)
    est_hz = (est.cpu().numpy()[:, 0] * PHASE_FB).tolist()
    ser = gated_ser(rec_vv, edges)
    print("%s: QPSK, %d dB, %d Hz, offset %.0f Hz found as %s Hz (within %.0f Hz), VV N=%d: SER "
          "per mode %s (gate %.0e after %d), launches %s [%s]"
          % (path, snr, lw, fo, est_hz, 2 * PHASE_FB / VV_FFT, VV_N, ser, gate, edges,
             launches[path], card))
    require(all(abs(f - fo) < 2 * PHASE_FB / VV_FFT for f in est_hz),
            "the FOE missed the %.0f Hz offset: %s" % (fo, est_hz))
    require(all(x <= gate for x in ser), "the %s SER gate failed: %s" % (path, ser))
    require(launches[path] == expected({}), "the %s path launched a kernel" % path)
    driver_times(path, vv, card)
    del q

    # the 16-QAM partition
    path = "phase partition"
    M, snr, lw, fo, gate, edges = PHASE_SIGS["partition"]
    q = phase_signal("partition", dev)
    (rec_p, _), launches[path] = counted(lambda: phaserec.phase_partition_16qam(q, PART_BLOCK))
    ser = gated_ser(rec_p, edges)
    print("%s: 16-QAM, %d dB, %d Hz, Nblock %d: SER per mode %s (gate %.0e after %d), launches "
          "%s [%s]" % (path, snr, lw, PART_BLOCK, ser, gate, edges, launches[path], card))
    require(all(x <= gate for x in ser), "the %s SER gate failed: %s" % (path, ser))
    require(launches[path] == expected({}), "the %s path launched a kernel" % path)
    driver_times(path, lambda: phaserec.phase_partition_16qam(q, PART_BLOCK), card)
    del q

    # the metrics against theory: 16-QAM at 12 dB, noise only
    path = "phase metrics"
    M, snr = PHASE_SIGS["metrics"][:2]
    q = phase_signal("metrics", dev)

    def metrics():
        return (q.cal_ser(), q.est_snr(), q.cal_ber(), q.cal_evm(), q.cal_gmi()[0])
    (ser, snr_lin, ber, evm, gmi), launches[path] = counted(metrics)
    ser_th = float(theory.ser_vs_es_over_n0_qam(10 ** (snr / 10), M))
    snr_db = (10 * torch.log10(snr_lin)).tolist()
    print("%s: 16-QAM at %d dB: SER %s (theory %.4e, within %.0f%%), est_snr %s dB (within %.1f "
          "dB), BER %s, EVM %s, GMI %s bits, launches %s [%s]"
          % (path, snr, ser.tolist(), ser_th, 100 * METRIC_SER_REL, snr_db, METRIC_SNR_DB,
             ber.tolist(), evm.tolist(), gmi.tolist(), launches[path], card))
    require(all(abs(x - ser_th) / ser_th < METRIC_SER_REL for x in ser.tolist()),
            "cal_ser is not within %.0f%% of theory" % (100 * METRIC_SER_REL))
    require(all(abs(x - snr) < METRIC_SNR_DB for x in snr_db), "est_snr misses %d dB" % snr)
    require(launches[path] == expected({}), "the %s path launched a kernel" % path)
    driver_times(path, metrics, card)
    print_times(rec, card)
    return rec, launches


# ---------------------------------------------------------------------------
# phase 19: BASELINE configs 1, 4 and 5 on the port's own signal objects
# ---------------------------------------------------------------------------

class recording:
    """Keep the arguments of every call of the named launchers (``equaliser_cuda``, ``phase_cuda``).

    Each launcher is replaced by a recorder that appends (args, kwargs) to
    ``calls[name]`` and calls it: the launches are counted as before, on the
    launchers themselves. Restored on exit.
    """

    def __init__(self, *names):
        self.names, self.calls, self.saved = names, {n: [] for n in names}, {}

    class _Recorder:
        """A launcher that records its arguments; ``launches`` is the launcher's own count,
        which the launcher adds to through its module's name, now this object."""

        def __init__(self, fn, calls):
            self.fn, self.calls = fn, calls

        def __call__(self, *a, **k):
            self.calls.append((a, k))
            return self.fn(*a, **k)

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, value):
            self.fn.launches = value

    @staticmethod
    def _module(name):
        return eqcuda if hasattr(eqcuda, name) else phcuda

    def __enter__(self):
        for n in self.names:
            self.saved[n] = getattr(self._module(n), n)
            setattr(self._module(n), n, self._Recorder(self.saved[n], self.calls[n]))
        return self.calls

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self._module(n), n, fn)


def counted_syncs(fn):
    """``fn`` counted (:func:`counted`) under the sync debug mode: (result, counts, syncs)."""
    (res, syncs), launches = counted(lambda: with_syncs(fn))
    return res, launches, syncs


def base_b1_record(call, path, lat):
    """B1 at a path's first training over its whole length against the plain block trainer
    (taps within TOL_TAPS, step within TOL_SEQ_MU_REL, errors within TOL_ERR), timed there."""
    (P, trs, niter, os_, mu, wx, spec, adaptive, bs, points), _ = call
    full = (P, trs, niter, os_, mu, wx, spec, adaptive, bs)
    (e_p, w_p, mu_p), plain_ms = timed(lambda: train_block_plain(*full))
    e_k, w_k, mu_k = train_block_cuda(*full, points)
    d_t, d_e = float((w_k - w_p).abs().max()), float((e_k - e_p).abs().max())
    d_mu = float(((mu_k - mu_p) / mu_p).abs().max())
    nb = trs // bs
    print("B1 train_block (%s, %s, %d x %d blocks of %d, %d taps), every block against the plain "
          "trainer: taps max|d| %.3e (tol %.0e), mu rel %.3e (tol %.0e), err max|d| %.3e (tol %.0e)"
          % (path, spec.method, niter, nb, bs, wx.shape[-1], d_t, TOL_TAPS, d_mu, TOL_SEQ_MU_REL,
             d_e, TOL_ERR))
    require(d_t <= TOL_TAPS and d_mu <= TOL_SEQ_MU_REL and d_e <= TOL_ERR,
            "B1 disagrees on the %s path" % path)
    r = dict(**trainer_bound(wx.shape[1], wx.shape[0], wx.shape[-1], os_, nb * bs, niter),
             err=d_t, ms=device_ms(lambda: train_block_cuda(*full, points), 3), plain_ms=plain_ms,
             shape="%s, %d x %d blocks of %d, %d x %d x %d taps"
                   % (spec.method, niter, nb, bs, *wx.shape))
    print_chain("B1 train_block (%s)" % path, lat, niter * nb,
                block_chain_cycles(lat, wx.shape[1] * wx.shape[-1], bs), r["ms"], CARD[0],
                "block")
    return r


def base_b9_record(call, path, lat):
    """B9 in a path's first frame-search window against its plain version, timed there."""
    a, _ = call
    P, trs, niter, os_, mu, wx, syms, method, adaptive = a
    (e_p, w_p, _), plain_ms = timed(lambda: train_seq_plain(*a))
    e_k, w_k, _ = train_seq_cuda(*a)
    d_t, d_e = float((w_k - w_p).abs().max()), float((e_k - e_p).abs().max())
    print("B9 train_seq (%s, one search window: %d symbols x %d passes, %s): taps max|d| %.3e "
          "(tol %.0e), err max|d| %.3e (tol %.0e)"
          % (path, trs, niter, method, d_t, TOL_SEQ_TAPS, d_e, TOL_SEQ_ERR))
    require(d_t <= TOL_SEQ_TAPS and d_e <= TOL_SEQ_ERR, "B9 disagrees on the %s path" % path)
    r = dict(**trainer_bound(wx.shape[1], wx.shape[0], wx.shape[-1], os_, trs, niter), err=d_t,
             ms=device_ms(lambda: train_seq_cuda(*a), 10), plain_ms=plain_ms,
             shape="one search window, %d symbols x %d passes, %s" % (trs, niter, method))
    print_chain("B9 train_seq (%s)" % path, lat, trs * niter,
                seq_chain_cycles(lat, wx.shape[1] * wx.shape[-1], method), r["ms"],
                CARD[0], "symbol")
    return r


def base_frames_record(call, path):
    """B2's frame entry at a path's call: against its plain version, two launches bit-equal,
    timed beside its bound, the plain version and the grouped ``conv1d``."""
    (P, os_, wx, offs, F_, *rest), _ = call
    got = apply_filter_frames_cuda(P, os_, wx, offs, F_)
    again = apply_filter_frames_cuda(P, os_, wx, offs, F_)
    want = apply_filter_frames_plain(P, os_, wx, offs, F_)
    rms = float(want.pow(2).mean().sqrt())
    d = float((got - want).abs().max())
    nout, nmodes, ntaps = wx.shape
    nf = offs.shape[1]
    print("B2 frames (%s, %d output modes x %d frames of %d): max|d| %.3e (tol %.0e x rms %.3f), "
          "two launches bit-equal: %s" % (path, nout, nf, F_, d, TOL_FILTER_REL, rms,
                                         torch.equal(got, again)))
    require(d <= TOL_FILTER_REL * rms and torch.equal(got, again),
            "B2's frame entry disagrees on the %s path" % path)
    fr_len = (F_ - 1) * os_ + ntaps
    span = int(offs.max() - offs.min()) + fr_len
    fargs = (P, os_, wx, offs, F_)
    r = dict(**bound(4 * 2 * nmodes * span + nbytes(wx, offs, got),
                     OPS_FILTER_TAP * nmodes * ntaps * nout * nf * F_),
             err=d, ms=device_ms(lambda: apply_filter_frames_cuda(*fargs), 20),
             plain_ms=device_ms(lambda: apply_filter_frames_plain(*fargs), 3),
             shape="%d output modes x %d frames of %d, %d taps" % (nout, nf, F_, ntaps))
    r["library_ms"] = frames_library(P, os_, wx, offs, fr_len, got)
    return r


def base_records(calls, path, lat, what, frame=0, nframes=1):
    """The records of every kernel a path launched, at its first call of each in frame
    ``frame`` of the ``nframes`` whose calls ``calls`` holds (each frame makes as many)."""
    def first(name):
        c = calls.get(name, [])
        require(len(c) % nframes == 0, "the %s path's frames launch %s unevenly" % (path, name))
        return c[frame * len(c) // nframes] if c else None
    rec, b1, b9, b2, fr = {}, *map(first, BASE_LAUNCHERS)
    if b1:
        rec["B1", path] = base_b1_record(b1, path, lat)
    if b9:
        rec["B9", path] = base_b9_record(b9, path, lat)
    if b2:
        (P, os_, w, dec), _ = b2
        rec["B2", path], _ = b2_record(P, os_, w, dec, path, what)
    if fr:
        rec["B2 frames", path] = base_frames_record(fr, path)
    return rec


BASE_LAUNCHERS = ("train_block_cuda", "train_seq_cuda", "apply_filter_cuda",
                  "apply_filter_frames_cuda")


def stage(what, fn, card):
    """A stage's time for one call (CUDA events, the host's dispatch included), then its
    device busy time and ops over one more call (the profiler)."""
    _, ms = timed(fn)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print("time stage %s: %.4f ms, device busy %.4f ms in %d ops [%s]"
          % (what, ms, sum(e.time_range.elapsed_us() for e in dev) / 1e3, len(dev), card))
    return ms


def base_cma_capture(N, dev):
    """Config 1's capture on ``dev``: QPSK at 2 x N symbols, resampled to 2 fb, noise, PMD."""
    c = BASE_CMA
    sig = SignalQAMGrayCoded(4, N, nmodes=2, fb=c["fb"], seed=c["seed"], device=dev)
    sig = sig.resample(2 * c["fb"], beta=c["beta"])
    gen = torch.Generator(device=dev).manual_seed(c["seed"])
    sig = port_imp.change_snr(sig, c["snr"], generator=gen)
    return port_imp.apply_PMD(sig, *c["pmd"])


def base_cma_receive(sig, **kw):
    """Config 1's receiver: CMA with the adaptive step over the whole capture, normalised."""
    E, w, _ = equalisation.equalise_signal(sig, 1e-3, Ntaps=17, method="cma",
                                           adaptive_stepsize=True, apply=True, **kw)
    return helpers.normalise_and_center(E), w


def base_cma_path(dev, card, lat):
    """"baseline cma" (BASELINE config 1, examples/cma_equaliser.py) at 2 x 2^20 symbols."""
    path, c = "baseline cma", BASE_CMA
    t0 = time.perf_counter()
    sig = base_cma_capture(c["N"], dev)
    torch.cuda.synchronize()
    print("%s: SignalQAMGrayCoded(4, %d, nmodes=2, fb=%.0f) resampled to 2 fb (beta %.2f), %d dB, "
          "PMD pi/5.65 with %.0f ps DGD, built on the card in %.2f s (host clock); samples %s"
          % (path, c["N"], c["fb"], c["beta"], c["snr"], c["pmd"][1] * 1e12,
             time.perf_counter() - t0, sig.shape))
    with recording(*BASE_LAUNCHERS) as calls:
        (E, w), launches, syncs = counted_syncs(lambda: base_cma_receive(sig))
    ser, evm = E.cal_ser().tolist(), (20 * torch.log10(E.cal_evm())).tolist()
    print("%s: equalise_signal(sig, 1e-3, Ntaps=17, method='cma', adaptive_stepsize=True, "
          "apply=True): launches %s, synchronising calls %d %s; SER per mode %s (gate %.0e), "
          "EVM %s dB; out %s, fb %.0f, fs %.0f [%s]"
          % (path, launches, len(syncs), syncs[:2], ser, BASE_CMA_SER, evm, E.shape, E.fb, E.fs,
             card))
    require(launches == expected({"B1": 1, "B2": 1}), "the %s path did not launch B1 and B2 "
            "once each" % path)
    Lout = (2 * c["N"] - 17) // 2 + 1
    require(E.shape == (2, Lout) and bool(torch.isfinite(torch.view_as_real(E.samples)).all()),
            "the %s output is not finite of shape (2, %d)" % (path, Lout))
    require(all(x <= BASE_CMA_SER for x in ser), "the %s SER gate failed: %s" % (path, ser))
    src = SignalQAMGrayCoded(4, c["N"], nmodes=2, fb=c["fb"], seed=c["seed"], device=dev)
    stage("%s resample (2 x %d symbols to 2 fb)" % (path, c["N"]),
          lambda: src.resample(2 * c["fb"], beta=c["beta"]), card)
    stage("%s equalise_signal (B1 + B2)" % path, lambda: base_cma_receive(sig), card)
    t = cuda_ms(lambda: base_cma_receive(sig), 2)
    print("time %s: %.4f ms per call, %.1f Msym/s [%s]" % (path, t, 2 * c["N"] / t / 1e3, card))
    stage("%s metrics (cal_ser, cal_evm)" % path, lambda: (E.cal_ser(), E.cal_evm()), card)

    # the same recipe at a small size on the card, then its capture on the CPU through the
    # plain version of the card's route (the block trainer, blocks of 128)
    small = base_cma_capture(c["small_N"], dev)
    e_g, _ = base_cma_receive(small)
    e_c, _ = base_cma_receive(small.to("cpu"), backend="block", block_size=BASE_BLOCK)
    coded = torch.as_tensor(small.coded_symbols_host)
    agree = float((decision_idx(e_g.samples.cpu(), coded) == decision_idx(e_c.samples, coded))
                  .double().mean())
    sers = [e_g.cal_ser().tolist(), e_c.cal_ser().tolist()]
    print("%s, small capture (2 x %d symbols): card vs plain CPU run agree on %.6f of decisions "
          "(min %.3f); SER card %s, cpu %s" % (path, c["small_N"], agree, SMALL_AGREE, *sers))
    require(agree >= SMALL_AGREE and max(sers[0] + sers[1]) <= BASE_CMA_SER,
            "the card's %s run disagrees with the CPU's" % path)
    return base_records(calls, path, lat, "2 x %d samples in, no side output" % (2 * c["N"])), \
        launches


def base_pilot_capture(seed, nframes, dev):
    """Config 4's capture: SignalWithPilots at 2 fb through simulate_transmission."""
    c = BASE_PILOT
    sig = SignalWithPilots(64, c["frame_len"], c["seq_len"], c["ins"], nmodes=2, Mpilots=4,
                           nframes=nframes, fb=c["fb"], seed=seed, device=dev)
    sig = sig.resample(2 * c["fb"], beta=c["beta"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    return port_imp.simulate_transmission(sig, snr=c["snr"], dgd=c["dgd"],
                                          freq_off=c["freq_off"], lwdth=c["lwdth"],
                                          modal_delay=c["modal_delay"], generator=gen)


def base_tx_frame(seed, nframes, dev):
    """Config 5's frame: a 64-QAM payload framed with pilots (``from_symbol_array``)."""
    c = BASE_TX
    F_, P_, R_ = c["frame_len"], c["seq_len"], c["ins"]
    payload = SignalQAMGrayCoded(64, (F_ - P_) * (R_ - 1) // R_, nmodes=2, fb=c["fb"], seed=seed,
                                 device=dev)
    return SignalWithPilots.from_symbol_array(payload, F_, P_, R_, nframes=nframes)


def base_tx_capture(seed, nframes, dev):
    """Config 5's capture: a 64-QAM payload framed with pilots, resampled, rolled, then the
    DAC (6-bit ENOB, 16 GHz Bessel), the amplifier, the modulator and 35 dB of noise."""
    c = BASE_TX
    sig = base_tx_frame(seed, nframes, dev).resample(2 * c["fb"], beta=c["beta"],
                                                      renormalise=True)
    sig = sig.replace(samples=torch.roll(sig.samples, c["roll"], dims=-1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = core_impairments.sim_DAC_response(sig.samples, sig.fs, enob=c["enob"], generator=gen,
                                          cutoff=c["cutoff"])
    x = core_impairments.modulator_response(core_impairments.ideal_amplifier_response(
        x, c["volt"]))
    return port_imp.change_snr(sig.replace(samples=x), c["snr"], generator=gen)


def base_sync(cap, tx):
    """The pilot receiver's front: (config 5: resample, normalise), sync2frame, corr_foe."""
    rx = cap.replace()
    if tx:
        rx = rx.resample(2 * BASE_TX["fb"], beta=BASE_TX["beta"], renormalise=True)
        rx = helpers.normalise_and_center(rx)
    ok = rx.sync2frame()
    rx.corr_foe()
    return rx, ok


def base_equalise(rx, tx, **eqkw):
    """pilot_equaliser on frame 0 and the pilot CPE: (taps, recovered signal, its payload)."""
    taps, eq = equalisation.pilot_equaliser(rx, (1e-3, 1e-3), 45, foe_comp=False,
                                            methods=("cma", "sbd"), **eqkw)
    cpe, _ = phaserec.pilot_cpe(eq, N=5, use_seq=False) if tx else phaserec.pilot_cpe(eq, N=5)
    return taps, cpe, cpe.get_data()


def base_metrics(cpe, pay, tx):
    """(BER, GMI) per mode, as the example reads them."""
    sig = pay if tx else cpe
    return sig.cal_ber().tolist(), sig.cal_gmi()[0].tolist()


def base_pilot_path(path, dev, card, lat):
    """"baseline pilot" (config 4) or "baseline tx" (config 5) on 16 frames of 2^16 symbols.

    The first seed whose frame sync succeeds is gated (the sync fails on some captures in
    the reference too, ROADMAP C5); BER <= max(2 b, 1e-5) with b the JAX example's mean BER,
    GMI per mode >= the path's bound; the card's run held to the plain CPU run on a small
    capture of the same seed. "baseline pilot" also runs pilot_equaliser_nframes over frames
    0-14 (one pilot equalisation and one B2 frames launch a frame).
    """
    tx = path == "baseline tx"
    c = BASE_TX if tx else BASE_PILOT
    make = base_tx_capture if tx else base_pilot_capture
    ber_gate_, gmi_gate = max(2 * BASE_REF_BER[path], 1e-5), BASE_GMI[path]
    rec, launches_all = {}, {}
    for seed in c["seeds"]:
        t0 = time.perf_counter()
        cap = make(seed, c["nframes"], dev)
        torch.cuda.synchronize()
        print("%s: seed %d, %d frames built on the card in %.2f s (host clock); samples %s"
              % (path, seed, c["nframes"], time.perf_counter() - t0, cap.shape))

        def receive():
            rx, ok = base_sync(cap, tx)
            return (rx, ok) + base_equalise(rx, tx)
        with recording(*BASE_LAUNCHERS) as calls:
            (rx, ok, taps, cpe, pay), launches, syncs = counted_syncs(receive)
        ber, gmi = base_metrics(cpe, pay, tx)
        print("%s: seed %d: sync %s, shifts %s; launches %s (synchronising calls %d %s); BER per "
              "mode %s (gate %.3e), GMI %s bits (gate %.4f) [%s]"
              % (path, seed, ok, np.asarray(rx.shiftfctrs).tolist(), launches, len(syncs),
                 syncs[:2], ber, ber_gate_, gmi, gmi_gate, card))
        if ok:
            break
    require(ok, "no seed of %s synced the %s capture" % (c["seeds"], path))
    require(launches["B2 frames"] == 1 and all(launches[k] for k in ("B9", "B1", "B2")),
            "the %s path did not launch B9, B1, B2 and B2 frames (once) as expected: %s"
            % (path, launches))
    require(all(b <= ber_gate_ for b in ber) and all(g >= gmi_gate for g in gmi),
            "the %s gates failed: BER %s, GMI %s" % (path, ber, gmi))
    require(bool(torch.isfinite(torch.view_as_real(cpe.samples)).all())
            and cpe.shape == (2, c["frame_len"]),
            "the %s output is not finite of one frame" % path)
    launches_all[path] = launches
    rec.update(base_records(calls, path, lat, "the pilot sequence's segment"))

    # stage times
    if tx:
        base_dac_times(cap, card)
        frame = base_tx_frame(seed, c["nframes"], dev)
        stage("%s resample (%d frames to 2 fb, renormalised)" % (path, c["nframes"]),
              lambda: frame.resample(2 * c["fb"], beta=c["beta"], renormalise=True), card)
    else:
        frame = SignalWithPilots(64, c["frame_len"], c["seq_len"], c["ins"], nmodes=2, Mpilots=4,
                                 nframes=c["nframes"], fb=c["fb"], seed=seed, device=dev)
        stage("%s resample (%d frames to 2 fb)" % (path, c["nframes"]),
              lambda: frame.resample(2 * c["fb"], beta=c["beta"]), card)
    stage("%s sync2frame + corr_foe" % path, lambda: base_sync(cap, tx), card)
    stage("%s pilot_equaliser + pilot_cpe" % path, lambda: base_equalise(rx, tx), card)
    stage("%s metrics (cal_ber, cal_gmi)" % path, lambda: base_metrics(cpe, pay, tx), card)

    # the card's run against the plain CPU run on a small capture of the same seed: the
    # receiver after the card's frame sync (whose search the granular path holds to the CPU)
    small = make(seed, c["small_frames"], dev)
    srx, sok = base_sync(small, tx)
    _, g_cpe, g_pay = base_equalise(srx, tx)
    _, c_cpe, c_pay = base_equalise(srx.to("cpu"), tx, backend="block", block_size=BASE_BLOCK)
    a, b = ((g_pay, c_pay) if tx else (g_cpe.get_data(), c_cpe.get_data()))
    coded = torch.as_tensor(a.coded_symbols_host)
    agree = float((decision_idx(a.samples.cpu(), coded) == decision_idx(b.samples, coded))
                  .double().mean())
    m_g, m_c = base_metrics(g_cpe, g_pay, tx), base_metrics(c_cpe, c_pay, tx)
    print("%s, small capture (%d frames, seed %d, sync %s): card vs plain CPU receiver agree on "
          "%.6f of payload decisions (min %.3f); BER card %s, cpu %s; GMI card %s, cpu %s"
          % (path, c["small_frames"], seed, sok, agree, SMALL_AGREE, m_g[0], m_c[0], m_g[1],
             m_c[1]))
    require(sok and agree >= SMALL_AGREE
            and max(m_g[0] + m_c[0]) <= ber_gate_ and min(m_g[1] + m_c[1]) >= gmi_gate,
            "the card's %s run disagrees with the CPU's" % path)

    if not tx:
        p2 = path + " nframes"
        nf = c["nframes_eq"]

        def nframes_run():
            taps_n, sout, _ = equalisation.pilot_equaliser_nframes(
                rx, (1e-3, 1e-3), 45, foe_comp=False, frames=range(nf), methods=("cma", "sbd"))
            out, _ = phaserec.pilot_cpe(sout, N=5, nframes=nf)
            return out
        t0 = time.perf_counter()
        with recording(*BASE_LAUNCHERS) as calls_n:
            out, launches, _ = counted_syncs(nframes_run)
        t_n = time.perf_counter() - t0
        ber_n, gmi_n = out.cal_ber().tolist(), out.cal_gmi()[0].tolist()
        print("%s: pilot_equaliser_nframes over frames 0-%d: launches %s (B2 frames %d, one a "
              "frame); BER per mode %s (gate %.3e), GMI %s [%s]"
              % (p2, nf - 1, launches, launches["B2 frames"], ber_n, ber_gate_, gmi_n, card))
        require(launches["B2 frames"] == nf and launches["B1"] >= nf,
                "pilot_equaliser_nframes did not launch B2's frame entry once a frame")
        require(all(b <= ber_gate_ for b in ber_n) and all(g >= gmi_gate for g in gmi_n),
                "the %s gates failed: BER %s, GMI %s" % (p2, ber_n, gmi_n))
        print("time stage %s (%d frames, the counted call, host clock): %.1f ms [%s]"
              % (p2, nf, 1e3 * t_n, card))
        launches_all[p2] = launches
        # the kernels at frame 1's calls: its training starts from frame 0's taps
        for k, r in base_records(calls_n, p2, lat, "the pilot sequence's segment", frame=1,
                                 nframes=nf).items():
            rec[k] = dict(r, shape=r["shape"] + "; frame 1 of %d, from frame 0's taps" % nf)
    return rec, launches_all


def base_dac_times(cap, card):
    """The DAC's Bessel IIR on the capture: time beside two byte bounds (the function's input
    and output once; each doubling pass reading and writing its (N, 2, columns) states)."""
    c = BASE_TX
    x = cap.samples
    fs = cap.fs
    ms = device_ms(lambda: core_impairments.apply_DAC_filter(x, fs, cutoff=c["cutoff"]), 5)
    sos = scisig.bessel(2, c["cutoff"], 'low', norm='mag', analog=False, output='sos', fs=fs)
    b0, b1, b2, _, a1, a2 = sos[0]
    N, cols = x.shape[-1], 2 * x.shape[0]
    passes = len(prefix_powers(np.array([[-a1, 1.0], [-a2, 0.0]]), N, torch.float32))
    full = int(np.ceil(np.log2(N)))
    b_fn = 2 * nbytes(x) / HBM_BYTES_PER_S * 1e3
    b_pass = 2 * N * 2 * cols * 4 / HBM_BYTES_PER_S * 1e3
    print("time stage baseline tx DAC IIR (2nd-order Bessel at %.0f GHz on %s complex64): %.4f ms "
          "device; %d doubling passes run (ceil(log2 N) = %d; later powers round to 0 in "
          "float32); byte bound %.5f ms for the function, %.5f ms for %d passes over (N, 2, %d), "
          "%.5f ms for %d [%s]" % (c["cutoff"] / 1e9, tuple(x.shape), ms, passes, full, b_fn,
                                   passes * b_pass, passes, cols, full * b_pass, full, card))


def baseline_phases(dev, card, lat):
    """Phase 19: BASELINE configs 1, 4 and 5 on the port's own signal objects."""
    rec, launches = {}, {}
    r, launches["baseline cma"] = base_cma_path(dev, card, lat)
    rec.update(r)
    for path in ("baseline pilot", "baseline tx"):
        r, lc = base_pilot_path(path, dev, card, lat)
        rec.update(r)
        launches.update(lc)
    print_times(rec, card)
    return rec, launches


# ---------------------------------------------------------------------------
# phase 20: the multi-device receivers (parallel/) on torch.distributed
# ---------------------------------------------------------------------------

def free_port():
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def args_b4_record(args, what):
    """B4 against its plain version on the arguments (er, ei, a, b, dx, sign) of a call."""
    r_p, i_p = interp_rotate_plain(*args)
    r_k, i_k = interp_rotate_cuda(*args)
    d_r = max(float((r_k - r_p).abs().max()), float((i_k - i_p).abs().max()))
    er, ei, a, b, dx, _ = args
    print("B4 interp_rotate (%s): %s, stride %d, max|d| %.3e (tol %.0e), |phase| up to %.2f rad"
          % (what, tuple(r_k.shape), dx, d_r, TOL_ROTATE, float(a.abs().max())))
    require(d_r <= TOL_ROTATE, "B4 disagrees with its plain version (%s)" % what)
    return dict(**bound(nbytes(er, ei, a, b, r_k, i_k), (OPS_INTERP + OPS_ROTATE) * er.numel()),
                err=d_r, ms=device_ms(lambda: interp_rotate_cuda(*args), 50),
                plain_ms=device_ms(lambda: interp_rotate_plain(*args), 10),
                shape="%d x %d, stride %d" % (*er.shape, dx))


def args_b5_record(args, what):
    """B5 against its plain version on a recorded call's arguments (from contiguous pilot rows,
    the chain's form, or strided from a filter output: the known pilots give the count)."""
    a_p, b_p = cpe_coeffs_plain(*args)
    a_k, b_k = cpe_coeffs_cuda(*args)
    d_a, d_b = float((a_k - a_p).abs().max()), float((b_k - b_p).abs().max())
    rows, npil = args[0].shape[0], args[2].shape[1]
    print("B5 cpe_coeffs (%s): %d rows x %d pilots, max|da| %.3e (tol %.0e), max|db| %.3e "
          "(tol %.0e)" % (what, rows, npil, d_a, TOL_CPE_A, d_b, TOL_CPE_B))
    require(d_a <= TOL_CPE_A and d_b <= TOL_CPE_B, "B5 disagrees with its plain version (%s)"
            % what)
    rest = nbytes(args[2], args[3], a_k, b_k)
    return dict(**bound(2 * 4 * rows * npil + rest, OPS_CPE_PILOT * rows * npil),
                err=max(d_a, d_b), ms=device_ms(lambda: cpe_coeffs_cuda(*args), 50),
                plain_ms=device_ms(lambda: cpe_coeffs_plain(*args), 10),
                shape="%d rows x %d pilots" % (rows, npil))


def shard_records(calls, path, lat, timing):
    """Each kernel a sharded path launched, at its first call on this rank, against its plain
    version (fatal if it disagrees); timed only where ``timing`` (one rank at a time)."""
    rec = {}
    for name, call in ((n, c[0]) for n, c in calls.items() if c):
        a = call[0]
        if name == "train_block_cuda":
            r = base_b1_record(call, path, lat)
        elif name == "apply_filter_cuda":
            P, os_, w, dec = (a + (None,))[:4]
            r, _ = b2_record(P, os_, w, dec, path, "shard %s" % (tuple(P.shape),))
        elif name == "bps_search_cuda":
            r, _ = b3_record(*a[:6], a[6] if len(a) > 6 else None, path, (20, 3))
        elif name == "interp_rotate_cuda":
            r = args_b4_record(a, path)
        elif name == "rotate_cuda":
            r = b6_record(a[0], a[1], a[2], path)
        elif name == "apply_filter_frames_cuda":
            r = base_frames_record(call, path)
        else:
            r = args_b5_record(a, path)
        rec[SHARD_LAUNCHERS[name], path] = r
    if not timing:
        for r in rec.values():
            for key in ("ms", "plain_ms", "library_ms", "ms_without_side"):
                r.pop(key, None)
    return rec


def shard_records_in_turn(mesh, calls, path, lat, timing):
    """:func:`shard_records` on every rank, the timing rank last and alone on the card."""
    rec = {} if timing else shard_records(calls, path, lat, False)
    mesh.barrier()
    if timing:
        rec = shard_records(calls, path, lat, True)
    mesh.barrier()
    return rec


#: the launchers a sharded path's records are taken from, and their kernels
SHARD_LAUNCHERS = {"train_block_cuda": "B1", "apply_filter_cuda": "B2",
                   "bps_search_cuda": "B3", "interp_rotate_cuda": "B4", "rotate_cuda": "B6",
                   "apply_filter_frames_cuda": "B2 frames", "cpe_coeffs_cuda": "B5"}


def mode_sers(out, ref, const):
    """Per-mode SER of a gathered output under the bench's gate (its 200-symbol trim)."""
    return [ser_gate(out[m:m + 1], ref, const) for m in range(out.shape[0])]


def interior_sers(out, ref, const, size):
    """Per-mode SER of the shards' interiors: ``SHARD_EDGE`` symbols off each shard boundary."""
    edge, L = SHARD_EDGE, out.shape[-1] // size
    errs = []
    for m in range(out.shape[0]):
        s = [ser_gate(out[m:m + 1, d * L + edge - GATE_TRIM:(d + 1) * L - edge + GATE_TRIM],
                      ref[:, d * L + edge - GATE_TRIM:(d + 1) * L - edge + GATE_TRIM], const)
             for d in range(size)]
        errs.append(float(np.mean(s)))
    return errs


def sharded_blind(path, mesh, cfg, E, ref, const, lat, timing, w_track=None):
    """One sharded blind chain on this rank: counted, gathered and gated, its collectives
    counted and timed, its kernels held to their plain versions; with ``w_track``, its tracking
    entry with those taps gathered and gated too. Returns (launches, records, summary)."""
    chain = sharded.make_sharded_rx_chain(mesh, **cfg)
    E_loc = sharded.shard_signal(E, mesh)
    with recording(*SHARD_LAUNCHERS) as calls:
        (Eout, ph, evm), launches = counted(lambda: chain(E_loc))
    rounds = cfg["rounds"]
    want = {"B1": 2 * rounds, "B2": 1, "B3": 1,
            "B4" if cfg["bps_mode"].startswith("decimated") else "B6": 1}
    require(launches == expected(want), "%s launches %s on rank %d" % (path, launches, mesh.rank))
    out = torch.as_tensor(sharded.fetch_global(Eout, mesh), device=ref.device)
    require(bool(torch.isfinite(out.real).all() and torch.isfinite(out.imag).all()),
            "non-finite %s output" % path)
    sers = mode_sers(out, ref, const)
    offs = chain.offsets.cpu().tolist()
    gain = out[:, GATE_TRIM:-GATE_TRIM].abs().pow(2).mean(dim=-1).sqrt().tolist()
    track = None
    if w_track is not None:
        trk = torch.as_tensor(sharded.fetch_global(chain.tracking(E_loc, w_track)[0], mesh),
                              device=ref.device)
        track = mode_sers(trk, ref, const)
    torch.cuda.synchronize()
    mesh.barrier()
    h0 = time.perf_counter()
    for _ in range(SHARD_CALLS):
        chain(E_loc)
    torch.cuda.synchronize()
    mesh.barrier()
    call_ms = (time.perf_counter() - h0) / SHARD_CALLS * 1e3
    mesh.reset_stats()
    mesh.timed = True
    chain(E_loc)
    mesh.timed = False
    stats = dict(mesh.stats)
    rec = shard_records_in_turn(mesh, calls, path, lat, timing)
    return launches, rec, dict(path=path, sers=sers, evm=float(evm), offsets=offs, rms=gain,
                               track=track, call_ms=call_ms, stats=stats,
                               shard=list(E_loc.shape), out=list(Eout.shape))


def sharded_sweep(mesh):
    """The 4-rank decimated16 chain at shorter shards: SER per mode over the whole capture
    and over the shards' interiors (to tell training length from the boundaries)."""
    res = []
    for n in SHARD_SWEEP:
        E, syms, const = make_tx(mesh.size * n, seed=1)
        ref = torch.as_tensor(syms, device=mesh.device)
        cfg = dict(SHARD_GLOO, TrSyms_loc=min(SHARD_GLOO["TrSyms_loc"], (2 * n - 17) // 2))
        chain = sharded.make_sharded_rx_chain(mesh, **cfg)
        out = torch.as_tensor(sharded.fetch_global(chain(sharded.shard_signal(E, mesh))[0],
                                                   mesh), device=mesh.device)
        res.append(dict(nsym=n, TrSyms_loc=cfg["TrSyms_loc"], sers=mode_sers(out, ref, const),
                        interior=interior_sers(out, ref, const, mesh.size)))
    return res


def sharded_pilot(mesh, lat, timing):
    """"sharded pilot gloo4": frames_per_device=60 over the pilot cell's capture, with the
    prefix replicated and spread over the ranks. Returns (launches, records, summary)."""
    tx = make_pilot_tx(PILOT_TX_FRAMES)
    sums = mesh.all_gather(tx.planes.double().sum(dim=-1))
    require(bool((sums == sums[0]).all()), "the ranks made different pilot captures")
    E = torch.complex(tx.planes[:2], tx.planes[2:])
    k = SHARD_PILOT_K
    nd = tx.idx_tx.shape[-1]
    cfg = dict(PILOT_CFG, return_phase=False)
    single = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, PILOT_FRAME, PILOT_RAT,
                                 frames=tuple(range(mesh.size * k)), **cfg)
    (sdr, sdi), sinfo = single.planes(tx.planes[:2], tx.planes[2:])
    mine = slice(mesh.rank * k * nd, (mesh.rank + 1) * k * nd)
    launches, rec, summ = {}, {}, {}
    for sp in (False, True):
        path = "sharded pilot gloo4" + (" shard_prefix" if sp else "")
        rx = sharded.make_sharded_pilot_rx(mesh, tx.pilot_seq, tx.ph_pilots, PILOT_FRAME,
                                           PILOT_RAT, k, shard_prefix=sp, **cfg)
        with recording(*SHARD_LAUNCHERS) as calls:
            (data, shift, sc), launches[path] = counted(lambda: rx(E))
        require(launches[path] == expected({"B2 frames": 1, "B5": 1, "B4": 1}),
                "%s launches %s on rank %d" % (path, launches[path], mesh.rank))
        dr, di = data.real.contiguous(), data.imag.contiguous()
        g = ber_gate(dr, di, tx, sc)
        nbits = 2 * k * nd * tx.bits.shape[1]
        errs = mesh.sum(torch.tensor([round(g["ber"] * nbits)], dtype=torch.float64,
                                     device=mesh.device))
        ber = float(errs[0]) / (nbits * mesh.size)
        s = dict(path=path, shift=shift.tolist(), sync_corr=float(sc), ber=ber,
                 ber_rank=g["ber"])
        taps, shift_p, mo, sc_p = rx.prefix(E)
        s["mode_order"] = mo.tolist()
        if sp:
            d_taps = float((taps - sinfo["taps"]).abs().max())
            scale = float(sinfo["taps"].abs().max())
            s.update(taps_dev=d_taps, taps_scale=scale,
                     same_state=bool(torch.equal(shift, sinfo["shift"])
                                     and torch.equal(mo, sinfo["mode_order"])),
                     agree=shared_decisions(torch.complex(sdr[:, mine], sdi[:, mine]), data,
                                            tx.coded))
        else:
            s["bit_equal"] = bool(torch.equal(dr, sdr[:, mine]) and torch.equal(di, sdi[:, mine]))
            s["payload_dev"] = max(float((dr - sdr[:, mine]).abs().max()),
                                   float((di - sdi[:, mine]).abs().max()))
        summ[path] = s
        rec.update(shard_records_in_turn(mesh, calls, path, lat, timing))
    return launches, rec, summ


def shard_worker(rank, size, addr, lat_path, out_path):
    """One rank of phase 20's gloo paths: four processes on the one card, a gloo group with
    CUDA tensors. Writes its launch counts, records and summaries as JSON to ``out_path``."""
    with open(lat_path) as f:
        lat = json.load(f)
    CARD.append(card_line())
    init_distributed(addr, size, rank, backend="gloo")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh = make_mesh()
        E, syms, const = make_tx(NSYM)
        ref = torch.as_tensor(syms, device=mesh.device)
        # the single-card chain's taps (its trainings on the capture's first 2^14 symbols), with
        # which the ranks' tracking entries demodulate: the shards' exchanges held apart from
        # the data-parallel trainings
        P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32),
                            device=mesh.device)
        w_rx = make_rx_chain(**CFG).train_taps(P)
        del P
        launches, rec, summ = {}, {}, {}
        for path, cfg in (("sharded blind gloo4", SHARD_GLOO),
                          ("sharded blind gloo4 single", SHARD_SINGLE)):
            launches[path], r, summ[path] = sharded_blind(path, mesh, cfg, E, ref, const, lat,
                                                          rank == 0, w_rx)
            rec.update(r)
        summ["sweep"] = sharded_sweep(mesh)
        pl, pr, ps = sharded_pilot(mesh, lat, rank == 0)
        launches.update(pl)
        rec.update(pr)
        summ.update(ps)
        res = dict(rank=rank, launches=launches, summary=summ,
                   records=[[k, p, v] for (k, p), v in rec.items()])
        with open(out_path, "w") as f:
            json.dump(res, f)
        mesh.barrier()
    finally:
        torch.distributed.destroy_process_group()
    return 0


def run_shard_workers(lat, card):
    """Start the four ranks of phase 20's gloo paths and wait for them; the first that fails
    stops the others. Returns each rank's JSON."""
    tmp = tempfile.mkdtemp(prefix="shard_")
    lat_path = os.path.join(tmp, "lat.json")
    with open(lat_path, "w") as f:
        json.dump(lat, f)
    addr = "localhost:%d" % free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    outs = [os.path.join(tmp, "rank%d.json" % r) for r in range(SHARD_RANKS)]
    logs = [open(os.path.join(tmp, "rank%d.log" % r), "w+") for r in range(SHARD_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--shard-rank", str(r),
                               str(SHARD_RANKS), addr, lat_path, outs[r]],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(SHARD_RANKS)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            require(time.perf_counter() - t0 < SHARD_TIMEOUT, "phase 20's ranks timed out")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if r == 0 or p.returncode:
            print("---- rank %d of %d (rc %s) ----\n%s" % (r, SHARD_RANKS, p.returncode,
                                                         text[-20000:]))
    require(all(p.returncode == 0 for p in procs), "a rank of phase 20 failed")
    print("phase 20 ranks: %.1f s from spawn to the last exit [%s]"
          % (time.perf_counter() - t0, card))
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def sharded_nccl1(E, syms, const, lat, card):
    """"sharded blind nccl1": one rank in an NCCL group of world size 1, in this process."""
    init_distributed("localhost:%d" % free_port(), 1, 0)
    try:
        mesh = make_mesh()
        path = "sharded blind nccl1"
        ref = torch.as_tensor(syms, device=mesh.device)
        launches, rec, s = sharded_blind(path, mesh, SHARD_CFG, E, ref, const, lat, True)
        print("%s: SER per mode %s (gate %.0e), EVM %.4f, unwrap offsets %s [%s]"
              % (path, s["sers"], SER_LIMIT, s["evm"], s["offsets"], card))
        require(max(s["sers"]) <= SER_LIMIT, "%s SER gate failed" % path)
        # held against RxChain: the same taps where the CMA guard does not fire, the same
        # outputs off the circular edges and off near-ties of the search
        dev = mesh.device
        P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
        rx = make_rx_chain(**CFG)
        (rr, ri), w_rx = rx.planes_with_taps(P)
        chain = sharded.make_sharded_rx_chain(mesh, **SHARD_CFG)
        w_sh = chain.train_taps(P)
        w1 = train_block_cuda(P, CFG["TrSyms"], 1, CFG["os"], CFG["mu"], rx.w0, rx.specs[0],
                              True, CFG["block_size"])[1]
        fired = not torch.equal(cma_singularity_guard(w1), w1)
        (sr, si), _ = chain.demod(P, w_sh)
        Lout = rr.shape[-1]
        edge = CFG["bps_N"] * 16 + GATE_TRIM
        a = torch.complex(rr, ri)[:, edge:Lout - edge]
        b = torch.complex(sr, si)[:, edge:Lout - edge]
        agree = shared_decisions(a, b, const)
        d_out = float((a - b).abs().max())
        d_taps = float((w_sh - w_rx).abs().max())
        print("%s against RxChain on the same capture: CMA guard fired %s, taps bit-equal %s, "
              "max|d| %.3e (tol %.0e: the phase alignment to rank 0 turns by inner/|inner|, 1 "
              "to rounding); outputs over [%d, %d): decisions shared %.6f (min %.4f), max|d| "
              "%.3e [%s]" % (path, fired, bool(torch.equal(w_sh, w_rx)), d_taps, TOL_NCCL1_TAPS,
                             edge, Lout - edge, agree, NCCL1_AGREE, d_out, card))
        require(fired or d_taps <= TOL_NCCL1_TAPS, "%s trains other taps than RxChain" % path)
        require(agree >= NCCL1_AGREE, "%s disagrees with RxChain" % path)
        E_loc = sharded.shard_signal(E, mesh)
        t_chain = cuda_ms(lambda: chain(E_loc), 10)
        coll = 1e3 * s["stats"]["seconds"]
        (er, ei), _ = chain.demod(P, w_sh)
        for what, fn in (("call", lambda: chain(E_loc)), ("train_taps", lambda: chain.train_taps(P)),
                         ("demod", lambda: chain.demod(P, w_sh)), ("evm", lambda: chain.evm(er, ei))):
            busy, nops, _ = device_busy(fn, 3)
            print("time %s stage %s: device busy %.4f ms in %.1f device ops a call [%s]"
                  % (path, what, busy, nops, card))
        print("time %s: %.4f ms a call by CUDA events (host clock %.4f ms), %.1f Msym/s; "
              "collectives %d calls, %d bytes, %.4f ms between synchronisations, %.1f%% of the "
              "call [%s]" % (path, t_chain, s["call_ms"], 2 * NSYM / t_chain / 1e3,
                             s["stats"]["calls"], s["stats"]["bytes"], coll,
                             100 * coll / t_chain, card))
        print_times({k: v for k, v in rec.items() if "ms" in v}, card)
    finally:
        torch.distributed.destroy_process_group()
    return {path: launches}, rec


def sharded_phase(E, syms, const, lat, card):
    """Phase 20: "sharded blind nccl1" here, then the gloo paths in four ranks."""
    path_launches, rec = sharded_nccl1(E, syms, const, lat, card)
    # the four ranks share the card with this process: hand back what its allocator keeps
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 20: this process holds %.2f GB allocated, %.2f GB reserved on the card before "
          "the ranks start [%s]" % (torch.cuda.memory_allocated() / 1e9,
                                    torch.cuda.memory_reserved() / 1e9, card))
    ranks = run_shard_workers(lat, card)
    r0 = ranks[0]
    for r in ranks:
        require(r["launches"] == r0["launches"], "the ranks launched differently: %s, %s"
                % (r0["launches"], r["launches"]))
    path_launches.update(r0["launches"])
    per_rank = [{(k, p): v for k, p, v in r["records"]} for r in ranks]
    for key, v in per_rank[0].items():
        rec[key] = dict(v, err=max(pr[key]["err"] for pr in per_rank))
    print_times({k: v for k, v in rec.items() if k[1] != "sharded blind nccl1"}, card)
    print("(the gloo paths' times: four ranks share the one card's SMs; none is a scaling "
          "figure) [%s]" % card)
    for path in ("sharded blind gloo4", "sharded blind gloo4 single"):
        s = r0["summary"][path]
        print("%s: shard %s -> %s, SER per mode %s (gate %.0e), EVM %.4f, call %.4f ms host "
              "clock; unwrap offsets per rank %s; collectives per call %d, %d bytes a rank, "
              "%d through host memory, %.4f ms between synchronisations [%s]"
              % (path, s["shard"], s["out"], s["sers"], SHARD_SER_GLOO, s["evm"], s["call_ms"],
                 s["offsets"], s["stats"]["calls"], s["stats"]["bytes"],
                 s["stats"]["host_bytes"], 1e3 * s["stats"]["seconds"], card))
        for gate in (SHARD_SER_GLOO, SHARD_SER_REF):
            print("%s, the data-parallel trainings: the gate SER <= %.0e per mode %s; output rms "
                  "per mode %s [%s]" % (path, gate, "holds" if max(s["sers"]) <= gate else
                                        "FAILS (recorded, not loosened)", s["rms"], card))
        print("%s tracking with the single-card chain's taps (the shards' halos, unwrap and "
              "slopes): SER per mode %s (gate %.0e) [%s]" % (path, s["track"], SHARD_SER_GLOO, card))
        require(max(s["track"]) <= SHARD_SER_GLOO, "%s tracking SER gate failed: %s"
                % (path, s["track"]))
    for s in r0["summary"]["sweep"]:
        print("sharded decimated16 sweep, 4 ranks x %d symbols (TrSyms_loc %d): SER per mode %s, "
              "shard interiors (%d symbols off each boundary) %s [%s]"
              % (s["nsym"], s["TrSyms_loc"], s["sers"], SHARD_EDGE, s["interior"], card))
    for path in ("sharded pilot gloo4", "sharded pilot gloo4 shard_prefix"):
        s = r0["summary"][path]
        print("%s: shift %s, mode order %s, sync_corr %.3f, BER %.3e (gate %.0e with sync_corr "
              ">= %d) [%s]" % (path, s["shift"], s["mode_order"], s["sync_corr"], s["ber"],
                               1e-5, 120, card))
        require(s["ber"] <= 1e-5 and s["sync_corr"] >= 120, "%s BER gate failed" % path)
        for r in ranks:
            sr = r["summary"][path]
            require(sr["shift"] == s["shift"] and sr["mode_order"] == s["mode_order"],
                    "the ranks acquired different states (%s)" % path)
            if "bit_equal" in sr:
                require(sr["bit_equal"], "rank %d's payload differs from its frames of the single "
                        "dispatch by up to %.3e" % (r["rank"], sr["payload_dev"]))
            else:
                print("%s rank %d: state equal to the replicated prefix %s, taps max|d| %.3e "
                      "(bound %.0e x %.3f), decisions shared %.6f [%s]"
                      % (path, r["rank"], sr["same_state"], sr["taps_dev"], PILOT_TAPS_REL,
                         sr["taps_scale"], sr["agree"], card))
                require(sr["same_state"] and sr["taps_dev"] <= PILOT_TAPS_REL * sr["taps_scale"]
                        and sr["agree"] >= SMALL_AGREE, "%s differs from the replicated prefix"
                        % path)
        if "bit_equal" in s:
            print("%s: every rank's payload bit-equal to its frames of the single %d-frame "
                  "dispatch: %s [%s]" % (path, SHARD_RANKS * SHARD_PILOT_K,
                                         all(r["summary"][path]["bit_equal"] for r in ranks),
                                         card))
    return rec, path_launches


# ---------------------------------------------------------------------------
# phases 21-23: profiling, long captures, the examples
# ---------------------------------------------------------------------------

PROF_NSYMS = 2 ** 18             # the reference's run_benchmarks default
PROF_ROUTE = {"bps": "B3", "apply_filter": "B2"}     # train_<method>: B1; the rest plain
TOL_PROF_FILTER_REL = 1e-6       # B2 at the profiling shape, relative to the output's rms
PROF_TIES_MAX = 1e-2             # B3 on the groups' noise (not a signal): more near-tied windows
                                 # (1.55e-3 on the H100; < 1e-2 in tests/test_torch_profiling.py)
PRBS_BITS = 2 ** 20              # the host PRBS (native/ is not ported), timed at 2^20 bits
LONG_NSYM, LONG_CHUNK, LONG_HALO = 2 ** 22, 2 ** 20, 96     # tests/test_long_capture.py
LONG_BLIND_SER = 5e-3            # its gate, per chunk under one alignment
LONG_PILOT = dict(n_per=17, ndisp=4, frame_len=2 ** 16)     # 68 frames served of 69
LONG_PILOT_SER = 1e-2            # its gate, first and last frame of each dispatch


def examples_module():
    """``examples_torch/_common.py``, which puts the examples' directory on ``sys.path``."""
    path = os.path.join(REPO, "examples_torch")
    if path not in sys.path:
        sys.path.insert(0, path)
    import _common
    return _common


def once_ms(fn):
    """ms of one call of ``fn`` by CUDA events (a plain version's long host loop)."""
    return timed(fn)[1]


def profiling_b1(g, method, lat, card):
    """B1 at a profiling group's shape against the plain block trainer.

    Over ``GRID_BLOCKS`` blocks within ``TOL_GRID_TAPS`` for every method,
    and over the group's whole training within ``TOL_TAPS`` for the modulus
    methods (cma, mcma): rde expands rounding differences and a decision
    method's long runs part at a decision boundary (mddma read 1.35e-4
    over the 1,023 blocks on the H100), so those are held over the short
    run only; two launches bit-equal. The input is the reference's noise,
    not a signal.
    """
    deep = method not in eqops.DECISION_BLOCK_METHODS and method != "rde"
    P, trs, niter, os_, mu, w0, spec = g.args
    S = profiling.TRAIN_BLOCK
    short = (P, GRID_BLOCKS * S, 1, os_, mu, w0, spec, True, S)
    _, w_p, _ = train_block_plain(*short)
    _, w_k, _ = train_block_cuda(*short)
    d_short = float((w_k - w_p).abs().max())
    full = (P, trs, niter, os_, mu, w0, spec, True, S)
    (e_p, w_fp, _), plain_ms = timed(lambda: train_block_plain(*full))
    got = train_block_cuda(*full)
    again = train_block_cuda(*full)
    d_full = float((got[1] - w_fp).abs().max())
    print("B1 train_block (profiling train_%s: 40 taps, os 2, blocks of %d): taps over %d blocks "
          "max|d| %.3e (tol %.0e); over the group's %d blocks %.3e (tol %s); two launches "
          "bit-equal: %s" % (method, S, GRID_BLOCKS, d_short, TOL_GRID_TAPS, trs // S, d_full,
                             "%.0e" % TOL_TAPS if deep else "none, %s" % method,
                             all(torch.equal(a, b) for a, b in zip(got, again))))
    require(d_short <= TOL_GRID_TAPS, "B1 %s disagrees with its plain version over %d blocks "
            "(profiling)" % (method, GRID_BLOCKS))
    require(not deep or d_full <= TOL_TAPS,
            "B1 %s disagrees with its plain version over the group (profiling)" % method)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "two B1 launches differ (profiling %s)" % method)
    decide = OPS_DECIDE["sq"] if method in eqops.DECISION_BLOCK_METHODS else 0
    ms = device_ms(lambda: train_block_cuda(*full), 5)
    K = 2 * w0.shape[-1]
    print_chain("B1 train_block (profiling train_%s)" % method, lat, trs // S,
                block_chain_cycles(lat, K, S), ms, card, "block")
    return dict(**trainer_bound(2, 2, w0.shape[-1], os_, trs, niter, decide),
                err=d_full if deep else d_short, ms=ms, plain_ms=plain_ms,
                shape="%s, 40 taps, os 2, %d blocks of %d on 2 x %d samples of noise; "
                      "max_abs_err: taps over %s" % (method, trs // S, S, P.shape[-1],
                                                     "the group" if deep
                                                     else "%d blocks" % GRID_BLOCKS))


def profiling_phase(dev, card, lat):
    """Phase 21: ``profiling.run_benchmarks`` at the reference's 2^18 symbols on the card.

    Each group counted (B1 once a ``train_<method>``, B2 once, B3 once, no
    kernel in the plain groups) and routed as it reports; its Msym/s with
    the card; B1, B2 and B3 held to their plain versions at the groups'
    shapes. Also the host's numpy PRBS (``native/`` is not ported).
    """
    for order in (15, 23):
        t0 = time.perf_counter()
        bits = prbs.make_prbs_extXOR(order, PRBS_BITS, seed=1)
        print("host: prbs.make_prbs_extXOR(%d, 2^20) %.4f s (host clock, %d bits)"
              % (order, time.perf_counter() - t0, bits.size))
    groups = profiling.benchmark_groups(PROF_NSYMS, device=dev)
    launches = {}
    for name, g in groups.items():
        want = PROF_ROUTE.get(name, "B1" if name.startswith("train_") else "plain")
        _, counts = counted(lambda: g.fn(*g.args))
        launches["profiling " + name] = counts
        print("profiling %s: route %s, launches %s" % (name, g.route, counts))
        require(g.route == want and counts == expected({} if want == "plain" else {want: 1}),
                "the profiling group %s did not launch as its route %s says" % (name, g.route))
    res, routes = profiling.run_benchmarks(nsyms=PROF_NSYMS, device=dev, routes=True)
    for name, v in res.items():
        print("time profiling %s: %.2f Msym/s, route %s (run_benchmarks, median of 5 "
              "synchronised calls) [%s]" % (name, v, routes[name], card))
    require(routes == {n: g.route for n, g in groups.items()} and all(v > 0 for v in res.values()),
            "run_benchmarks reports other routes or no rate")
    rec = {}
    er, ei, cos_t, sin_t, grid, N, pts = groups["bps"].args
    rec["B3", "profiling bps"] = b3_record(er, ei, cos_t, sin_t, grid, N, pts, "profiling bps",
                                           share_max=PROF_TIES_MAX)[0]
    P2, os_, wx = groups["apply_filter"].args
    out_k, out_p = apply_filter_cuda(P2, os_, wx), apply_filter_plain(P2, os_, wx)
    rms = float(out_p.pow(2).mean().sqrt())
    d = float((out_k - out_p).abs().max())
    print("B2 apply_filter (profiling apply_filter: 17 taps, 2 x %d samples): max|d| %.3e (tol "
          "%.0e x rms %.3f)" % (P2.shape[-1], d, TOL_PROF_FILTER_REL, rms))
    require(d <= TOL_PROF_FILTER_REL * rms, "B2 disagrees with its plain version (profiling)")
    rec["B2", "profiling apply_filter"] = b2_record(P2, os_, wx, None, "profiling apply_filter",
                                                    "2 x %d samples, 17 identity taps"
                                                    % P2.shape[-1])[0]
    for name, g in groups.items():
        if name.startswith("train_"):
            rec["B1", "profiling " + name] = profiling_b1(g, name[len("train_"):], lat, card)
    print_times(rec, card)
    return rec, launches


def long_blind(dev, card, ex):
    """"long blind": 2^22 symbols of 16-QAM in 4 dispatches of 2^20 through ``RxChain.planes``."""
    path = "long blind"
    t0 = time.perf_counter()
    sig, Pp = ex.blind_capture(dev, LONG_NSYM)
    chain = ex.blind_chain(dev, block_size=128)
    torch.cuda.synchronize()
    print("%s: SignalQAMGrayCoded(16, 2^22, nmodes=2) at 2 samples a symbol, PMD, 25 dB, built on "
          "the card in %.2f s (host clock); planes %s with the halo; %s"
          % (path, time.perf_counter() - t0, tuple(Pp.shape), chain.backend_info))
    outs, counts = [], None
    for c in range(LONG_NSYM // LONG_CHUNK):
        seg = ex.blind_segment(Pp, c, LONG_CHUNK)
        o, n = counted(lambda: chain.planes(seg))
        outs.append(torch.complex(*o)[:, LONG_HALO:LONG_HALO + LONG_CHUNK])
        print("%s dispatch %d: launches %s" % (path, c, n))
        require(n == expected({"B1": 2, "B2": 1, "B3": 1, "B7": 1}),
                "a %s dispatch did not launch each kernel as expected" % path)
        counts = n
    sers, same = ex.blind_check(sig, outs, LONG_CHUNK)
    print("%s: SER per chunk under its alignment %s (gate %.0e), one delay and pairing: %s"
          % (path, sers, LONG_BLIND_SER, same))
    require(same and max(sers) < LONG_BLIND_SER, "the %s gate failed" % path)
    seg = ex.blind_segment(Pp, 1, LONG_CHUNK).contiguous()
    t = cuda_ms(lambda: chain.planes(seg), 10)
    print("time %s: %.4f ms a dispatch of 2 x %d symbols, %.1f Msym/s [%s]"
          % (path, t, LONG_CHUNK, 2 * LONG_CHUNK / t / 1e3, card))
    # the kernels at a dispatch's shapes
    rec = {}
    s1, s2 = chain.specs
    trs, S, os_, mu = chain.TrSyms, chain.block_size, chain.os, chain.mu
    w0 = chain.w0
    _, w_p, _ = train_block_plain(seg, trs, 1, os_, mu, w0, s1, True, S)
    _, w_k, _ = train_block_cuda(seg, trs, 1, os_, mu, w0, s1, True, S)
    w1 = cma_singularity_guard(w_k)
    b8 = (seg, GRID_BLOCKS * S, 1, os_, mu, w1, s2, True, S)
    d1 = float((w_k - w_p).abs().max())
    d2 = float((train_block_cuda(*b8)[1] - train_block_plain(*b8)[1]).abs().max())
    print("B1 train_block (%s: 16-QAM, 11 taps, blocks of 128): cma over %d blocks max|d| %.3e "
          "(tol %.0e); sbd over %d blocks %.3e (tol %.0e)"
          % (path, trs // S, d1, TOL_TAPS, GRID_BLOCKS, d2, TOL_GRID_TAPS))
    require(d1 <= TOL_TAPS and d2 <= TOL_GRID_TAPS, "B1 disagrees with its plain version (%s)"
            % path)
    b1 = (seg, trs, 1, os_, mu, w0, s1, True, S)
    rec["B1"] = dict(**trainer_bound(2, 2, chain.Ntaps, os_, trs, 1), err=d1,
                     ms=device_ms(lambda: train_block_cuda(*b1), 10),
                     plain_ms=device_ms(lambda: train_block_plain(*b1), 2),
                     shape="cma, 16-QAM, 11 taps, %d blocks of %d (sbd over %d blocks: %.3e)"
                           % (trs // S, S, GRID_BLOCKS, d2))
    w = chain.train_taps(seg)
    rec["B2"], (eqp,) = b2_record(seg, os_, w, None, path,
                                  "2 x %d samples in (a dispatch), 11 taps" % seg.shape[-1])
    no = eqp.shape[0] // 2
    er, ei = eqp[:no].contiguous(), eqp[no:].contiguous()
    rec["B3"], idx = b3_record(er, ei, chain.bps_cos, chain.bps_sin, chain.search_grid,
                               chain.search_N, None, path)
    rec["B7"] = b7_record(er, ei, chain.lo_a + chain.step_a * idx.to(torch.float32), path)
    rec = {(k, path): v for k, v in rec.items()}
    print_times(rec, card)
    return rec, counts


def long_pilot(dev, card, ex, lat):
    """"long pilot": a 69-frame capture, the full LMS chain over frames 0-16, then 3 tracking
    dispatches at ``_frame_base = d 17 2^16 2``; each bit-equal to a chain over its own frames."""
    path = "long pilot"
    c = LONG_PILOT
    n_per, ndisp, F_ = c["n_per"], c["ndisp"], c["frame_len"]
    t0 = time.perf_counter()
    sig, E = ex.pilot_capture(dev, n_per * ndisp + 1, F_=F_)
    chain = ex.pilot_chain(sig, n_per, dev)
    torch.cuda.synchronize()
    print("%s: SignalWithPilots(64, 2^16, 1024, 32, nframes=%d), 28 dB, built on the card in "
          "%.2f s (host clock); the LMS chain (45 taps, blocks of 128) over frames 0-%d"
          % (path, n_per * ndisp + 1, time.perf_counter() - t0, n_per - 1))
    pr, pi = E.real.contiguous(), E.imag.contiguous()
    ((d0r, d0i), info), full_counts = counted(lambda: chain.planes(pr, pi))
    print("%s full dispatch: launches %s, sync_corr %.3f" % (path, full_counts,
                                                           float(info["sync_corr"])))
    require(full_counts == expected({"B1": 3, "B2 frames": 1, "B5": 1, "B4": 1}),
            "the %s full dispatch did not launch each kernel as expected" % path)
    state = (info["taps"], info["shift"], info["mode_order"])
    datas, counts, sers = [torch.complex(d0r, d0i)], None, []
    for d in range(1, ndisp):
        base = d * n_per * F_ * 2
        ((dr, di), _), n = counted(lambda: chain.tracking_planes(pr, pi, *state, _frame_base=base))
        syncs = syncs_in(lambda: chain.tracking_planes(pr, pi, *state, _frame_base=base))
        other = ex.pilot_chain(sig, n_per, dev, first=d * n_per)
        (orr, ori), _ = other.tracking_planes(pr, pi, *state)
        same = bool(torch.equal(orr, dr) and torch.equal(ori, di))
        print("%s dispatch %d (_frame_base %d): launches %s, synchronising calls %d %s, "
              "bit-equal to a chain over frames %d-%d: %s"
              % (path, d, base, n, len(syncs), syncs[:2], d * n_per, (d + 1) * n_per - 1, same))
        require(n == expected({"B2 frames": 1, "B5": 1, "B4": 1}) and not syncs and same,
                "the %s tracking dispatch at an offset failed its launches, syncs or equality"
                % path)
        datas.append(torch.complex(dr, di))
        counts = n
    for d, dat in enumerate(datas):
        s = [ex.frame_ser(sig, dat, d * n_per + k, k) for k in (0, n_per - 1)]
        sers.append(s)
        print("%s dispatch %d: SER of frames %d and %d: %s (gate %.0e)"
              % (path, d, d * n_per, d * n_per + n_per - 1, s, LONG_PILOT_SER))
    require(max(max(s) for s in sers) < LONG_PILOT_SER, "the %s gate failed" % path)
    base = n_per * F_ * 2
    t_full = cuda_ms(lambda: chain.planes(pr, pi), 3)
    t_trk = cuda_ms(lambda: chain.tracking_planes(pr, pi, *state, _frame_base=base), 10)
    npay = datas[0].shape[-1] * 2
    print("time %s: full dispatch %.4f ms, tracking dispatch at an offset %.4f ms (%d frames, "
          "%.1f payload Msym/s) [%s]" % (path, t_full, t_trk, n_per, npay / t_trk / 1e3, card))
    # the kernels at a tracking dispatch's shapes
    st = pilot_stages(chain, pr, pi, base)
    offs, taps = st["offs"], st["taps"]
    plain = apply_filter_frames_plain(st["P"], chain.os, taps, offs, F_)
    err = float((st["out"] - plain).abs().max())
    rms = float(plain.pow(2).mean().sqrt())
    del plain
    print("B2 frames (%s, %d frames at _frame_base %d): max|d| %.3e (tol %.0e x rms %.3f)"
          % (path, n_per, base, err, TOL_FILTER_REL, rms))
    require(err <= TOL_FILTER_REL * rms, "B2's frame entry disagrees with its plain version (%s)"
            % path)
    rec = {("B2 frames", path): b2_frames_record(chain, st, offs, path, err),
           ("B5", path): b5_record(chain, st, card, path),
           ("B4", path): b4_pilot_record(chain, st, path)}
    # the full dispatch: B1's three batched LMS stages, and the frame body at the same shapes
    full = path + " full"
    rec["B1", full] = b1_batch_record(chain, st["segs"], full, card, lat)
    for k in ("B2 frames", "B5", "B4"):
        rec[k, full] = dict(rec[k, path], shape=rec[k, path]["shape"] + " (at frames 0-16)")
    print_times(rec, card)
    return rec, counts, full_counts


def long_capture_phase(dev, card, lat):
    """Phase 22: tests/test_long_capture.py's captures, served in dispatches, on the card."""
    ex = examples_module().load("long_capture_serving")
    rec, launches = {}, {}
    r, launches["long blind"] = long_blind(dev, card, ex)
    rec.update(r)
    gc.collect()
    torch.cuda.empty_cache()
    r, launches["long pilot"], launches["long pilot full"] = long_pilot(dev, card, ex, lat)
    rec.update(r)
    return rec, launches


def examples_phase(card):
    """Phase 23: every ``examples_torch`` script's ``main`` on the card at its own sizes, gated.

    No size is cut; ``64qam_data_test`` reads a matlab file of 2^15 random
    64-QAM symbols written here, the repository holding no capture.
    """
    common = examples_module()
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in common.NAMES:
            mod = common.load(name)
            kw = {}
            if name == "64qam_data_test":
                kw["mat"] = mod.write_test_file(os.path.join(tmp, "x_symbs.mat"))
            if name == "multichip_scaling":
                gc.collect()
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            res = mod.main(**kw)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            bad = common.gate_failures(mod.GATES, res)
            figs = {k: res[k] for k in mod.GATES}
            print("example %s: %.2f s wall (host clock), its own sizes; gated figures %s; gates "
                  "%s: %s [%s]" % (name, t, json.dumps(figs), json.dumps(mod.GATES),
                                   "pass" if not bad else bad, card))
            if bad:
                failed.append(name)
    require(not failed, "examples missed their gates: %s" % failed)


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
    CARD.append(card)
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
        path_launches["blind " + mode] = chain_path(
            "blind " + mode, dict(SAMPLE_CFG, bps_mode=mode), SAMPLE_GATES[mode], P, ref, const,
            dict(seed=2), card)[0]
        rec["B1", "blind " + mode] = rec["B1", "blind"]
    mrec, mode_launches = mode_paths(P, ref, const, card, rec, (outr, outi))
    rec.update(mrec)
    path_launches.update(mode_launches)

    prec, pilot_launches = pilot_phases(dev, card, lat)
    rec.update(prec)
    path_launches.update(pilot_launches)

    # phases 13-15: the granular equaliser
    seq_check = check_seq_kernel(dev, card)
    check_block_methods(P, chain, card)
    del P
    erec, eq_launches = equaliser_phases(dev, card, seq_check, lat)
    rec.update(erec)
    path_launches.update(eq_launches)

    # phases 16 and 17: constellations that are not a square grid
    grec, grid_launches = grid_phases(dev, card)
    rec.update(grec)
    path_launches.update(grid_launches)

    # phase 18: phase recovery on the signal objects
    prec, phase_launches = phase_phases(dev, card)
    rec.update(prec)
    path_launches.update(phase_launches)

    # phase 19: BASELINE configs 1, 4 and 5 on the signal objects
    brec, base_launches = baseline_phases(dev, card, lat)
    rec.update(brec)
    path_launches.update(base_launches)

    # phase 20: the multi-device receivers
    srec, shard_launches = sharded_phase(E, syms, const, lat, card)
    rec.update(srec)
    path_launches.update(shard_launches)

    # phases 21-23: profiling, long captures, the examples
    gc.collect()
    torch.cuda.empty_cache()
    frec, prof_launches = profiling_phase(dev, card, lat)
    rec.update(frec)
    path_launches.update(prof_launches)
    lrec, long_launches = long_capture_phase(dev, card, lat)
    rec.update(lrec)
    path_launches.update(long_launches)
    examples_phase(card)
    print("launches per path: %s" % path_launches)
    # one record per kernel and path that launched it: that path's count and
    # the error and times measured at that path's shapes
    kernels = [{"name": KERNELS[k][0], "path": path, "grid": "sq", "route": "cuda",
                "source": KERNELS[k][1],
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
        if len(sys.argv) > 1 and sys.argv[1] == "--shard-rank":
            r_, n_, addr_, lat_, out_ = sys.argv[2:7]
            sys.exit(shard_worker(int(r_), int(n_), addr_, lat_, out_))
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
