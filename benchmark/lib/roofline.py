"""Operations and bytes of each stage's own work, and the least time the card could take.

Frozen from the port's ``chip_smoke.py`` (its ``bound``, ``trainer_bound``,
``filter_bound``, ``bps_ops`` and the ``OPS_*`` counts), so that a later change to
the program cannot move the yardstick. Each input byte is counted as read once
and each output byte as written once, whatever a kernel reads again; the
operations are those the algorithm needs, in float32. The peaks are the H100
SXM's published ones at its 700 W limit; a card set below that limit reads low
against them, so every share is printed beside the card's power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
F32 = 4

# operations per element, counted from each function's definition: a complex
# multiply-add as 8, sin and cos as one each, a floor, clamp, abs or compare as one
OPS_FILTER_TAP = 8       # one complex tap on one output sample
OPS_TRAIN_TAP = 16       # a tap's complex multiply-add in z and in the update, per sample
OPS_TRAIN_ERR = 10       # the error and the step-size rule, per training sample
OPS_BPS_SEARCH = 9       # per sample and angle: rotate 6, running window 2, compare 1
OPS_DECIDE_SQUARE = 17   # per sample and angle on a square grid: per axis decide 6, offset 1;
                         # then squares and sum 3
OPS_ROTATE = 8           # sin, cos and the rotation
OPS_INTERP = 2           # a + b j
OPS_CPE_PILOT = 20       # conjugate product, atan2, unwrap, average, coefficients


def bound_s(nbytes, ops):
    """The least seconds the card could take for ``nbytes`` moved and ``ops`` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def train(nmodes, nout, ntaps, os, nsyms, niter, decide_ops=0):
    """(bytes, ops) of a block trainer: the capture prefix in, taps in and out, the error out."""
    K = nmodes * ntaps
    moved = F32 * (2 * nmodes * (nsyms * os + ntaps - 1) + 2 * nout * nsyms * niter
                   + 4 * nout * K)
    return moved, niter * nsyms * nout * (OPS_TRAIN_TAP * K + OPS_TRAIN_ERR + decide_ops)


def fir(in_samples, nmodes, nout, ntaps, out_samples, side_samples=0):
    """(bytes, ops) of the MIMO filter: the input planes and taps in, output and side output out.

    ``in_samples`` and ``out_samples`` are per mode; ``side_samples`` counts the
    side output's samples per output mode (the stride-K copy, or the pilots).
    """
    moved = F32 * (2 * nmodes * in_samples + 2 * nout * nmodes * ntaps
                   + 2 * nout * (out_samples + side_samples))
    return moved, OPS_FILTER_TAP * nmodes * ntaps * nout * out_samples


def search(samples, angles):
    """(bytes, ops) of the blind phase search on a square grid over ``samples`` (all modes)."""
    moved = F32 * (2 * samples + 2 * angles + samples)
    return moved, (OPS_BPS_SEARCH + OPS_DECIDE_SQUARE) * angles * samples


def interp_rotate(samples, blocks):
    """(bytes, ops) of the piecewise-linear derotation: planes and (a, b) in, planes out."""
    return F32 * (4 * samples + 2 * blocks), (OPS_INTERP + OPS_ROTATE) * samples


def cpe(rows, pilots, known, blocks):
    """(bytes, ops) of the pilot CPE's coefficients: the rows' pilots and the known ones in,
    (a, b) per block out."""
    return F32 * (2 * rows * pilots + 2 * known + 2 * rows * blocks), OPS_CPE_PILOT * rows * pilots


def add(*works):
    """The sum of several (bytes, ops)."""
    return sum(w[0] for w in works), sum(w[1] for w in works)
