"""Kernels B3-B8 of carrier recovery with their wrappers.

As in ``ops/equaliser_cuda.py``: ``*_cuda`` launches the CUDA kernel of
``csrc/phase.cu`` (and raises on anything but contiguous CUDA tensors),
``*_plain`` is its plain PyTorch version, and the bare name dispatches on
the device of the input. ``*_cuda.launches`` counts kernel launches; each
``*_cuda`` runs inside the host span ``qtt.B<k>`` of its kernel.

B3 and B8 take every kind of constellation the reference's do (square,
rectangular, cross, a general alphabet of up to 256 points).

B3 (blind phase search) replaces ``qampy_tpu/ops/phase_pallas.py:bps_idx_pallas``,
B4 (interp-rotate) ``interp_rotate_planes_pallas``, B5 (the pilot CPE's
phase coefficients) ``cpe_coeffs_pallas``, B6 (rotation by a given
phase) ``rotate_planes_pallas``, B7 (pi/2 unwrap and derotation)
``unwrap_derotate_pallas`` and B8 (the two-stage search's fine stage)
``bps_fine_pallas``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops._build import KernelLimit
from qampy_tpu_torch.ops.phase import bps_idx_planes as bps_search_plain
from qampy_tpu_torch.profiling import spanned

_SMEM_LIMIT = 227 * 1024


def _grid_args(grid, device, points, what):
    """The grid arguments of a B3 or B8 launch: (tuple for the C call, the table kept alive)."""
    gc = phops.grid_consts(grid, what)
    table = phops.points_tensor(grid, device, points)
    npts = 0 if table is None else table.shape[0]
    return (gc.code, *gc.scaled, None if table is None else table.data_ptr(), npts), table


# ---------------------------------------------------------------------------
# B3: blind phase search
# ---------------------------------------------------------------------------

#: csrc/phase.cu: threads of a B3 CTA, positions of a thread's run at most (on a square,
#: rectangular or cross grid; on a general alphabet), angles per pass over the tile, and
#: the least grid the runs shrink for (~2 CTAs per SM)
BPS_THREADS, BPS_MAX_RUN, BPS_MAX_RUN_GEN, BPS_CHUNK, BPS_MIN_CTAS = 128, 16, 8, 4, 256


class BpsPlan(NamedTuple):
    """A B3 launch (csrc/phase.cu ``BpsPlan``).

    ``run``: consecutive positions per thread; ``tile``: positions per CTA;
    ``chunk``: angles per pass over the tile; ``smem``: shared-memory bytes
    of a CTA; ``ctas``: CTAs of the grid, ``nmodes`` rows of tiles.
    """
    run: int
    tile: int
    chunk: int
    smem: int
    ctas: int


def _bps_run(nmodes, L, max_run):
    """The longest run from ``max_run`` down at which the grid keeps ``BPS_MIN_CTAS`` CTAs."""
    run = max_run
    while run > 1 and nmodes * -(-L // (BPS_THREADS * run)) < BPS_MIN_CTAS:
        run //= 2
    return run


def _bps_slots(W, run):
    """Slots of a table of W staged samples, padded by one every run (none at runs of one)."""
    return W + ((W - 1) // run if run > 1 else 0)


def _check_plan(what, plan, c_fn, *args):
    """Hold a host launch plan against the built library's (``c_fn`` fills its fields)."""
    built = (ctypes.c_longlong * len(plan))()
    c_fn(*args, ctypes.addressof(built))
    if tuple(built) != plan:
        raise RuntimeError("%s and csrc/phase.cu disagree: %s, %s" % (what, plan, tuple(built)))


def bps_plan(nmodes, L, N, npts=0):
    """The :class:`BpsPlan` of B3 on (nmodes, L) planes with half-window N, on the host.

    The run halves from ``BPS_MAX_RUN`` (``BPS_MAX_RUN_GEN`` on a general
    alphabet, whose long point loop wants more CTAs per SM) while the grid
    would have fewer than ``BPS_MIN_CTAS`` CTAs (down to one position per
    thread), so that short rows still fill the card. A CTA holds a general alphabet's ``npts``
    points as float4, a table of T + 2N - 1 slots of ``BPS_CHUNK`` floats,
    padded by one slot every run, and the tile's T + 2N - 1 samples as
    float2: nothing grows with the number of angles. The launcher holds
    this against ``qtt_bps_plan`` of the built library.
    """
    run = _bps_run(nmodes, L, BPS_MAX_RUN_GEN if npts else BPS_MAX_RUN)
    tile = BPS_THREADS * run
    W = tile + 2 * N - 1
    smem = 16 * npts + 8 * W + 4 * BPS_CHUNK * _bps_slots(W, run)
    return BpsPlan(run, tile, BPS_CHUNK, smem, nmodes * -(-L // tile))


#: csrc/phase.cu: windows of a thread at most with bf16 windows, in B3 and in B8 (runs of 16 hold
#: more registers and took 9 % longer at twostage's coarse shape on the H100), and the residue
#: classes a tile is walked in
BF16_MAX_RUN, BF16_FINE_MAX_RUN, BF16_CLASS = 8, 8, 8


def _bf16_tables(N):
    """The bf16 tables the walks read: S_g, one per component of 2N below g = min(8, top)."""
    N2 = 2 * N
    g = min(1 << (N2.bit_length() - 1), BF16_CLASS)
    return 1 + bin(N2 & (g - 1)).count("1")


def bf16_plan(nmodes, L, N, T, npts=0, fine=False):
    """The :class:`BpsPlan` of B3 (or B8, ``fine``) with bf16 windows at reference tile T.

    Mirrored by ``qtt_bps_bf16_plan``. Runs from ``BF16_MAX_RUN``
    (``BF16_FINE_MAX_RUN`` in B8) down by B3's rule, then halved while the
    CTA would exceed 227 KB: a general alphabet's points as float4, the
    CTA's W = 128 run + 2N - 1 samples (float2 in B3, float4 [x, y, cos ph1,
    sin ph1] in B8), the chunk's W distances as 8-byte slots (4 angles as two
    bf16 pairs), S_g and each component of 2N below g in tables of W slots
    (the residue-class walks read them), and per reference-tile boundary that
    the CTA's windows cross the tail's 128 distances and its 2N slots.
    """
    run = _bps_run(nmodes, L, BF16_FINE_MAX_RUN if fine else BF16_MAX_RUN)

    def smem(run):
        tile = BPS_THREADS * run
        W = tile + 2 * N - 1
        bounds = (tile + 2 * N - 2) // T + 1
        return (16 * npts + (16 if fine else 8) * W + 8 * W
                + 8 * _bf16_tables(N) * W + 8 * (128 + 2 * N) * bounds)
    while smem(run) > _SMEM_LIMIT and run > 1:
        run //= 2
    tile = BPS_THREADS * run
    return BpsPlan(run, tile, BPS_CHUNK, smem(run), nmodes * -(-L // tile))


def _check_bf16_plan(plan, what, lib, fine, nmodes, L, N, npts, T):
    if plan.smem > _SMEM_LIMIT:
        raise KernelLimit("%s with bf16 windows needs %d bytes of shared memory for N=%d, a CTA "
                          "has %d" % (what, plan.smem, N, _SMEM_LIMIT))
    _check_plan("bf16_plan", plan, lib.qtt_bps_bf16_plan, int(fine), nmodes, L, N, npts, T)


@spanned("qtt.B3")
def bps_search_cuda(er, ei, cos_t, sin_t, grid, N, points=None, bf16_tile=None):
    """Launch kernel B3; same contract as :func:`bps_search_plain`.

    er/ei: (nmodes, L) float32 planes; cos_t/sin_t: (A,) float32 tables
    from ``ops.phase.bps_tables``; ``grid`` a grid spec of any kind;
    ``points`` a general alphabet's table on the card
    (``ops.phase.points_tensor``; copied from the host if not given);
    ``bf16_tile``: None sums the windows in float32, an int T in bf16 in the
    reference's order over tiles of T (``ops.phase.bf16_window_sums``).
    Returns int32 (nmodes, L).
    """
    _build.require_cuda("bps_search_cuda", er, ei, cos_t, sin_t, dtype=torch.float32)
    if er.dim() != 2 or er.shape != ei.shape:
        raise ValueError("bps_search_cuda takes two (nmodes, L) planes of one shape")
    if cos_t.dim() != 1 or cos_t.shape != sin_t.shape or cos_t.shape[0] < 1:
        raise ValueError("bps_search_cuda takes two (A,) angle tables, A >= 1")
    if int(N) < 0:
        raise ValueError("bps_search_cuda takes a half-window N >= 0, got %r" % (N,))
    gargs, table = _grid_args(grid, er.device, points, "bps_search_cuda")
    A, (nmodes, L) = cos_t.shape[0], er.shape
    if bf16_tile is not None:
        phops.check_bf16_tile(N, bf16_tile)
        T = int(bf16_tile)
        plan = bf16_plan(nmodes, L, int(N), T, gargs[-1])
        lib = _build.library()
        _check_bf16_plan(plan, "B3", lib, False, nmodes, L, int(N), gargs[-1], T)
        out = torch.empty((nmodes, L), dtype=torch.int32, device=er.device)
        rc = lib.qtt_bps_idx_bf16(er.data_ptr(), ei.data_ptr(), nmodes, L, cos_t.data_ptr(),
                                  sin_t.data_ptr(), A, int(N), T, *gargs, out.data_ptr(),
                                  _build.stream_of(er))
        _build.check(rc, "bps_search_cuda")
        bps_search_cuda.launches += 1
        return out
    plan = bps_plan(nmodes, L, int(N), gargs[-1])
    if plan.smem > _SMEM_LIMIT:
        raise KernelLimit("B3 needs %d bytes of shared memory for N=%d, a CTA has %d"
                          % (plan.smem, N, _SMEM_LIMIT))
    lib = _build.library()
    _check_plan("bps_plan", plan, lib.qtt_bps_plan, nmodes, L, int(N), gargs[-1])
    out = torch.empty((nmodes, L), dtype=torch.int32, device=er.device)
    rc = lib.qtt_bps_idx(er.data_ptr(), ei.data_ptr(), nmodes, L, cos_t.data_ptr(),
                         sin_t.data_ptr(), A, int(N), *gargs, out.data_ptr(),
                         _build.stream_of(er))
    _build.check(rc, "bps_search_cuda")
    bps_search_cuda.launches += 1
    return out


bps_search_cuda.launches = 0


def bps_search(er, ei, cos_t, sin_t, grid, N, points=None, bf16_tile=None):
    """BPS angle-index search: the plain version on CPU tensors, kernel B3 on CUDA.

    ``points``, ``bf16_tile``: see :func:`bps_search_cuda`; the plain version reads the host
    table.
    """
    if er.device.type == "cpu":
        return bps_search_plain(er, ei, cos_t, sin_t, grid, N, bf16_tile)
    return bps_search_cuda(er, ei, cos_t, sin_t, grid, N, points, bf16_tile)


# ---------------------------------------------------------------------------
# B4: piecewise-linear phase derotation
# ---------------------------------------------------------------------------

def _check_sign(sign):
    if sign not in (1, -1):
        raise ValueError("sign must be +1 or -1, got %r" % (sign,))


def _rotate_planes(er, ei, c, s, sign):
    """(er + j ei) exp(sign j ph) from c = cos(ph), s = sin(ph)."""
    if sign > 0:
        return er * c - ei * s, er * s + ei * c
    return er * c + ei * s, ei * c - er * s


def _check_interp(er, ei, a, b, dx, sign):
    _check_sign(sign)
    if er.dim() != 2 or er.shape != ei.shape or a.shape != b.shape:
        raise ValueError("interp_rotate takes (nmodes, L) planes and (nmodes, L//dx) coefficients")
    if er.shape[-1] % dx or a.shape != (er.shape[0], er.shape[-1] // dx):
        raise ValueError("coefficients of shape %s do not cover planes %s in blocks of %d"
                         % (tuple(a.shape), tuple(er.shape), dx))


def interp_rotate_plain(er, ei, a, b, dx, sign=-1):
    """Plain derotation: ph = a[i//dx] + b[i//dx]*(i%dx), out = (er + j ei) exp(sign j ph)."""
    _check_interp(er, ei, a, b, dx, sign)
    frac = (torch.arange(er.shape[-1], device=er.device) % dx).to(torch.float32)
    ph = a.repeat_interleave(dx, dim=-1) + b.repeat_interleave(dx, dim=-1) * frac
    return _rotate_planes(er, ei, torch.cos(ph), torch.sin(ph), sign)


@spanned("qtt.B4")
def interp_rotate_cuda(er, ei, a, b, dx, sign=-1):
    """Launch kernel B4; same contract as :func:`interp_rotate_plain`."""
    _build.require_cuda("interp_rotate_cuda", er, ei, a, b, dtype=torch.float32)
    _check_interp(er, ei, a, b, dx, sign)
    nmodes, L = er.shape
    outr = torch.empty_like(er)
    outi = torch.empty_like(ei)
    rc = _build.library().qtt_interp_rotate(
        er.data_ptr(), ei.data_ptr(), a.data_ptr(), b.data_ptr(), nmodes, L, a.shape[-1],
        int(dx), int(sign), outr.data_ptr(), outi.data_ptr(), _build.stream_of(er))
    _build.check(rc, "interp_rotate_cuda")
    interp_rotate_cuda.launches += 1
    return outr, outi


interp_rotate_cuda.launches = 0


def interp_rotate(er, ei, a, b, dx, sign=-1):
    """Interp-rotate: the plain version on CPU tensors, kernel B4 on CUDA."""
    fn = interp_rotate_plain if er.device.type == "cpu" else interp_rotate_cuda
    return fn(er, ei, a, b, dx, sign)


# ---------------------------------------------------------------------------
# B5: the pilot CPE's per-block phase coefficients
# ---------------------------------------------------------------------------

#: 2*pi and 1/(2*pi) rounded to float32, as the reference kernel holds them
TWO_PI = phops.TWO_PI
INV_TWO_PI = float(np.float32(1 / (2 * np.pi)))


def moving_average(u, c, npts):
    """pavg[..., l] = (u[l+c-1] + ... + u[l]) / c for l < npts, summed in that order (float32).

    The reference kernel's form. The reference's plain CPE forms the same
    average as a difference of cumulative sums, which in float32 loses
    ~1e-4 rad over a 2016-pilot frame; this one is exact to an ulp.
    """
    acc = u[..., c - 1: c - 1 + npts]
    for k in range(1, c):
        acc = acc + u[..., c - 1 - k: c - 1 - k + npts]
    return acc / c


def _check_cpe(symr, symi, pil_r, pil_i, off, stride, n_head, npts, cpe_avg, nbt):
    if symr.dim() != 2 or symr.shape != symi.shape:
        raise ValueError("cpe_coeffs takes two (rows, frame_len) planes of one shape")
    if pil_r.dim() != 2 or pil_r.shape != pil_i.shape or symr.shape[0] % pil_r.shape[0]:
        raise ValueError("pilots of shape %s do not divide %d rows"
                         % (tuple(pil_r.shape), symr.shape[0]))
    npil = pil_r.shape[1]
    if off + (npil - 1) * stride >= symr.shape[1]:
        raise ValueError("%d pilots at offset %d, stride %d overrun rows of %d symbols"
                         % (npil, off, stride, symr.shape[1]))
    if cpe_avg < 1 or npts < 2 or npts + cpe_avg - 1 > npil:
        raise ValueError("a %d-point average over %d pilots gives fewer than %d points"
                         % (cpe_avg, npil, npts))
    if n_head < 0 or nbt < 1:
        raise ValueError("n_head must be >= 0 and nbt >= 1")
    return npil


def cpe_coeffs_plain(symr, symi, pil_r, pil_i, off, stride, n_head, npts, dx, cpe_avg, nbt):
    """Plain pilot-CPE phase coefficients, the formula of the reference kernel.

    symr/symi: (rows, frame_len) filtered symbols, rows ordered (mode,
    frame); the received pilots are z_j = sym[:, off + j*stride]. pil_r/pil_i:
    (nmodes, npil) known pilots, row r of the symbols takes pilot row
    r // (rows // nmodes). Per row (phase_pallas.py:749-805, use_atan2 form):
    ph_j = atan2 of conj(pil_j) z_j; u = ph - 2*pi*cumsum(floor(d/(2*pi) +
    0.5)), d_j = ph_j - ph_{j-1}, d_0 = 0; pavg[l] = (u[l+c-1] + ... + u[l])/c
    for l < npts; then for each block k < nbt, la = k - n_head:
    a = pavg[0] (la < 0), pavg[la] (0 <= la < npts-1) or pavg[npts-1], and
    b = (pavg[la+1] - pavg[la])/dx inside, 0 outside. Returns (a, b), each
    (rows, nbt) float32.
    """
    npil = _check_cpe(symr, symi, pil_r, pil_i, off, stride, n_head, npts, cpe_avg, nbt)
    rows = symr.shape[0]
    zr = symr[:, off: off + (npil - 1) * stride + 1: stride]
    zi = symi[:, off: off + (npil - 1) * stride + 1: stride]
    pr = pil_r.repeat_interleave(rows // pil_r.shape[0], dim=0)
    pi = pil_i.repeat_interleave(rows // pil_r.shape[0], dim=0)
    ph = torch.atan2(pr * zi - pi * zr, pr * zr + pi * zi)
    d = ph[:, 1:] - ph[:, :-1]
    m = torch.floor(d * INV_TWO_PI + 0.5).to(torch.int32)
    s = torch.cumsum(torch.nn.functional.pad(m, (1, 0)), dim=-1, dtype=torch.int32)
    u = ph - TWO_PI * s.to(torch.float32)
    pavg = moving_average(u, int(cpe_avg), npts)
    la = torch.arange(nbt, device=symr.device) - n_head
    mid = (la >= 0) & (la < npts - 1)
    j = la.clamp(0, npts - 2)
    inner = pavg[:, j]
    a = torch.where(la < 0, pavg[:, :1], torch.where(mid, inner, pavg[:, npts - 1:npts]))
    b = torch.where(mid, (pavg[:, j + 1] - inner) / dx, 0.0)
    return a, b


#: csrc/phase.cu: threads of a B5 CTA, consecutive pilots per thread, pilots per tile
CPE_THREADS, CPE_ITEMS = 512, 4
CPE_TILE = CPE_THREADS * CPE_ITEMS
_STATIC_SMEM = 48 * 1024


class CpePlan(NamedTuple):
    """A B5 launch (csrc/phase.cu ``CpePlan``): one CTA of ``CPE_THREADS`` per row.

    ``tile``: pilots per pass over a row; ``tiles``: passes, over the
    npts + cpe_avg - 1 pilots that the average reaches; ``halo``: the
    unwrapped phases kept before a tile (cpe_avg, rounded up to 4 so that
    the tile starts on 16 bytes); ``smem``: shared-memory bytes of a CTA;
    ``ctas``: one per row; ``opt_in``: whether the launch asks for more than
    the 48 KB a CTA has by default.
    """
    tile: int
    tiles: int
    halo: int
    smem: int
    ctas: int
    opt_in: bool


def cpe_plan(rows, npil, cpe_avg, npts=None):
    """The :class:`CpePlan` of B5 on the host (mirrored by ``qtt_cpe_plan``).

    ``npts`` (the averages) defaults to the pilot chain's npil - cpe_avg + 1.
    The CTA's shared memory holds the halo and a tile of unwrapped phases,
    the tile's phases and then its averages (one more than a tile, rounded up
    to 4) and the scan's 32 warp sums: no opt-in up to cpe_avg 8,156, and a
    plan past 227 KB (cpe_avg above 53,980) is refused by the launcher.
    """
    if npts is None:
        npts = npil - cpe_avg + 1
    halo = -(-cpe_avg // 4) * 4
    smem = 4 * (halo + 2 * CPE_TILE + 4 + 32)
    return CpePlan(CPE_TILE, -(-(npts + cpe_avg - 1) // CPE_TILE), halo, smem, rows,
                   smem > _STATIC_SMEM)


def check_cpe_plan(rows, npil, cpe_avg, npts=None):
    """The plan of a B5 launch; ``KernelLimit`` where its CTA does not fit the shared memory."""
    plan = cpe_plan(rows, npil, cpe_avg, npts)
    if plan.smem > _SMEM_LIMIT:
        raise KernelLimit("kernel B5: a %d-point average needs %d bytes of shared memory, a CTA "
                          "has %d (cpe_avg up to %d)"
                          % (cpe_avg, plan.smem, _SMEM_LIMIT, _SMEM_LIMIT // 4 - 2 * CPE_TILE - 36))
    return plan


@spanned("qtt.B5")
def cpe_coeffs_cuda(symr, symi, pil_r, pil_i, off, stride, n_head, npts, dx, cpe_avg, nbt):
    """Launch kernel B5; same contract as :func:`cpe_coeffs_plain`, any number of pilots."""
    _build.require_cuda("cpe_coeffs_cuda", symr, symi, pil_r, pil_i, dtype=torch.float32)
    npil = _check_cpe(symr, symi, pil_r, pil_i, off, stride, n_head, npts, cpe_avg, nbt)
    rows = symr.shape[0]
    plan = check_cpe_plan(rows, npil, int(cpe_avg), int(npts))
    lib = _build.library()
    _check_plan("cpe_plan", plan, lib.qtt_cpe_plan, rows, int(npts), int(cpe_avg))
    a = torch.empty((rows, nbt), dtype=torch.float32, device=symr.device)
    b = torch.empty_like(a)
    rc = lib.qtt_cpe_coeffs(symr.data_ptr(), symi.data_ptr(), rows, symr.shape[1], int(off),
                            int(stride), pil_r.data_ptr(), pil_i.data_ptr(),
                            rows // pil_r.shape[0], npil, int(n_head), int(npts), int(dx),
                            int(cpe_avg), int(nbt), TWO_PI, INV_TWO_PI, a.data_ptr(),
                            b.data_ptr(), _build.stream_of(symr))
    _build.check(rc, "cpe_coeffs_cuda")
    cpe_coeffs_cuda.launches += 1
    return a, b


cpe_coeffs_cuda.launches = 0


def cpe_coeffs(symr, symi, pil_r, pil_i, off, stride, n_head, npts, dx, cpe_avg, nbt):
    """Pilot-CPE phase coefficients: the plain version on CPU tensors, kernel B5 on CUDA."""
    fn = cpe_coeffs_plain if symr.device.type == "cpu" else cpe_coeffs_cuda
    return fn(symr, symi, pil_r, pil_i, off, stride, n_head, npts, dx, cpe_avg, nbt)


# ---------------------------------------------------------------------------
# B6: rotation by a given per-sample phase
# ---------------------------------------------------------------------------

def _check_rotate(er, ei, ph, sign):
    _check_sign(sign)
    if er.shape != ei.shape or er.shape != ph.shape:
        raise ValueError("rotate takes planes and a phase of one shape, got %s, %s, %s"
                         % (tuple(er.shape), tuple(ei.shape), tuple(ph.shape)))


def rotate_plain(er, ei, ph, sign=-1):
    """Plain rotation: (er + j ei) exp(sign j ph), planes in and out."""
    _check_rotate(er, ei, ph, sign)
    return _rotate_planes(er, ei, torch.cos(ph), torch.sin(ph), sign)


@spanned("qtt.B6")
def rotate_cuda(er, ei, ph, sign=-1):
    """Launch kernel B6; same contract as :func:`rotate_plain`."""
    _build.require_cuda("rotate_cuda", er, ei, ph, dtype=torch.float32)
    _check_rotate(er, ei, ph, sign)
    outr = torch.empty_like(er)
    outi = torch.empty_like(ei)
    rc = _build.library().qtt_rotate(er.data_ptr(), ei.data_ptr(), ph.data_ptr(), er.numel(),
                                     int(sign), outr.data_ptr(), outi.data_ptr(),
                                     _build.stream_of(er))
    _build.check(rc, "rotate_cuda")
    rotate_cuda.launches += 1
    return outr, outi


rotate_cuda.launches = 0


def rotate(er, ei, ph, sign=-1):
    """Rotation by a given phase: the plain version on CPU tensors, kernel B6 on CUDA."""
    fn = rotate_plain if er.device.type == "cpu" else rotate_cuda
    return fn(er, ei, ph, sign)


# ---------------------------------------------------------------------------
# B7: pi/2 unwrap and derotation
# ---------------------------------------------------------------------------

#: pi/2 and 2/pi rounded to float32, as the reference kernel holds them
HALF_PI = float(np.float32(np.pi / 2))
INV_HALF_PI = float(np.float32(2 / np.pi))


def quarter_unwrap(ph):
    """u = ph - (pi/2) M: the pi/2 unwrap of a (rows, L) float32 phase.

    M is the inclusive prefix sum in int32 of the jump counts m_i =
    floor(d_i (2/pi) + 0.5), d_i = ph_i - ph_{i-1}, d_0 = 0
    (phase_pallas.py:340-356). Every product and sum is rounded on its own;
    the reference under XLA on the CPU fuses d (2/pi) + 0.5 into one FMA,
    which can count a jump differently within an ulp of an odd multiple of
    pi/4. The integer prefix sum is exact in any order.
    """
    m = torch.floor((ph[..., 1:] - ph[..., :-1]) * INV_HALF_PI + 0.5).to(torch.int32)
    M = torch.cumsum(torch.nn.functional.pad(m, (1, 0)), dim=-1, dtype=torch.int32)
    return ph - HALF_PI * M.to(torch.float32)


def _check_unwrap(er, ei, ph):
    if er.dim() != 2 or er.shape != ei.shape or er.shape != ph.shape:
        raise ValueError("unwrap_derotate takes (rows, L) planes and phase of one shape, got "
                         "%s, %s, %s" % (tuple(er.shape), tuple(ei.shape), tuple(ph.shape)))


def unwrap_derotate_plain(er, ei, ph):
    """Plain unwrap + derotation: (er + j ei) exp(+j u), u = :func:`quarter_unwrap` (ph)."""
    _check_unwrap(er, ei, ph)
    return rotate_plain(er, ei, quarter_unwrap(ph), 1)


#: csrc/phase.cu: threads of a B7 CTA, consecutive samples per thread (16-byte vectors of
#: each plane) and samples of a tile
UNWRAP_THREADS, UNWRAP_ITEMS = 512, 4
UNWRAP_TILE = UNWRAP_ITEMS * UNWRAP_THREADS


class UnwrapPlan(NamedTuple):
    """A B7 launch: ``tiles`` per row of ``UNWRAP_TILE`` samples (a row's first starts up
    to 3 samples before the row, at its first 16-byte aligned sample), ``ctas`` of the grid,
    and the ``scratch`` words (int64) the wrapper zeroes: one ticket per row, then one status
    word per tile."""
    tile: int
    tiles: int
    ctas: int
    scratch: int


def unwrap_plan(rows, L):
    """The :class:`UnwrapPlan` of B7 on (rows, L) planes (csrc/phase.cu ``unwrap_tiles``)."""
    tiles = -(-(L + 3) // UNWRAP_TILE)
    return UnwrapPlan(UNWRAP_TILE, tiles, rows * tiles, rows + rows * tiles)


def unwrap_scratch(rows, L, device):
    """B7's scratch on ``device``: :func:`unwrap_plan`'s words, zeroed (no ticket taken, no
    tile published)."""
    return torch.zeros(unwrap_plan(rows, L).scratch, dtype=torch.int64, device=device)


@spanned("qtt.B7")
def unwrap_derotate_cuda(er, ei, ph):
    """Launch kernel B7; same contract as :func:`unwrap_derotate_plain`.

    One launch: a single-pass scan of the rows' jump counts with decoupled
    look-back, over a scratch of :func:`unwrap_plan` words zeroed here.
    """
    _build.require_cuda("unwrap_derotate_cuda", er, ei, ph, dtype=torch.float32)
    _check_unwrap(er, ei, ph)
    lib = _build.library()
    rows, L = er.shape
    plan = unwrap_plan(rows, L)
    if lib.qtt_unwrap_tiles(L) != plan.tiles:
        raise RuntimeError("unwrap_plan and csrc/phase.cu unwrap_tiles disagree: %d, %d"
                           % (plan.tiles, lib.qtt_unwrap_tiles(L)))
    scratch = unwrap_scratch(rows, L, er.device)
    outr = torch.empty_like(er)
    outi = torch.empty_like(ei)
    rc = lib.qtt_unwrap_derotate(er.data_ptr(), ei.data_ptr(), ph.data_ptr(), rows, L,
                                 HALF_PI, INV_HALF_PI, scratch.data_ptr(), outr.data_ptr(),
                                 outi.data_ptr(), _build.stream_of(er))
    _build.check(rc, "unwrap_derotate_cuda")
    unwrap_derotate_cuda.launches += 1
    return outr, outi


unwrap_derotate_cuda.launches = 0


def unwrap_derotate(er, ei, ph):
    """Unwrap + derotation: the plain version on CPU tensors, kernel B7 on CUDA."""
    fn = unwrap_derotate_plain if er.device.type == "cpu" else unwrap_derotate_cuda
    return fn(er, ei, ph)


# ---------------------------------------------------------------------------
# B8: the fine stage of the two-stage phase search
# ---------------------------------------------------------------------------

def _check_fine(er, ei, ph1, cd, sd):
    if er.dim() != 2 or er.shape != ei.shape or er.shape != ph1.shape:
        raise ValueError("bps_fine takes (nmodes, L) planes and coarse phase of one shape")
    if cd.dim() != 1 or cd.shape != sd.shape:
        raise ValueError("bps_fine takes two (B,) offset tables")


def bps_fine_plain(er, ei, ph1, cd, sd, grid, N, d0f, ddf, bf16_tile=None):
    """Plain fine BPS stage: the per-sample phase (ph1 + d0f) + ddf * idx.

    er/ei/ph1: (nmodes, L) float32; cd/sd, d0f, ddf from
    ``ops.phase.fine_tables``. idx is the argmin over the B offsets of the
    2N-window sums of :func:`ops.phase.bps_fine_distances` at [N, L-N) and
    0 elsewhere, where the phase is ph1 + d0f (phase_pallas.py:587-593).
    ``bf16_tile``: the window sums' type (``ops.phase.select_angle_index``).
    """
    _check_fine(er, ei, ph1, cd, sd)
    idx = phops.select_angle_index(phops.bps_fine_distances(er, ei, ph1, cd, sd, grid), N,
                                   bf16_tile)
    return (ph1 + d0f) + ddf * idx.to(torch.float32)


#: csrc/phase.cu: positions of a B8 run at most (on the analytic grids; on a general
#: alphabet; with slots of one offset)
FINE_MAX_RUN, FINE_MAX_RUN_GEN, FINE_MAX_RUN_NARROW = 8, 8, 4


def _fine_smem(run, chunk, N, npts):
    tile = BPS_THREADS * run
    W = tile + 2 * N - 1
    if chunk == 1:
        return 4 * _bps_slots(max(W, tile), run)
    return 16 * npts + 16 * W + 4 * BPS_CHUNK * _bps_slots(W, run)


def fine_plan(nmodes, L, N, npts=0):
    """The :class:`BpsPlan` of B8 on (nmodes, L) planes with half-window N, on the host.

    B3's run rule from ``FINE_MAX_RUN`` (``FINE_MAX_RUN_GEN`` on a general
    alphabet), the run then halved while the CTA would exceed 227 KB: a
    general alphabet's points as float4, the padded table of ``BPS_CHUNK``
    offsets per slot and the staged samples as float4 [x, y, cos ph1, sin
    ph1]. Where no run fits (half-windows of thousands), ``chunk`` is 1: slots
    of one offset over max(W, tile) samples and nothing else staged, from runs
    of at most ``FINE_MAX_RUN_NARROW``. The number of offsets B does not
    enter. The launcher holds this against ``qtt_bps_fine_plan`` of the built
    library.
    """
    first = _bps_run(nmodes, L, FINE_MAX_RUN_GEN if npts else FINE_MAX_RUN)
    for chunk in (BPS_CHUNK, 1):
        run = first if chunk > 1 else min(first, FINE_MAX_RUN_NARROW)
        while _fine_smem(run, chunk, N, npts) > _SMEM_LIMIT and run > 1:
            run //= 2
        smem = _fine_smem(run, chunk, N, npts)
        if smem <= _SMEM_LIMIT:
            break
    tile = BPS_THREADS * run
    return BpsPlan(run, tile, chunk, smem, nmodes * -(-L // tile))


@spanned("qtt.B8")
def bps_fine_cuda(er, ei, ph1, cd, sd, grid, N, d0f, ddf, points=None, bf16_tile=None):
    """Launch kernel B8; same contract as :func:`bps_fine_plain` (``points``: as for B3)."""
    _build.require_cuda("bps_fine_cuda", er, ei, ph1, cd, sd, dtype=torch.float32)
    _check_fine(er, ei, ph1, cd, sd)
    if cd.shape[0] < 1 or int(N) < 0:
        raise ValueError("bps_fine_cuda takes B >= 1 offsets and a half-window N >= 0")
    gargs, table = _grid_args(grid, er.device, points, "bps_fine_cuda")
    B, (nmodes, L) = cd.shape[0], er.shape
    if bf16_tile is not None:
        phops.check_bf16_tile(N, bf16_tile)
        T = int(bf16_tile)
        plan = bf16_plan(nmodes, L, int(N), T, gargs[-1], fine=True)
        lib = _build.library()
        _check_bf16_plan(plan, "B8", lib, True, nmodes, L, int(N), gargs[-1], T)
        out = torch.empty_like(ph1)
        rc = lib.qtt_bps_fine_bf16(er.data_ptr(), ei.data_ptr(), ph1.data_ptr(), nmodes, L,
                                   cd.data_ptr(), sd.data_ptr(), B, int(N), T, *gargs,
                                   float(d0f), float(ddf), out.data_ptr(), _build.stream_of(er))
        _build.check(rc, "bps_fine_cuda")
        bps_fine_cuda.launches += 1
        return out
    plan = fine_plan(nmodes, L, int(N), gargs[-1])
    if plan.smem > _SMEM_LIMIT:
        raise KernelLimit("B8 needs %d bytes of shared memory for N=%d, a CTA has %d"
                          % (plan.smem, N, _SMEM_LIMIT))
    lib = _build.library()
    _check_plan("fine_plan", plan, lib.qtt_bps_fine_plan, nmodes, L, int(N), gargs[-1])
    out = torch.empty_like(ph1)
    rc = lib.qtt_bps_fine(er.data_ptr(), ei.data_ptr(), ph1.data_ptr(), nmodes, L,
                          cd.data_ptr(), sd.data_ptr(), B, int(N), *gargs,
                          float(d0f), float(ddf), out.data_ptr(), _build.stream_of(er))
    _build.check(rc, "bps_fine_cuda")
    bps_fine_cuda.launches += 1
    return out


bps_fine_cuda.launches = 0


def bps_fine(er, ei, ph1, cd, sd, grid, N, d0f, ddf, points=None, bf16_tile=None):
    """Fine BPS stage: the plain version on CPU tensors, kernel B8 on CUDA."""
    if er.device.type == "cpu":
        return bps_fine_plain(er, ei, ph1, cd, sd, grid, N, d0f, ddf, bf16_tile)
    return bps_fine_cuda(er, ei, ph1, cd, sd, grid, N, d0f, ddf, points, bf16_tile)


def bps_twostage(er, ei, cos1, sin1, N1, cd, sd, grid, N, d0f, ddf, grid_coarse=None,
                 points=None, bf16_tile=None):
    """Two-stage BPS phase (``bps_phase_twostage_pallas``, phase_pallas.py:483-526).

    B3 on the coarse tables cos1/sin1 (A1 angles over [-pi/4, pi/4)) with
    half-window N1, its phase ph1 = -pi/4 + (pi/2/A1) idx1, then B8 around
    ph1 with half-window N. ``grid_coarse`` gives the coarse stage a grid of
    its own (a general alphabet's fitted grid; cos1/sin1 carry that grid's
    scale); ``points`` is a general alphabet's table for whichever stage
    searches it; ``bf16_tile`` the window sums' type of both stages. Returns
    the per-sample phase, before the unwrap.
    """
    step1 = np.pi / 2 / cos1.shape[0]
    idx1 = bps_search(er, ei, cos1, sin1, grid if grid_coarse is None else grid_coarse, N1,
                      points, bf16_tile)
    ph1 = -np.pi / 4 + step1 * idx1.to(torch.float32)
    return bps_fine(er, ei, ph1, cd, sd, grid, N, d0f, ddf, points, bf16_tile)
