"""Kernels B3 (blind phase search) and B4 (interp-rotate) with their wrappers.

As in ``ops/equaliser_cuda.py``: ``*_cuda`` launches the CUDA kernel of
``csrc/phase.cu`` (and raises on anything but contiguous CUDA tensors),
``*_plain`` is its plain PyTorch version, and the bare name dispatches on
the device of the input. ``*_cuda.launches`` counts kernel launches.

B3 replaces ``qampy_tpu/ops/phase_pallas.py:bps_idx_pallas`` and B4
``interp_rotate_planes_pallas``.
"""
from __future__ import annotations

import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops.phase import bps_idx_planes as bps_search_plain
from qampy_tpu_torch.ops.phase import square_grid

_SMEM_LIMIT = 227 * 1024


# ---------------------------------------------------------------------------
# B3: blind phase search
# ---------------------------------------------------------------------------

def bps_search_cuda(er, ei, cos_t, sin_t, grid, N):
    """Launch kernel B3; same contract as :func:`bps_search_plain`.

    er/ei: (nmodes, L) float32 planes; cos_t/sin_t: (A,) float32 tables
    from ``ops.phase.bps_tables``; ``grid`` a square grid spec.
    Returns int32 (nmodes, L).
    """
    _build.require_cuda("bps_search_cuda", er, ei, cos_t, sin_t, dtype=torch.float32)
    if er.dim() != 2 or er.shape != ei.shape:
        raise ValueError("bps_search_cuda takes two (nmodes, L) planes of one shape")
    if cos_t.dim() != 1 or cos_t.shape != sin_t.shape:
        raise ValueError("bps_search_cuda takes two (A,) angle tables")
    d0, lo, n = square_grid(grid, "bps_search_cuda")
    lib = _build.library()
    A = cos_t.shape[0]
    if lib.qtt_bps_smem(A, N) > _SMEM_LIMIT:
        raise ValueError("%d angles with N=%d exceed one CTA's shared memory" % (A, N))
    nmodes, L = er.shape
    out = torch.empty((nmodes, L), dtype=torch.int32, device=er.device)
    rc = lib.qtt_bps_idx(er.data_ptr(), ei.data_ptr(), nmodes, L, cos_t.data_ptr(),
                         sin_t.data_ptr(), A, int(N), lo / d0, float(n - 1),
                         out.data_ptr(), _build.stream_of(er))
    _build.check(rc, "bps_search_cuda")
    bps_search_cuda.launches += 1
    return out


bps_search_cuda.launches = 0


def bps_search(er, ei, cos_t, sin_t, grid, N):
    """BPS angle-index search: the plain version on CPU tensors, kernel B3 on CUDA."""
    fn = bps_search_plain if er.device.type == "cpu" else bps_search_cuda
    return fn(er, ei, cos_t, sin_t, grid, N)


# ---------------------------------------------------------------------------
# B4: piecewise-linear phase derotation
# ---------------------------------------------------------------------------

def _check_interp(er, ei, a, b, dx, sign):
    if sign not in (1, -1):
        raise ValueError("sign must be +1 or -1, got %r" % (sign,))
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
    c, s = torch.cos(ph), torch.sin(ph)
    if sign > 0:
        return er * c - ei * s, er * s + ei * c
    return er * c + ei * s, ei * c - er * s


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
