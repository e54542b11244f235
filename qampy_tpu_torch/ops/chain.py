"""The blind RX chain (counterpart of ``qampy_tpu/ops/chain.py``).

``make_rx_chain`` returns an :class:`RxChain` module running the reference's
blind receiver on float32 [Re rows; Im rows] planes. Every mode starts with

1. two adaptive block-LMS trainings on the TrSyms prefix (MCMA, then MDDMA),
   with the CMA singularity guard between them (kernel B1);
2. the strided MIMO filter over the whole capture (kernel B2);

and then recovers the carrier phase in one of three ways:

- ``decimated[K]``: the blind phase search on the filter's stride-K side
  output (B3), the decimated pi/2 unwrap and per-block (a, b) coefficients
  (plain tensor ops, :func:`decimated_derotation_inputs`), and the
  full-rate piecewise-linear derotation (B4);
- ``single`` (the reference's default): the search over all bps_angles on
  every sample (B3), its phase -pi/4 + (pi/2/A) idx, then the pi/2 unwrap
  and derotation (B7);
- ``twostage``/``twostage32``: a coarse search over max(A/4, 16) (or
  max(A/2, 16)) angles with half-window 60 (B3), the fine search over 8
  per-sample offsets with half-window bps_N (B8), then B7.

A ``decimated[K]`` whose K does not divide the filter's phase group falls
back to ``single`` with the reference's warning. On CPU tensors each kernel
runs its plain PyTorch version; on CUDA tensors the kernels run, with no
fallback. The two trainings take the methods of kernel B1 (cma, sgncma,
mcma, rde, sbd, mddma, dd) on a square grid; anything else raises
``NotImplementedError``, for a grid naming the ROADMAP item that brings it.

Two divergences from the reference, both toward float32: the filter sums
in float32 (the reference chain contracts in bf16) and the BPS windows are
summed in float32 (the reference chain defaults to ``bps_win="bf16"``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.equaliser_cuda import apply_filter, check_dec, train_block
from qampy_tpu_torch.ops.phase_cuda import bps_search, bps_twostage, interp_rotate, unwrap_derotate
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.utils import resolve_device

#: the coarse stage's half-window of the two-stage search (reference chain.py:410-416)
TWOSTAGE_N1 = 60
#: per-sample offsets of the fine stage (reference chain.py:414)
TWOSTAGE_B = 8

__all__ = ["RxChain", "make_rx_chain", "decimated_derotation_inputs", "cma_singularity_guard"]

_HALF_PI = float(np.float32(np.pi / 2))


def decimated_derotation_inputs(eqr, eqi, idxd, lo_a, step_a, dec):
    """The tensor glue between the phase search and the derotation (chain.py:349-369).

    idxd: (nmodes, Ld) int32 best-angle indices on the decimated grid. The
    decimated phase lo_a + step_a*idx gets a pi/2 unwrap (floor(x+0.5)
    jump counts, cumulated); block j of dec full-rate samples then takes
    a = phu[j], b = (phu[j+1] - phu[j])/dec, with the last slope 0. The
    (nmodes, Lout) filter planes are zero-padded to Ld*dec samples.
    Returns (er_pad, ei_pad, a, b).
    """
    phd = lo_a + step_a * idxd.to(torch.float32)
    dph = phd[:, 1:] - phd[:, :-1]
    corr = -_HALF_PI * torch.floor(dph / _HALF_PI + 0.5)
    phu = phd + torch.cumsum(F.pad(corr, (1, 0)), dim=-1)
    b_blk = F.pad(phu[:, 1:] - phu[:, :-1], (0, 1)) / dec
    pad = phu.shape[-1] * dec - eqr.shape[-1]
    return F.pad(eqr, (0, pad)), F.pad(eqi, (0, pad)), phu, b_blk


def cma_singularity_guard(w):
    """Re-initialise tap row 1 orthogonal to row 0 when both rows converged onto one source.

    The CMA polarisation-demux singularity guard between the two trainings
    (reference chain.py:255-270, Liu et al. OFC'09): when the stage-1 rows
    of the dual-pol taps ``w`` (2, 2, Ntaps) are nearly parallel, row 1
    becomes conj(w[0][::-1, ::-1]) and stage 2 retrains it. A tensor
    select, with no host round trip.
    """
    f0, f1 = w[0].reshape(-1), w[1].reshape(-1)
    inner = torch.abs(torch.vdot(f0, f1))
    n01 = torch.sqrt(torch.sum(torch.abs(f0) ** 2) * torch.sum(torch.abs(f1) ** 2))
    orth = torch.conj_physical(w[0].flip(0, 1))[None]
    return torch.where(inner > 0.9 * n01, torch.cat([w[:1], orth]), w)


class RxChain(nn.Module):
    """Blind dual-pol receiver in one of the carrier-recovery modes of the module docstring.

    Build it with :func:`make_rx_chain`. Entries, as in the reference:
    ``forward(E)`` (complex in and out), ``planes(P)`` ((outr, outi) from
    stacked float32 planes), ``with_taps``/``planes_with_taps`` (also return
    the frozen taps) and ``tracking``/``tracking_planes`` (demodulate with
    given taps, skipping both trainings). ``mode`` is "decimated" (with
    stride ``dec``), "single" or "twostage"; ``bps_cos``/``bps_sin`` hold
    the angle tables of the one B3 search a call runs (the coarse grid in
    twostage, whose fine offsets are ``fine_cos``/``fine_sin``).
    """

    def __init__(self, M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3,
                 bps_angles=64, bps_N=14, block_size=256, TrSyms=None,
                 bps_mode="single", symbols=None):
        super().__init__()
        if symbols is not None:
            raise NotImplementedError("custom symbol alphabets are ROADMAP item A4b")
        if len(methods) != 2:
            raise ValueError("the chain trains two stages, got methods=%r" % (methods,))
        dtype = np.complex64
        self.specs = tuple(eqops.err_spec(m, eqops._reshape_symbols(None, m, M, dtype, 2))
                           for m in methods)
        const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
        self.grid = phops.detect_grid(const)
        phops.square_grid(self.grid, "rx chain")
        self.Ntaps, self.os, self.mu = int(Ntaps), int(os), float(mu)
        self.bps_N, self.block_size, self.TrSyms = int(bps_N), int(block_size), TrSyms
        self.mode, self.dec = self._resolve_mode(bps_mode)
        A = bps_angles
        if self.mode == "twostage":
            A = max(bps_angles // (2 if bps_mode.endswith("32") else 4), 16)
        self.search_N = TWOSTAGE_N1 if self.mode == "twostage" else self.bps_N
        angles = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
        self.step_a, self.lo_a = float(np.pi / 2 / A), float(-np.pi / 4)
        cos_h, sin_h = phops.bps_tables(angles, self.grid)
        self.register_buffer("w0", torch.as_tensor(eqops._init_taps(Ntaps, 2, 2, dtype)))
        self.register_buffer("bps_cos", torch.as_tensor(cos_h))
        self.register_buffer("bps_sin", torch.as_tensor(sin_h))
        if self.mode == "twostage":
            cd, sd, self.fine_d0, self.fine_step = phops.fine_tables(A, TWOSTAGE_B, self.grid)
            self.register_buffer("fine_cos", torch.as_tensor(cd))
            self.register_buffer("fine_sin", torch.as_tensor(sd))

    def _resolve_mode(self, bps_mode):
        """(mode, decimation stride or None) of a ``bps_mode`` name (reference chain.py:280-292)."""
        if bps_mode == "twostage-dec":
            raise NotImplementedError(
                "bps_mode='twostage-dec' is on ROADMAP's 'Not to port' list (a measured "
                "dead end of the reference)")
        if bps_mode.startswith("twostage"):
            return "twostage", None
        if bps_mode == "single":
            return "single", None
        if not bps_mode.startswith("decimated"):
            raise ValueError("unknown bps_mode %r: 'single', 'twostage', 'twostage32' or "
                             "'decimated[K]'" % (bps_mode,))
        dec = int(bps_mode[len("decimated"):] or 8)
        if dec < 1:
            raise ValueError("bps_mode=%r: the decimation stride must be positive" % (bps_mode,))
        try:
            check_dec(self.os, self.Ntaps, 2, dec)
        except ValueError as e:
            warnings.warn("bps_mode=%r needs a phase group divisible by the stride (%s); "
                          "falling back to the single-grid BPS" % (bps_mode, e), stacklevel=4)
            return "single", None
        return "decimated", dec

    # -- stages -------------------------------------------------------------

    def train_taps(self, P):
        """Both blind trainings on the TrSyms prefix: the frozen (nmodes, nmodes, Ntaps) taps."""
        nmodes = P.shape[0] // 2
        trs = (P.shape[-1] - self.Ntaps) // self.os if self.TrSyms is None else self.TrSyms
        s1, s2 = self.specs
        _, w1, _ = train_block(P, trs, 1, self.os, self.mu, self.w0[:nmodes, :nmodes], s1,
                               adaptive=True, block_size=self.block_size)
        if nmodes == 2:
            w1 = cma_singularity_guard(w1)
        _, w2, _ = train_block(P, trs, 1, self.os, self.mu, w1, s2,
                               adaptive=True, block_size=self.block_size)
        return w2

    def equalise(self, P, w):
        """Filter the capture: (full-rate planes, stride-dec planes, or None outside decimated)."""
        if self.dec is None:
            return apply_filter(P, self.os, w), None
        return apply_filter(P, self.os, w, self.dec)

    def phase_search(self, x):
        """B3's best-angle indices (nmodes, L) on planes ``x`` (the decimated ones in decimated).

        Over the chain's angle table with half-window ``search_N``.
        """
        no = x.shape[0] // 2
        return bps_search(x[:no], x[no:], self.bps_cos, self.bps_sin, self.grid, self.search_N)

    def derotate(self, eqp, idxd):
        """Unwrap the decimated phase and derotate the full-rate planes: (outr, outi)."""
        no = eqp.shape[0] // 2
        Lout = eqp.shape[-1]
        er, ei, a, b = decimated_derotation_inputs(eqp[:no], eqp[no:], idxd, self.lo_a,
                                                   self.step_a, self.dec)
        outr, outi = interp_rotate(er, ei, a, b, self.dec, sign=1)
        return outr[:, :Lout], outi[:, :Lout]

    def carrier_phase(self, eqp):
        """The per-sample phase (nmodes, L) of the single and twostage modes, before the unwrap.

        single: lo + step idx of B3's indices (reference chain.py:441);
        twostage: B3 on the coarse grid, then B8 (chain.py:412-418).
        """
        if self.mode == "single":
            return self.lo_a + self.step_a * self.phase_search(eqp).to(torch.float32)
        no = eqp.shape[0] // 2
        return bps_twostage(eqp[:no], eqp[no:], self.bps_cos, self.bps_sin, self.search_N,
                            self.fine_cos, self.fine_sin, self.grid, self.bps_N, self.fine_d0,
                            self.fine_step)

    def unwrap_derotate(self, eqp, ph):
        """pi/2-unwrap the per-sample phase, derotate the full-rate planes (B7): (outr, outi)."""
        no = eqp.shape[0] // 2
        return unwrap_derotate(eqp[:no], eqp[no:], ph)

    def _fwd(self, P, w=None):
        if P.is_complex() or P.dim() != 2 or P.shape[0] % 2:
            raise ValueError("expected stacked float32 [Re rows; Im rows] planes, got %s %s"
                             % (P.dtype, tuple(P.shape)))
        P = P.to(torch.float32).contiguous()
        w2 = self.train_taps(P) if w is None else w
        eqp, decp = self.equalise(P, w2)
        if self.mode == "decimated":
            return self.derotate(eqp, self.phase_search(decp)), w2
        return self.unwrap_derotate(eqp, self.carrier_phase(eqp)), w2

    # -- entries --------------------------------------------------------------

    @staticmethod
    def _stack(P, Pi):
        return P if Pi is None else torch.cat([P, Pi], dim=0)

    def forward(self, E):
        """Complex (nmodes, L) capture at ``os`` samples/symbol in, recovered symbols out."""
        (outr, outi), _ = self._fwd(eqops.planes(E))
        return torch.complex(outr, outi)

    def planes(self, P, Pi=None):
        """Planes entry: (2*nmodes, L) float32 [Re; Im] (or a (pr, pi) pair) -> (outr, outi)."""
        return self._fwd(self._stack(P, Pi))[0]

    def with_taps(self, E):
        """``forward`` that also returns the frozen (nmodes, nmodes, Ntaps) taps."""
        (outr, outi), w = self._fwd(eqops.planes(E))
        return torch.complex(outr, outi), w

    def planes_with_taps(self, P, Pi=None):
        """``planes`` that also returns the frozen taps."""
        return self._fwd(self._stack(P, Pi))

    def tracking(self, E, wxy):
        """Warm-start entry: demodulate with given taps, skipping both trainings."""
        (outr, outi), _ = self._fwd(eqops.planes(E), wxy)
        return torch.complex(outr, outi)

    def tracking_planes(self, P, wxy, Pi=None):
        """Planes twin of :meth:`tracking`."""
        return self._fwd(self._stack(P, Pi), wxy)[0]


def make_rx_chain(M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3,
                  bps_angles=64, bps_N=14, block_size=256, TrSyms=None,
                  bps_mode="single", symbols=None, device=None):
    """Build the blind RX chain on ``device`` (see :class:`RxChain`).

    ``device=None`` is the card, and raises on a machine without one; pass
    ``device="cpu"`` for the CPU.

    Parameters follow the reference's ``make_rx_chain``; its backend
    switches (``pallas``, ``bps_tile``, ``bps_win``, ``fuse_derot``) have
    no counterpart here.
    """
    return RxChain(M=M, Ntaps=Ntaps, os=os, methods=methods, mu=mu,
                   bps_angles=bps_angles, bps_N=bps_N, block_size=block_size,
                   TrSyms=TrSyms, bps_mode=bps_mode, symbols=symbols).to(resolve_device(device))
