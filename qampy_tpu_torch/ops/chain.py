"""The blind RX chain in ``decimated[K]`` mode (counterpart of ``qampy_tpu/ops/chain.py``).

``make_rx_chain`` returns an :class:`RxChain` module running the reference's
blind receiver on float32 [Re rows; Im rows] planes:

1. two adaptive block-LMS trainings on the TrSyms prefix (MCMA, then MDDMA),
   with the CMA singularity guard between them (kernel B1);
2. the strided MIMO filter over the whole capture with its stride-``dec``
   side output (kernel B2);
3. the blind phase search on the decimated samples (kernel B3);
4. the decimated pi/2 unwrap and the per-block (a, b) phase coefficients
   (plain tensor ops, :func:`decimated_derotation_inputs`);
5. the full-rate piecewise-linear derotation (kernel B4).

On CPU tensors each kernel runs its plain PyTorch version; on CUDA tensors
the kernels run, with no fallback. Only the ``decimated[K]`` mode on a
square grid with the ``mcma``/``mddma`` pair is ported: anything else
raises ``NotImplementedError`` naming the ROADMAP item that brings it.

Two divergences from the reference, both toward float32: the filter sums
in float32 (the reference chain contracts in bf16) and the BPS windows are
summed in float32 (the reference chain defaults to ``bps_win="bf16"``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.equaliser_cuda import apply_filter, check_dec, train_block
from qampy_tpu_torch.ops.phase_cuda import bps_search, interp_rotate
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam

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
    """Blind dual-pol receiver, ``decimated[K]`` carrier recovery.

    Build it with :func:`make_rx_chain`. Entries, as in the reference:
    ``forward(E)`` (complex in and out), ``planes(P)`` ((outr, outi) from
    stacked float32 planes), ``with_taps``/``planes_with_taps`` (also return
    the frozen taps) and ``tracking``/``tracking_planes`` (demodulate with
    given taps, skipping both trainings).
    """

    def __init__(self, M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3,
                 bps_angles=64, bps_N=12, block_size=256, TrSyms=None,
                 bps_mode="decimated16", symbols=None):
        super().__init__()
        if symbols is not None:
            raise NotImplementedError("custom symbol alphabets are ROADMAP item A4")
        if not bps_mode.startswith("decimated"):
            raise NotImplementedError(
                "bps_mode=%r: only 'decimated[K]' is ported; 'single' and 'twostage' "
                "are ROADMAP item A4 (kernels B7, B8)" % (bps_mode,))
        self.dec = int(bps_mode[len("decimated"):] or 8)
        if self.dec < 1:
            raise ValueError("bps_mode=%r: the decimation stride must be positive" % (bps_mode,))
        if len(methods) != 2:
            raise ValueError("the chain trains two stages, got methods=%r" % (methods,))
        dtype = np.complex64
        self.specs = tuple(eqops.err_spec(m, eqops._reshape_symbols(None, m, M, dtype, 2))
                           for m in methods)
        const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
        self.grid = phops.detect_grid(const)
        phops.square_grid(self.grid, "rx chain")
        self.Ntaps, self.os, self.mu = int(Ntaps), int(os), float(mu)
        try:
            check_dec(self.os, self.Ntaps, 2, self.dec)
        except ValueError as e:
            raise NotImplementedError(
                "%s; the reference falls back to the single-grid search there, "
                "which is ROADMAP item A4" % e) from None
        self.bps_N, self.block_size, self.TrSyms = int(bps_N), int(block_size), TrSyms
        angles = np.linspace(-np.pi / 4, np.pi / 4, bps_angles, endpoint=False,
                             dtype=np.float32)
        self.step_a, self.lo_a = float(np.pi / 2 / bps_angles), float(-np.pi / 4)
        cos_h, sin_h = phops.bps_tables(angles, self.grid)
        self.register_buffer("w0", torch.as_tensor(eqops._init_taps(Ntaps, 2, 2, dtype)))
        self.register_buffer("bps_cos", torch.as_tensor(cos_h))
        self.register_buffer("bps_sin", torch.as_tensor(sin_h))

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
        """Filter the capture: (full-rate planes, stride-dec planes)."""
        return apply_filter(P, self.os, w, self.dec)

    def phase_search(self, decp):
        """Best-angle indices (nmodes, Ld) on the decimated planes."""
        no = decp.shape[0] // 2
        return bps_search(decp[:no], decp[no:], self.bps_cos, self.bps_sin, self.grid,
                          self.bps_N)

    def derotate(self, eqp, idxd):
        """Unwrap the decimated phase and derotate the full-rate planes: (outr, outi)."""
        no = eqp.shape[0] // 2
        Lout = eqp.shape[-1]
        er, ei, a, b = decimated_derotation_inputs(eqp[:no], eqp[no:], idxd, self.lo_a,
                                                   self.step_a, self.dec)
        outr, outi = interp_rotate(er, ei, a, b, self.dec, sign=1)
        return outr[:, :Lout], outi[:, :Lout]

    def _fwd(self, P, w=None):
        if P.is_complex() or P.dim() != 2 or P.shape[0] % 2:
            raise ValueError("expected stacked float32 [Re rows; Im rows] planes, got %s %s"
                             % (P.dtype, tuple(P.shape)))
        P = P.to(torch.float32).contiguous()
        w2 = self.train_taps(P) if w is None else w
        eqp, decp = self.equalise(P, w2)
        return self.derotate(eqp, self.phase_search(decp)), w2

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
                  bps_angles=64, bps_N=12, block_size=256, TrSyms=None,
                  bps_mode="decimated16", symbols=None, device="cpu"):
    """Build the blind RX chain on ``device`` (see :class:`RxChain`).

    Parameters follow the reference's ``make_rx_chain``; its backend
    switches (``pallas``, ``bps_tile``, ``bps_win``, ``fuse_derot``) have
    no counterpart here.
    """
    return RxChain(M=M, Ntaps=Ntaps, os=os, methods=methods, mu=mu,
                   bps_angles=bps_angles, bps_N=bps_N, block_size=block_size,
                   TrSyms=TrSyms, bps_mode=bps_mode, symbols=symbols).to(device)
