"""Adaptive MIMO equalisation: host constants, plain block-LMS trainer, filter.

Counterpart of ``qampy_tpu/ops/equaliser.py``. The host-side constants
(equaliser.py:61-207, 659-696) are numpy. ``train_equaliser_block``
(equaliser.py:414-495) and ``apply_filter_to_signal`` (:509) are written
here in plain PyTorch on float32 [Re rows; Im rows] planes: they are the
plain versions that the CUDA kernels in ``ops/equaliser_cuda.py`` are held
against, and what the chain runs on CPU tensors.

The block trainer implements the blind ``mcma`` and ``cma`` and the
decision-directed ``mddma`` on a square grid (the blind chain's pair, and
the pilot chain's frame-search training). Other methods and grid kinds
raise ``NotImplementedError``: they are ROADMAP items A7 and A4.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qampy_tpu_torch.ops.phase import detect_grid, square_grid
from qampy_tpu_torch.theory import cal_symbols_qam, cal_scaling_factor_qam

#: Decision based equalisation methods (reference core/equalisation/equalisation.py:87)
DECISION_BASED = ("sbd", "mddma", "dd", "sbd_data", "dd_real", "dd_data_real")
#: Non-decision based equalisation methods (:90)
NONDECISION_BASED = ("cma", "cma2", "mcma", "rde", "mrde", "cma_real", "sgncma_real", "sgncma")
#: Real-valued equalisation methods (:93)
REAL_VALUED = ("cma_real", "dd_real", "dd_data_real", "sgncma_real")
#: Data-aided equalisation methods (:96)
DATA_AIDED = ("dd_data_real", "sbd_data")
#: Methods the plain block trainer implements in this port (kernel B1: mcma, mddma)
BLOCK_METHODS = ("mcma", "mddma", "cma")


# ---------------------------------------------------------------------------
# per-method training constants (host-side, static)
# ---------------------------------------------------------------------------

def _cal_Rconstant(M):
    """CMA radius constant (reference core/equalisation/equalisation.py:271-275)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    return np.mean(abs(syms) ** 4) / np.mean(abs(syms) ** 2)


def _cal_Rconstant_complex(M):
    """MCMA complex radius constant (reference :277-281)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    return (np.mean(syms.real ** 4) / np.mean(syms.real ** 2)
            + 1.j * np.mean(syms.imag ** 4) / np.mean(syms.imag ** 2))


def generate_partition_codes_radius(M):
    """RDE partition codebook (reference :338-359): [codes, partition boundaries]."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    codes = np.unique(abs(syms) ** 4 / abs(syms) ** 2)
    parts = codes[:-1] + np.diff(codes) / 2
    return np.hstack([codes, parts])


def generate_symbols_for_eq(method, M, dtype):
    """Per-method constants/symbol arrays (reference :101-136).

    The branches of the slice's blind and decision-directed methods; the
    others (sca, cme, mrde, the real-valued forms) are ROADMAP item A7.
    """
    if method in ("cma", "cma2", "sgncma"):
        return np.atleast_2d(_cal_Rconstant(M) + 0j).astype(dtype)
    if method == "mcma":
        return np.atleast_2d(_cal_Rconstant_complex(M)).astype(dtype)
    if method == "rde":
        return np.atleast_2d(generate_partition_codes_radius(M) + 0j).astype(dtype)
    if method in ("sbd", "mddma", "dd"):
        return np.atleast_2d(cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
    if method in DATA_AIDED:
        raise ValueError("%s is a data-aided method and needs the symbols to be passed" % method)
    if method in DECISION_BASED + NONDECISION_BASED + ("sca", "cme"):
        raise NotImplementedError("constants for method %r are ROADMAP item A7" % method)
    raise ValueError("%s is unknown method" % method)


def _reshape_symbols(symbols, method, M, dtype, nmodes):
    """Normalise the shape of the symbols/constants array (reference :568-594).

    Complex methods only; the real-valued forms are ROADMAP item A7.
    """
    if method in REAL_VALUED:
        raise NotImplementedError("real-valued method %r is ROADMAP item A7" % method)
    if symbols is None or method in NONDECISION_BASED:
        symbols = generate_symbols_for_eq(method, M, dtype)
    symbols = np.asarray(symbols)
    if symbols.ndim == 1 or symbols.shape[0] == 1:
        symbols = np.tile(symbols, (nmodes, 1))
    elif symbols.shape[0] != nmodes:
        raise ValueError(
            "Symbols array is shape {} but signal has {} modes".format(symbols.shape, nmodes))
    return np.atleast_2d(symbols.astype(dtype))


def _init_taps(Ntaps, nmodes, nmodes2, dtype):
    """Identity centre-tap initialisation (reference :364-373)."""
    wxy = np.zeros((nmodes, nmodes2, Ntaps), dtype=dtype)
    for i in range(nmodes):
        wxy[i, i, Ntaps // 2] = 1
    return wxy


def orthogonalizetaps(wx):
    """Y-pol taps orthogonal to X-pol to avoid the CMA singularity (reference :284-309)."""
    return np.conj(np.asarray(wx)[::-1, ::-1])


# ---------------------------------------------------------------------------
# block-LMS trainer
# ---------------------------------------------------------------------------

class ErrSpec(NamedTuple):
    """Host constants of a block-trainer error function.

    ``method`` is "mcma", "cma" or "mddma". For mcma ``consts`` is the
    per-output radius constant as ((Rr, Ri), ...), for cma the per-output
    radius (R, ...); for mddma it is the square grid (d0, lo, n) of the
    analytic decision.
    """
    method: str
    consts: tuple


def err_spec(method, symbols):
    """Build the :class:`ErrSpec` of ``method`` from a host symbols array.

    ``symbols`` is the (nout, k) array of ``_reshape_symbols``: row m holds
    output m's constant (mcma, cma) or constellation (mddma).
    """
    if method not in BLOCK_METHODS:
        raise NotImplementedError(
            "block trainer method %r: only %s are ported; the other methods "
            "are ROADMAP item A7" % (method, BLOCK_METHODS))
    symbols = np.atleast_2d(np.asarray(symbols))
    if method == "mcma":
        return ErrSpec(method, tuple((float(r.real), float(r.imag))
                                     for r in symbols[:, 0]))
    if method == "cma":
        return ErrSpec(method, tuple(float(r.real) for r in symbols[:, 0]))
    return ErrSpec(method, square_grid(detect_grid(symbols[0]), "mddma"))


def mcma_rows(spec, nout):
    """The (Rr, Ri) radius constants of the first ``nout`` outputs of an mcma spec."""
    if len(spec.consts) < nout:
        raise ValueError("mcma constants for %d outputs, the taps have %d"
                         % (len(spec.consts), nout))
    return spec.consts[:nout]


def block_errfn(spec, nout, device):
    """The error function (zr, zi) -> (er, ei) of the block trainer.

    zr/zi: (..., nout, S) filter output. mcma: (R - z^2) z per axis; cma:
    (R - |z|^2) z (equaliser.py:244-249); mddma: (d^2 - z^2) z per axis with
    d the nearest grid level (equaliser_pallas.py:182-185, 281-284).
    """
    if spec.method == "mcma":
        c = torch.tensor(mcma_rows(spec, nout), dtype=torch.float32, device=device)
        cr, ci = c[:, 0:1], c[:, 1:2]
        return lambda zr, zi: ((cr - zr * zr) * zr, (ci - zi * zi) * zi)
    if spec.method == "cma":
        rs = spec.consts[:nout]
        # one radius for every output stays a Python scalar: no host-to-device copy
        r = rs[0] if len(set(rs)) == 1 else torch.tensor(
            rs, dtype=torch.float32, device=device)[:, None]

        def cma(zr, zi):
            d = r - (zr * zr + zi * zi)
            return d * zr, d * zi
        return cma
    d0, lo, n = spec.consts

    def fn(zr, zi):
        dr = lo + d0 * torch.clamp(torch.floor((zr - lo) / d0 + 0.5), 0.0, n - 1.0)
        di = lo + d0 * torch.clamp(torch.floor((zi - lo) / d0 + 0.5), 0.0, n - 1.0)
        return (dr * dr - zr * zr) * zr, (di * di - zi * zi) * zi
    return fn


def training_windows(P, Ts, os, ntaps):
    """The training windows X[k, s] = E[m, s*os + t], k = m*ntaps + t, as planes.

    P: (..., 2*nmodes, L) float32. Returns (Xr, Xi), each (..., nmodes*ntaps, Ts).
    """
    nmodes = P.shape[-2] // 2
    if P.shape[-1] < (Ts - 1) * os + ntaps:
        raise ValueError("capture of %d samples is shorter than the %d training "
                         "windows need" % (P.shape[-1], (Ts - 1) * os + ntaps))
    U = P.unfold(-1, ntaps, os)[..., :Ts, :]             # (..., 2*nmodes, Ts, ntaps)
    X = U.transpose(-1, -2).reshape(*P.shape[:-2], 2, nmodes * ntaps, Ts)
    return X[..., 0, :, :].contiguous(), X[..., 1, :, :].contiguous()


def train_block_planes(P, TrSyms, Niter, os, mu, wx, spec, adaptive=False,
                       block_size=32):
    """Plain block-LMS training on float32 planes.

    Same math as the reference block trainer (equaliser.py:414-495,
    equaliser_pallas.py:376-431): per block of S samples with taps frozen,
    z = W X, the error, W += (mu err) conj(X)^T; with ``adaptive`` the
    aggregated rule 1/mu += e_prev^2 over the sign-flip samples, skipping
    sample 0 of each pass. Taps, mu and the last error carry across blocks.

    P: (..., 2*nmodes, L) float32, any leading batch axes (the pilot chain's
    frame search trains its candidate windows as one batch, where the
    reference vmaps); wx: (nout, nmodes, ntaps) complex64, shared by the batch.
    Returns (err (..., nout, Niter*Ts) complex64, taps (..., nout, nmodes,
    ntaps), mu (..., nout) float32).
    """
    nout, nmodes, ntaps = wx.shape
    batch = P.shape[:-2]
    S = min(int(block_size), int(TrSyms))
    nblocks = int(TrSyms) // S
    Ts = nblocks * S
    Xr, Xi = training_windows(P, Ts, os, ntaps)
    errfn = block_errfn(spec, nout, P.device)
    K = nmodes * ntaps
    wr = wx.real.reshape(nout, K).float().expand(*batch, nout, K).clone()
    wi = wx.imag.reshape(nout, K).float().expand(*batch, nout, K).clone()
    mu_c = torch.full((*batch, nout), mu, dtype=torch.float32, device=P.device)
    prev_r = torch.zeros(*batch, nout, 1, dtype=torch.float32, device=P.device)
    prev_i = torch.zeros_like(prev_r)
    sidx = torch.arange(S, device=P.device)
    errs_r, errs_i = [], []
    for b in range(int(Niter) * nblocks):
        blk = b % nblocks
        xr = Xr[..., blk * S:(blk + 1) * S]
        xi = Xi[..., blk * S:(blk + 1) * S]
        zr = wr @ xr - wi @ xi
        zi = wr @ xi + wi @ xr
        er, ei = errfn(zr, zi)
        errs_r.append(er)
        errs_i.append(ei)
        ger = er * mu_c[..., None]
        gei = ei * mu_c[..., None]
        xrt, xit = xr.transpose(-1, -2), xi.transpose(-1, -2)
        wr = wr + (ger @ xrt + gei @ xit)
        wi = wi + (gei @ xrt - ger @ xit)
        if adaptive:
            pr = torch.cat([prev_r, er[..., :S - 1]], dim=-1)
            pi = torch.cat([prev_i, ei[..., :S - 1]], dim=-1)
            flip = ~((er * pr > 0) & (ei * pi > 0)) & (sidx + blk * S > 0)
            e2 = pr * pr + pi * pi
            mu_c = 1.0 / (1.0 / mu_c + torch.where(flip, e2, 0.0).sum(dim=-1))
            prev_r, prev_i = er[..., S - 1:], ei[..., S - 1:]
    err = torch.complex(torch.cat(errs_r, dim=-1), torch.cat(errs_i, dim=-1))
    w = torch.complex(wr, wi).reshape(*batch, nout, nmodes, ntaps)
    return err, w, mu_c


def _cal_training_symbol_len(os, ntaps, L):
    """Default training length (reference equaliser.py:654)."""
    return int(L // os // ntaps - 1) * int(ntaps)


def train_equaliser_block(E, TrSyms, Niter, os, mu, wx, symbols, method,
                          adaptive=False, block_size=32):
    """Block-LMS training with the reference's contract (equaliser.py:414).

    E: (nmodes, L) complex; ``symbols`` a host array of per-mode constants
    (see ``_reshape_symbols``). Returns (err, wx_out, mu_out).
    """
    return train_block_planes(planes(E), TrSyms, Niter, os, mu, wx,
                              err_spec(method, symbols), adaptive, block_size)


# ---------------------------------------------------------------------------
# filter application
# ---------------------------------------------------------------------------

def planes(E):
    """Stack a complex (nmodes, L) signal into float32 [Re rows; Im rows]."""
    return torch.cat([E.real, E.imag], dim=0).float()


def apply_filter_planes(P, os, wx):
    """Plain strided MIMO FIR on planes: out[j, i] = sum_{k,t} E[k, i*os+t] w[j,k,t].

    P: (2*nmodes, L) float32; wx: (nout, nmodes, ntaps) complex64. Returns
    the (2*nout, Lout) float32 output planes, Lout = (L - ntaps)//os + 1.
    """
    nout, nmodes, ntaps = wx.shape
    Lout = (P.shape[-1] - ntaps) // os + 1
    U = P.unfold(-1, ntaps, os)[:, :Lout]                # (2*nmodes, Lout, ntaps)
    Ur, Ui = U[:nmodes], U[nmodes:]
    wr, wi = wx.real.float(), wx.imag.float()
    outr = (torch.einsum("mlt,jmt->jl", Ur, wr) - torch.einsum("mlt,jmt->jl", Ui, wi))
    outi = (torch.einsum("mlt,jmt->jl", Ur, wi) + torch.einsum("mlt,jmt->jl", Ui, wr))
    return torch.cat([outr, outi], dim=0)


def apply_filter_frames_planes(P, os, wx, offs, frame_len):
    """Plain frame-batched filter: out[i, f, k] = sum_{m,t} E[m, offs[i,f] + k*os + t] w[i,m,t].

    The sum the reference pilot chain forms per frame with nmodes^2 stacked
    virtual inputs and block-diagonal taps (pilot_chain.py:698-715), over
    all frames at once. P: (2*nmodes, L) float32; wx: (nout, nmodes, ntaps)
    complex64; offs: (nout, nframes) int64 window starts, each window of
    (frame_len - 1)*os + ntaps samples inside the capture. Returns
    (2, nout, nframes, frame_len) float32, [Re; Im].
    """
    nout, nmodes, ntaps = wx.shape
    fr_len = (frame_len - 1) * os + ntaps
    idx = offs[..., None] + torch.arange(fr_len, device=P.device)
    U = P[:, idx].unfold(-1, ntaps, os)          # (2*nmodes, nout, nframes, F, ntaps)
    Ur, Ui = U[:nmodes], U[nmodes:]
    wr, wi = wx.real.float(), wx.imag.float()
    outr = (torch.einsum("mifkt,imt->ifk", Ur, wr) - torch.einsum("mifkt,imt->ifk", Ui, wi))
    outi = (torch.einsum("mifkt,imt->ifk", Ur, wi) + torch.einsum("mifkt,imt->ifk", Ui, wr))
    return torch.stack([outr, outi])


def apply_filter_to_signal(E, os, wx):
    """Apply equaliser taps and downsample by os (reference pythran_equalisation.py:37-76).

    E: (nmodes, L) complex; returns (nout, Lout) complex64.
    """
    out = apply_filter_planes(planes(E), os, wx)
    nout = out.shape[0] // 2
    return torch.complex(out[:nout], out[nout:])
