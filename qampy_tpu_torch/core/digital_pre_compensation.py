"""Transmitter pre-compensation (counterpart of ``qampy_tpu/core/digital_pre_compensation.py``).

Clipping, the modulator's arcsine pre-distortion and the symbol-pattern
lookup table on tensors of any device; the inverse DAC response is a filter
design, made on the host with scipy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import scipy.signal as scisig
import torch

from qampy_tpu_torch.core.special import rrcos_freq
from qampy_tpu_torch.ops.phase import to_device
from qampy_tpu_torch.utils import rolling_window

__all__ = ["clipper", "comp_mod_sin", "comp_dac_resp", "find_sym_patterns", "cal_lut_avg",
           "cal_lut"]


def clipper(sig, clipping_level):
    """Clip I and Q each to (-clipping_level, clipping_level), complex out (reference :18-23)."""
    sig = torch.atleast_2d(torch.as_tensor(sig))
    if not sig.is_complex():
        sig = sig.to(torch.complex128 if sig.dtype == torch.float64 else torch.complex64)
    re = torch.sign(sig.real) * torch.clamp(sig.real.abs(), max=clipping_level)
    im = torch.sign(sig.imag) * torch.clamp(sig.imag.abs(), max=clipping_level)
    return torch.complex(re, im)


def comp_mod_sin(sig, vpi=1.14):
    """Arcsine pre-compensation of the modulator's sine response (reference :26-31).

    A real ``vpi`` applies to both quadratures; a complex one gives I its
    real part and Q its imaginary part.
    """
    sig = torch.as_tensor(sig)
    if not np.iscomplexobj(vpi):
        vpi = vpi + 1j * vpi
    vpi = complex(vpi)
    return torch.complex(2 * vpi.real * torch.arcsin(sig.real),
                         2 * vpi.imag * torch.arcsin(sig.imag))


def comp_dac_resp(dpe_fb, sim_len, rrc_beta, PAPR=9, prms_dac=(16e9, 2, 'sos', 6), os=2):
    """The Wiener inverse of a simulated DAC's response over ``sim_len`` bins (reference :34-52).

    A filter design on the host, as in the reference: the RRC spectrum in
    float32 (as the reference forms it), the Bessel DAC's ``sosfreqz`` and
    the Wiener regularisation from the PAPR and the ENOB. Returns the
    complex response (numpy), which multiplies a signal's spectrum.
    """
    dpe_fs = dpe_fb * os
    fre_rrc = np.fft.fftfreq(sim_len) * dpe_fs
    rrc_f = rrcos_freq(fre_rrc, rrc_beta, 1 / dpe_fb).numpy()
    rrc_f = rrc_f / rrc_f.max()
    n_f = rrc_f ** 2
    cutoff, order, frmt, enob = prms_dac
    system_dig = scisig.bessel(order, cutoff, 'low', analog=False, output=frmt, norm='mag',
                               fs=dpe_fs)
    _, d_f = scisig.sosfreqz(system_dig, worN=sim_len, whole=True, fs=dpe_fs)
    df = dpe_fs / sim_len
    alpha = 10 ** (PAPR / 10) / (6 * dpe_fb * 2 ** (2 * enob)) * np.sum(abs(d_f) ** 2 * n_f * df)
    return n_f * np.conj(d_f) / (n_f * abs(d_f) ** 2 + alpha)


def find_sym_patterns(sig, ref_sym, N, ret_ptrns=False):
    """Index of the pattern of N symbols that starts at each sample (reference :55-68).

    Each sample is decided to the nearest of the M symbols of ``ref_sym``;
    the pattern of the N decisions from a sample on (wrapping at the end)
    gets the index sum idx[i] M^(N-1-i), in int64 (256^4 overflows int32).
    With ``ret_ptrns`` also the (M^N, N) host array of each index's symbols.
    """
    sig = torch.as_tensor(sig)
    ref_host = ref_sym.detach().cpu().numpy() if torch.is_tensor(ref_sym) else np.asarray(ref_sym)
    ref = to_device(ref_host, sig.device).to(sig.dtype)
    M = ref_host.size
    sig_idx = torch.argmin((sig[None, :] - ref[:, None]).abs(), dim=0)
    weights = to_device(np.int64(M) ** np.arange(N - 1, -1, -1, dtype=np.int64), sig.device)
    pattern_idx = (rolling_window(sig_idx, N, wrap=True) * weights).sum(-1)
    if ret_ptrns:
        pidx = np.array(np.unravel_index(np.arange(int(M ** N)), N * [int(M)])).T
        return pattern_idx, ref_host[pidx]
    return pattern_idx


def _segment_mean(x, idx, N):
    """The mean of ``x`` over each index 0..N-1 of ``idx`` (0 where an index has none).

    The values are sorted by index (stably) and summed segment by segment,
    each segment in order: no atomics, so two calls on the card are
    bit-equal (``index_add_`` of float32 on the card sums in an order that
    changes from run to run).
    """
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=N)
    sums = torch.segment_reduce(x[order], "sum", lengths=counts, unsafe=True)
    return sums / torch.clamp(counts, min=1).to(x.dtype)


def cal_lut_avg(err, idx_I, idx_Q, N):
    """Mean error per pattern index: real part by ``idx_I``, imaginary by ``idx_Q`` (:71-86).

    The reference accumulates the sums and counts with segment sums; the
    port sums each pattern's errors in a fixed order (:func:`_segment_mean`).
    """
    err = torch.as_tensor(err)
    n = err.numel()
    idx_I = torch.as_tensor(idx_I, device=err.device)[:n].long()
    idx_Q = torch.as_tensor(idx_Q, device=err.device)[:n].long()
    return torch.complex(_segment_mean(err.real, idx_I, N), _segment_mean(err.imag, idx_Q, N))


def cal_lut(tx_sig, rx_sig, ref_sym, mem_len=3, idx_data=None, real_ptrns=True):
    """A lookup table of the mean error per symbol pattern, for 1-d signals (reference :89-117).

    With ``real_ptrns`` the I and Q patterns are indexed apart, over the
    real and imaginary levels of ``ref_sym``; else the complex patterns.
    ``idx_data`` (a host mask) selects the samples the table learns from.
    Returns (table, idx_I, idx_Q).
    """
    tx_sig, rx_sig = torch.as_tensor(tx_sig), torch.as_tensor(rx_sig)
    if tx_sig.dim() != 1 or rx_sig.dim() != 1:
        raise ValueError("Only 1d signals are supported")
    if tx_sig.shape != rx_sig.shape:
        raise ValueError("Tx and Rx signal need to have the same shape")
    L = tx_sig.shape[-1]
    if idx_data is None:
        idx_data = np.ones(L, dtype=bool)
    pos = np.nonzero(np.asarray(idx_data))[0]
    err = (tx_sig - rx_sig).index_select(0, to_device(pos, tx_sig.device))
    idx = to_device((pos - mem_len // 2) % L, tx_sig.device)
    ref_host = np.asarray(ref_sym.cpu() if torch.is_tensor(ref_sym) else ref_sym)
    if real_ptrns:
        ref_I, ref_Q = np.unique(ref_host.real), np.unique(ref_host.imag)
        N = int(ref_I.size ** mem_len)
        idx_I = find_sym_patterns(tx_sig.real, ref_I, mem_len)[idx]
        idx_Q = find_sym_patterns(tx_sig.imag, ref_Q, mem_len)[idx]
        return cal_lut_avg(err, idx_I, idx_Q, N), idx_I, idx_Q
    N = int(ref_host.size ** mem_len)
    idx_c = find_sym_patterns(tx_sig, np.unique(ref_host), mem_len)[idx]
    return cal_lut_avg(err, idx_c, idx_c, N), idx_c, idx_c
