"""Analytic properties of communication signals and constellation construction.

Counterpart of ``qampy_tpu/theory.py``. Constellations, Gray maps and the
shaping probabilities are host numpy: one-time constants that a chain or a
signal turns into device tensors. The analytic SER and BER curves are
torch and take numbers (computed in float32, as the reference's jnp does)
or tensors of any device.
"""
from __future__ import annotations

import numpy as np
import torch

from qampy_tpu_torch.core.special import _t, q_function  # noqa: F401 (theory.q_function)
from qampy_tpu_torch.helpers import dB2lin, normalise_and_center
from qampy_tpu_torch.utils import bin2gray

_erfc = torch.special.erfc


def ser_vs_es_over_n0_qam(snr, M):
    """SER of an M-QAM signal vs Es/N0 in linear units, valid for M > 4 (theory.py:22-29)."""
    e = _erfc(torch.sqrt(3 * _t(snr) / (2 * (M - 1))))
    return 2 * (1 - 1 / np.sqrt(M)) * e - (1 - 2 / np.sqrt(M) + 1 / M) * e ** 2


def ber_vs_evm_qam(evm_dB, M):
    """BER of an M-QAM signal as a function of EVM in dB (theory.py:32-37)."""
    L = np.sqrt(M)
    evm = _t(dB2lin(evm_dB))
    return 2 * (1 - 1 / L) / np.log2(L) * q_function(
        torch.sqrt(3 * np.log2(L) / (L ** 2 - 1) * (2 / (evm * np.log2(M)))))


def ber_vs_es_over_n0_qam(snr, M):
    """BER vs SNR (linear) for M-QAM (theory.py:40-45)."""
    L = np.sqrt(M)
    return 2 * (1 - 1 / L) / np.log2(L) * q_function(
        torch.sqrt(3 * np.log2(L) / (L ** 2 - 1) * (2 * _t(snr) / np.log2(M))))


def ser_vs_es_over_n0_psk(snr, M):
    """SER of an M-PSK signal vs Es/N0 in linear units (theory.py:48-50)."""
    return _erfc(torch.sqrt(_t(snr)) * np.sin(np.pi / M))


def ser_vs_es_over_n0_4pam(snr):
    """SER of a 4-PAM signal vs Es/N0 in linear units (theory.py:53-55)."""
    return 0.75 * _erfc(torch.sqrt(_t(snr) / 5))


def cal_symbols_qam(M):
    """Constellation points for M-QAM (square or cross, reference theory.py:111-118)."""
    if np.log2(M) % 2 > 0.5:
        return cal_symbols_cross_qam(M)
    return cal_symbols_square_qam(M)


def cal_symbols_square_qam(M):
    """Square M-QAM constellation (reference theory.py:151-158)."""
    L = int(np.sqrt(M))
    side = np.linspace(-(L - 1), L - 1, L)
    re, im = np.meshgrid(side, side, indexing="ij")
    return (re + 1.j * im).flatten()


def cal_symbols_cross_qam(M):
    """Non-square (cross) M-QAM constellation (reference theory.py:161-178)."""
    N = (np.log2(M) - 1) / 2
    s = 2 ** (N - 1)
    nr = int(2 ** (N + 1))
    ni = int(2 ** N)
    re = np.linspace(-(nr - 1), nr - 1, nr)
    im = np.linspace(-(ni - 1), ni - 1, ni)
    rr, ii = np.meshgrid(re, im, indexing="ij")
    qam = rr + 1.j * ii
    idx1 = (abs(qam.real) > 3 * s) & (abs(qam.imag) > s)
    idx2 = (abs(qam.real) > 3 * s) & (abs(qam.imag) <= s)
    qam[idx1] = np.sign(qam[idx1].real) * (abs(qam[idx1].real) - 2 * s) + 1.j * (
        np.sign(qam[idx1].imag) * (4 * s - abs(qam[idx1].imag)))
    qam[idx2] = np.sign(qam[idx2].real) * (4 * s - abs(qam[idx2].real)) + 1.j * (
        np.sign(qam[idx2].imag) * (abs(qam[idx2].imag) + 2 * s))
    return qam.flatten()


def cal_symbols_psk(M):
    """M-PSK constellation of unit power; QPSK turned by pi/4 (theory.py:92-96)."""
    if M == 4:
        return np.exp(1j * (np.arange(M) * 2 * np.pi / M + np.pi / M))
    return np.exp(2j * np.arange(M) * np.pi / M)


def cal_scaling_factor_qam(M):
    """Scaling factor normalising M-QAM symbols to unit power (reference theory.py:139-149)."""
    bits = np.log2(M)
    if not bits % 2:
        return 2 / 3 * (M - 1)
    symbols = cal_symbols_qam(M)
    return (abs(symbols) ** 2).mean()


def gray_code_qam(M):
    """Gray code map for M-QAM constellations (reference theory.py:181-193)."""
    Nbits = int(np.log2(M))
    if Nbits % 2 == 0:
        N = Nbits // 2
        idx = np.mgrid[0:2 ** N:1, 0:2 ** N:1]
    else:
        N = (Nbits - 1) // 2
        idx = np.mgrid[0:2 ** (N + 1):1, 0:2 ** N:1]
    gidx = bin2gray(idx)
    return ((gidx[0] << N) | gidx[1]).flatten()


def cal_ps_probablts(symbols, nu):
    """Maxwell-Boltzmann probabilities of the real levels of ``symbols`` (theory.py:121-128)."""
    symbs = np.unique(np.asarray(symbols).real)
    w = np.exp(-nu * np.abs(symbs) ** 2)
    return symbs, w / w.sum()


def generate_ps_symbols(N, symbs, px, normalize=True, seed=None):
    """Probabilistically shaped symbols (theory.py:131-138), host numpy.

    The draws are numpy's ``default_rng(seed)``, the reference's own, so
    they are the same; the normalisation runs on complex64, as the
    reference's runs on its float32 device array.
    """
    rng = np.random.default_rng(seed)
    out = rng.choice(symbs, N, p=px) + 1j * rng.choice(symbs, N, p=px)
    if normalize:
        out = normalise_and_center(torch.as_tensor(out.astype(np.complex64))).numpy()
    return out


def hybrid_qam_ber_vs_esn0(snr, pr, fr, M1, M2):
    """BER vs SNR (dB) of time-domain hybrid QAM (theory.py:141-148)."""
    snr = 10 ** (np.asarray(snr) / 10)
    bps1, bps2 = np.log2(M1), np.log2(M2)
    return 1 / ((1 - fr) * bps1 + fr * bps2) * (
        (1 - fr) * bps1 * ber_vs_es_over_n0_qam(snr / ((1 - fr) + fr * pr), M1)
        + fr * bps2 * ber_vs_es_over_n0_qam(pr * snr / ((1 - fr) + fr * pr), M2))


def cal_gmi(M, snr, N=10 ** 3, seed=0, device="cpu"):
    """Monte-Carlo soft-decision GMI of Gray-coded square M-QAM at ``snr`` dB (theory.py:151-165).

    The noise comes from a ``torch.Generator`` seeded with ``seed`` on
    ``device``: other draws than the reference's ``jax.random``, so the two
    agree in distribution, not in value.
    """
    from qampy_tpu_torch.core.metrics import cal_gmi_mc
    from qampy_tpu_torch.signals import SignalQAMGrayCoded
    s = SignalQAMGrayCoded(M, 1000, nmodes=1, device=device)
    snr_lin = 10 ** (np.atleast_1d(snr) / 10)
    return np.array([float(cal_gmi_mc(s.coded_symbols, float(sl), N, s.bitmap_mtx, seed=seed))
                     for sl in snr_lin])


def sim_mi_mc(symbols, snr, N, seed=0, device="cpu"):
    """Monte-Carlo AWGN mutual information of an alphabet (theory.py:168-177).

    The noise is numpy's ``default_rng(seed)``, as in the reference.
    """
    from qampy_tpu_torch.core.metrics import cal_mi_mc
    symbols = np.asarray(symbols)
    symbols = symbols / np.sqrt(np.mean(abs(symbols) ** 2))
    N0 = 10 ** (-snr / 10)
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal(N) + 1j * rng.standard_normal(N)) * np.sqrt(N0 / 2)
    return float(cal_mi_mc(torch.as_tensor(noise.astype(np.complex64), device=device),
                           torch.as_tensor(symbols.astype(np.complex64), device=device), N0))
