"""Constellation construction (counterpart of ``qampy_tpu/theory.py:58-119``).

Host-side numpy: these are one-time constants that the chain turns into
device buffers when it is built.
"""
from __future__ import annotations

import numpy as np

from qampy_tpu_torch.utils import bin2gray


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


def cal_scaling_factor_qam(M):
    """Scaling factor normalising M-QAM symbols to unit average power (reference theory.py:139-149)."""
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
