"""Signal quality metrics: decisions, SNR, EVM, L-values, GMI and MI.

Counterpart of ``qampy_tpu/core/metrics.py``, plain PyTorch on tensors of
any device (the reference left these to XLA). Each keeps the reference's
form: decisions expand the distance as |s|^2 - 2 Re(E conj(s)) (|E|^2 does
not move the argmin), ``estimate_snr`` sums per constellation point by
the transmitted symbol's index, the soft demappers work through 2^16
samples at a time. A function that returns a number returns a 0-d tensor
on the input's device, so a caller that reads it synchronises once.
"""
from __future__ import annotations

import numpy as np
import torch

from qampy_tpu_torch.helpers import cabssquared
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.utils import as_tensor as _tensor

#: samples per step of the chunked metrics (metrics.py:132)
CHUNK = 2 ** 16


def _neg2re_cross(E, symbols):
    """|s|^2 - 2 Re(E conj(s)) for every pair: (..., N, M) real (metrics.py:27-37)."""
    Er = torch.stack([E.real, E.imag], dim=-1)                  # (..., N, 2)
    S = torch.stack([symbols.real, symbols.imag]).to(Er.dtype)  # (2, M)
    return cabssquared(symbols).to(Er.dtype) - 2 * (Er @ S)


def decision_idx(E, symbols):
    """Index of the nearest constellation point for every sample (metrics.py:40-46).

    E: (..., N) complex; symbols: (M,) complex on E's device. Returns int32
    (..., N); the first of equal distances wins.
    """
    return torch.argmin(_neg2re_cross(E, symbols), dim=-1).to(torch.int32)


def make_decision(E, symbols):
    """Nearest-symbol decision along the last axis: (symbols, |E - symbol|, indices).

    Reference metrics.py:49-60.
    """
    E = _tensor(E)
    symbols = _tensor(symbols, E.device)
    idx = decision_idx(E, symbols)
    det = symbols[idx.long()]
    return det, (E - det).abs(), idx


def det_symbol(X, symbs):
    """One sample's decision: (symbol, squared distance) (metrics.py:63-72)."""
    X = _tensor(X)
    symbs = _tensor(symbs, X.device)
    d = cabssquared(X - symbs)
    j = torch.argmin(d)
    return symbs[j], d[j]


def generate_bitmapping_mtx(coded_symbs, coded_bits, M, dtype=np.complex64):
    """The soft demapper's bit map (metrics.py:75-89), host numpy.

    Returns (num_bits, M/2, 2): bit_map[b, :, v] are the points whose bit b is v.
    """
    coded_symbs = np.asarray(coded_symbs)
    num_bits = int(np.log2(M))
    out_mtx = np.reshape(np.asarray(coded_bits), (M, num_bits))
    bit_map = np.zeros([num_bits, int(M / 2), 2], dtype=dtype)
    for bit in range(num_bits):
        bit_map[bit, :, 0] = coded_symbs[~out_mtx[:, bit]]
        bit_map[bit, :, 1] = coded_symbs[out_mtx[:, bit]]
    return bit_map


def estimate_snr(signal_rx, symbols_tx, gray_symbols):
    """Data-aided SNR from the statistics of each constellation point's cluster (metrics.py:92-119).

    signal_rx and symbols_tx: (..., L); gray_symbols: (M,). Each received
    sample joins the cluster of its transmitted symbol's index; per cluster
    the share, mean and variance give S0 = sum P |mu|^2 and N0 = sum P var.
    Returns (snr, S0, N0) in linear units, each of the leading shape.
    """
    signal_rx = _tensor(signal_rx)
    dev = signal_rx.device
    gray = _tensor(gray_symbols, dev)
    seg = decision_idx(_tensor(symbols_tx, dev), gray).long()
    M, L = gray.shape[0], signal_rx.shape[-1]
    rdt = signal_rx.real.dtype
    z = torch.zeros(signal_rx.shape[:-1] + (M,), dtype=rdt, device=dev)
    K = z.scatter_add(-1, seg, torch.ones_like(signal_rx.real))
    s1r = z.scatter_add(-1, seg, signal_rx.real.contiguous())
    s1i = z.scatter_add(-1, seg, signal_rx.imag.contiguous())
    s2 = z.scatter_add(-1, seg, cabssquared(signal_rx))
    Ksafe = torch.clamp(K, min=1)
    mu2 = (s1r / Ksafe) ** 2 + (s1i / Ksafe) ** 2
    var = (s2 - Ksafe * mu2) / Ksafe
    Px = K / L
    N0 = torch.sum(var * Px, dim=-1)
    S0 = torch.sum(mu2 * Px, dim=-1)
    return S0 / N0, S0, N0


def _llr_dists(rx, bits_map, snr):
    """-snr |b - rx|^2 for every sample and point of the bit map: (N, nb, M/2, 2)."""
    nb, k, _ = bits_map.shape
    d = _neg2re_cross(rx, bits_map.reshape(-1)) + cabssquared(rx)[..., None]
    return -snr * d.reshape(rx.shape + (nb, k, 2))


def _demap_chunked(fn, rx_symbs, chunk=CHUNK):
    """``fn`` over ``chunk`` samples at a time (metrics.py:132-149): the (N, nb, M/2, 2)
    distances of 64-QAM at 2^20 symbols would take 1.5 GB at once."""
    rx = _tensor(rx_symbs).reshape(-1)
    return torch.cat([fn(rx[i:i + chunk]) for i in range(0, rx.shape[0], chunk)])


def _prepare_demap(rx_symbs, snr, bits_map):
    rx = _tensor(rx_symbs)
    return rx, _tensor(snr, rx.device), _tensor(bits_map, rx.device)


def soft_l_value_demapper(rx_symbs, snr, bits_map):
    """Exact log-sum-exp L-values (metrics.py:152-166): (N, num_bits), log p(1) - log p(0).

    rx_symbs: (N,) complex; snr: linear, a number or 0-d tensor; bits_map:
    (num_bits, M/2, 2) from :func:`generate_bitmapping_mtx`.
    """
    rx, snr, bmap = _prepare_demap(rx_symbs, snr, bits_map)

    def one(r):
        ls = torch.logsumexp(_llr_dists(r, bmap, snr), dim=-2)   # (n, nb, 2)
        return ls[..., 1] - ls[..., 0]
    return _demap_chunked(one, rx)


def soft_l_value_demapper_minmax(rx_symbs, snr, bits_map):
    """Min-max approximate L-values (metrics.py:169-181), the exact one's distances and chunks."""
    rx, snr, bmap = _prepare_demap(rx_symbs, snr, bits_map)

    def one(r):
        dmin = torch.amin(-_llr_dists(r, bmap, snr) / snr, dim=-2)   # (n, nb, 2)
        return snr * (dmin[..., 0] - dmin[..., 1])
    return _demap_chunked(one, rx)


def _cal_gamma(M):
    """The blind estimators' gamma (metrics.py:189-204).

    A non-constellation M (the 16-QAM partition passes 1.32) gives 1/M, as
    the reference's degenerate constellation does.
    """
    f = float(M)
    if not (f.is_integer() and f >= 4 and np.log2(f).is_integer()):
        return 1.0 / f
    A = np.abs(cal_symbols_qam(M)) / np.sqrt(cal_scaling_factor_qam(M))
    uniq, counts = np.unique(A, return_counts=True)
    return np.sum(uniq ** 4 * counts / M)


def _moments(E, M):
    """(r2, S1, S2) of the blind moment estimators (metrics.py:207-229), over the whole tensor."""
    gamma = _cal_gamma(M)
    p = cabssquared(_tensor(E))
    r2 = torch.mean(p)
    r4 = torch.mean(p ** 2)
    S1 = 1 - 2 * r2 ** 2 / r4 - torch.sqrt((2 - gamma) * (2 * r2 ** 4 / r4 ** 2 - r2 ** 2 / r4))
    S2 = gamma * r2 ** 2 / r4 - 1
    return r2, S1, S2


def cal_snr_qam(E, M):
    """Blind moment-based SNR after Gao and Tepedelenlioglu (metrics.py:207-218)."""
    _, S1, S2 = _moments(E, M)
    return S1 / S2


def cal_s0(E, M):
    """Blind signal power S0 (metrics.py:221-229)."""
    r2, S1, S2 = _moments(E, M)
    return r2 / (1 + S2 / S1)


def norm_to_s0(sig, M):
    """The signal divided by the square root of its blind S0 (metrics.py:184-186)."""
    sig = _tensor(sig)
    return sig / torch.sqrt(cal_s0(sig, M))


def cal_snr_blind_qpsk(E):
    """Blind QPSK SNR in dB from the 4th-power constellation's variance (metrics.py:232-239)."""
    E = _tensor(E)
    Eref = (-E ** 4) ** (1. / 4)
    P = torch.mean(cabssquared(Eref))
    var = torch.mean(cabssquared(Eref - Eref.mean()))
    return 10 * torch.log10(P / var.abs())


def _cal_evm_blind(sig, M):
    """Blind EVM (metrics.py:242-249)."""
    sig = _tensor(sig)
    ideal = torch.as_tensor(cal_symbols_qam(M).flatten().astype(np.complex64), device=sig.device)
    Pi = norm_to_s0(ideal, M)
    Pm = norm_to_s0(sig, M)
    d = torch.amin((Pm[..., None].real - Pi.real) ** 2 + (Pm[..., None].imag - Pi.imag) ** 2,
                   dim=-1)
    return torch.sqrt(torch.mean(d) / torch.mean(cabssquared(Pi)))


def cal_evm(sig, M, known=None):
    """Linear EVM of an M-QAM signal, blind without ``known`` (metrics.py:252-259)."""
    if known is None:
        return _cal_evm_blind(sig, M)
    Ps = norm_to_s0(_tensor(sig), M)
    Pi = norm_to_s0(_tensor(known, Ps.device), M)
    evm = torch.mean((Pi.real - Ps.real) ** 2 + (Pi.imag - Ps.imag) ** 2)
    return torch.sqrt(evm / torch.mean(cabssquared(Pi)))


def cal_ser_qam(data_rx, symbol_tx, M):
    """Symbol error rate against known symbols (metrics.py:262-267)."""
    data_rx = _tensor(data_rx)
    symbols = cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))
    det, _, _ = make_decision(data_rx, torch.as_tensor(symbols.astype(np.complex64),
                                                       device=data_rx.device))
    return torch.count_nonzero(det != _tensor(symbol_tx, data_rx.device)) / data_rx.shape[-1]


def _mean_log2(fn, n, chunk=CHUNK):
    """The mean over n samples of log2 of ``fn(slice)``, a chunk of samples at a time."""
    total = sum(torch.log2(fn(slice(i, i + chunk))).sum() for i in range(0, n, chunk))
    return total / n


def cal_mi_mc(noise, symbols, N0):
    """Monte-Carlo mutual information from noise draws (metrics.py:270-286).

    log2 M - mean over points i and draws l of log2 sum_j exp(-(|d_ij|^2 +
    2 Re(d_ij z_l)) / N0), d_ij = s_i - s_j; the draws taken a chunk at a time.
    """
    noise = _tensor(noise).reshape(-1)
    symbols = _tensor(symbols, noise.device)
    M = symbols.shape[0]
    diff = symbols[:, None] - symbols[None, :]                  # (M_i, M_j)

    def tmp(sl):
        z = noise[sl]
        ex = -(cabssquared(diff)[:, None, :] + 2 * (diff[:, None, :] * z[None, :, None]).real) / N0
        return torch.sum(torch.exp(ex), dim=-1)                  # (M, n)
    return np.log2(M) - _mean_log2(tmp, noise.shape[0]) / M


def cal_mi_mc_fast(sig, sig_tx, symbols, N0):
    """Fast Monte-Carlo mutual information from received and sent pairs (metrics.py:289-298)."""
    sig = _tensor(sig).reshape(-1)
    sig_tx = _tensor(sig_tx, sig.device).reshape(-1)
    symbols = _tensor(symbols, sig.device)
    M = symbols.shape[0]

    def tmp(sl):
        d = cabssquared(sig[sl, None] - symbols)
        d0 = cabssquared(sig[sl] - sig_tx[sl])
        return torch.sum(torch.exp(-(d - d0[:, None]) / N0), dim=-1)
    return np.log2(M) - _mean_log2(tmp, sig.shape[0])


def cal_mi(signal, symbols_tx, alphabet, N0, fast=True):
    """Mutual information of a noisy signal (metrics.py:301-306)."""
    if fast:
        return cal_mi_mc_fast(signal, symbols_tx, alphabet, N0)
    return cal_mi_mc(_tensor(signal) - _tensor(symbols_tx, _tensor(signal).device), alphabet, N0)


def cal_gmi_mc(symbols, snr, ns, bit_map, seed=0):
    """Monte-Carlo GMI of a bit-mapped constellation (metrics.py:309-343).

    The ``ns`` noise draws come from a ``torch.Generator`` on the symbols'
    device seeded with ``seed``: other values than the reference's
    ``jax.random`` draws, the same distribution.
    """
    symbols = _tensor(symbols)
    dev = symbols.device
    bit_map = _tensor(bit_map, dev)
    M = symbols.shape[0]
    nbits = int(np.log2(M))
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    zr = torch.randn(ns, generator=gen, device=dev)
    zi = torch.randn(ns, generator=gen, device=dev)
    z = np.sqrt(1 / snr) * torch.complex(zr, zi) / np.sqrt(2)

    def exp_sum(d):
        ex = -snr * (2 * (d[..., None] * z).real + cabssquared(d)[..., None])
        return torch.sum(torch.exp(ex), dim=-2)

    bm = torch.movedim(bit_map[:nbits], -1, 1)                  # (nb, 2, M/2)
    nom = exp_sum(bm[..., None] - symbols)                      # (nb, 2, M/2, ns)
    denom = exp_sum(bm[..., :, None] - bm[..., None, :])
    return nbits - torch.sum(torch.log2(nom / denom)) / (M * ns)
