"""Sequence synchronisation and BER helpers (counterpart of ``qampy_tpu/core/sync.py``).

Plain PyTorch on tensors of any device. The cross-correlation is one
zero-padded FFT, and the complex signals' quarter-turn ambiguity is read
from that one correlation: turning y by 1j**i multiplies it by
conj(1j**i). A function that rolls by a found offset reads the offset on
the host, once per call.
"""
from __future__ import annotations

import numpy as np
import torch

from qampy_tpu_torch import utils
from qampy_tpu_torch.utils import as_tensor as _tensor


class DataSyncError(Exception):
    pass


def _xcorr_full(x, y):
    """Full linear cross-correlation of x with y along the last axis (sync.py:22-35).

    x: (..., N_X), y: (..., N_Y), broadcast against each other. Returns
    (..., N_X + N_Y - 1), real when both are real.
    """
    n = x.shape[-1] + y.shape[-1] - 1
    nfft = int(2 ** np.ceil(np.log2(n)))
    X = torch.fft.fft(x, nfft)
    Y = torch.fft.fft(torch.conj(y).flip(-1), nfft)
    ac = torch.fft.ifft(X * Y)[..., :n]
    if not (torch.is_complex(x) or torch.is_complex(y)):
        ac = ac.real
    return ac


def correlation_peaks(ac, ny):
    """(offset, quarter turns, score) of correlations ``ac`` (..., N_X + ny - 1).

    offset = argmax |ac| - (ny - 1); for complex data the quarter turn i of
    y whose correlation conj(1j**i) ac has the highest real peak, and that
    peak, max over t of max(|Re ac|, |Im ac|) (sync.py:52-76); for real data
    turn 0 and max |ac|. Each is a tensor of the leading shape.
    """
    offset = torch.argmax(ac.abs(), dim=-1) - (ny - 1)
    if not torch.is_complex(ac):
        return offset, torch.zeros_like(offset), ac.abs().amax(-1)
    re, im = ac.real, ac.imag
    peaks = torch.stack([re.amax(-1), im.amax(-1), (-re).amax(-1), (-im).amax(-1)], dim=-1)
    score, turns = peaks.max(dim=-1)
    return offset, turns, score


def quarter_turn(y, turns):
    """y * 1j**turns for a host integer ``turns``, exact."""
    return y * (1j ** int(turns)) if int(turns) % 4 else y


def find_sequence_offset(x, y, show_cc=False):
    """The shift of ``y`` that aligns it with ``x``, by cross-correlation (sync.py:38-49).

    Returns a 0-d tensor (and the correlation with ``show_cc``).
    """
    X = 1. * _tensor(x)
    Y = 1. * _tensor(y, X.device)
    ac = _xcorr_full(X, Y)
    idx = torch.argmax(ac.abs()) - (Y.shape[-1] - 1)
    if show_cc:
        return idx, ac
    return idx


def find_sequence_offset_complex(x, y):
    """Offset and quarter turn of y against x (sync.py:52-76): (idx, y turned, turns, peak).

    idx, turns and the peak are read on the host, once.
    """
    x = _tensor(x)
    y = _tensor(y, x.device)
    ac = _xcorr_full(1. * x, 1. * y)
    offset, turns, score = correlation_peaks(ac, y.shape[-1])
    offset, turns, score = torch.stack([offset.double(), turns.double(), score.double()]).tolist()
    return int(offset), quarter_turn(y, turns), int(turns), score


def sync_and_adjust(data_tx, data_rx, adjust="tx"):
    """Synchronise and length-adjust one tx/rx pair (sync.py:79-110): ((tx, rx), peak)."""
    data_tx = _tensor(data_tx)
    data_rx = _tensor(data_rx, data_tx.device)
    if adjust not in ("tx", "rx"):
        raise ValueError("adjust needs to be either 'tx' or 'rx'")
    if adjust == "tx":
        offset, tx, _, acm = find_sequence_offset_complex(data_rx, data_tx)
        return adjust_synced(tx, data_rx, offset, "tx"), acm
    offset, rx, _, acm = find_sequence_offset_complex(data_tx, data_rx)
    return adjust_synced(data_tx, rx, offset, "rx"), acm


def adjust_synced(tx, rx, offset, adjust="tx"):
    """The length adjustment of :func:`sync_and_adjust` once the offset and the turn are known.

    With adjust="tx" the (already turned) tx is rolled by ``offset`` and cut
    or periodically extended to rx's length; with "rx" the same for rx.
    """
    n_tx, n_rx = tx.shape[-1], rx.shape[-1]
    if adjust == "tx":
        if n_tx > n_rx:
            return adjust_data_length(torch.roll(tx, offset, -1), rx, method="truncate")
        if n_tx < n_rx:
            return adjust_data_length(tx, rx, method="extend", offset=offset)
        return torch.roll(tx, offset, -1), rx
    if n_tx > n_rx:
        return adjust_data_length(tx, rx, method="extend", offset=offset)
    if n_tx < n_rx:
        return adjust_data_length(tx, torch.roll(rx, offset, -1), method="truncate")
    return tx, torch.roll(rx, offset, -1)


def _adjust_to(data, N, back=True):
    """``data`` extended periodically to N (sync.py:113-132): [tiles, head] or [tail, tiles]."""
    data = _tensor(data)
    L = data.shape[-1]
    N = int(N)
    K, rem = N // L, N % L
    parts = [data] * K
    parts = parts + [data[..., :rem]] if back else [data[..., L - rem:]] + parts
    return torch.cat(parts, dim=-1)


def adjust_data_length(data_tx, data_rx, method=None, offset=0):
    """Lengths of tx and rx adjusted by truncation or periodic extension (sync.py:135-165)."""
    data_tx = _tensor(data_tx)
    data_rx = _tensor(data_rx, data_tx.device)
    Ltx, Lrx = data_tx.shape[-1], data_rx.shape[-1]
    if method is None:
        if Ltx > Lrx:
            return data_tx[..., :Lrx], data_rx
        if Ltx < Lrx:
            return _extend_with_offset(data_tx, Lrx, offset), data_rx
        return data_tx, data_rx
    if method == "truncate":
        if Ltx > Lrx:
            return data_tx[..., :Lrx], data_rx
        if Ltx < Lrx:
            return data_tx, data_rx[..., :Ltx]
        return data_tx, data_rx
    if method == "extend":
        if Ltx > Lrx:
            return data_tx, _extend_with_offset(data_rx, Ltx, offset)
        if Ltx < Lrx:
            return _extend_with_offset(data_tx, Lrx, offset), data_rx
        return data_tx, data_rx
    raise ValueError("method must be None, 'truncate' or 'extend'")


def _extend_with_offset(data, N, offset):
    """Periodic extension to N with data[0] at ``offset``: element i is data[(i - offset) mod L]
    (sync.py:168-179)."""
    L = data.shape[-1]
    idx = torch.remainder(torch.arange(int(N), device=data.device) - offset, L)
    return data[..., idx]


def cal_ber_syncd(data_rx, data_tx, threshold=0.2):
    """BER of two synchronised bit streams (sync.py:182-189): (ber, errors, N)."""
    errs = int(np.count_nonzero(np.asarray(data_rx) != np.asarray(data_tx)))
    N = len(data_tx)
    ber = errs / N
    if ber > threshold:
        raise ValueError("BER is over %.1f, this is probably a wrong sync" % threshold)
    return ber, errs, N


def cal_ber_nosyncd(data_rx, data_tx):
    """BER of an unsynchronised rx bit stream against a known tx sequence (sync.py:192-211).

    The offset is found by correlation, with the inverted tx as well; tx is
    extended periodically to rx's length; the better of the two counts.
    """
    data_rx = np.asarray(data_rx).astype(bool)
    data_tx = np.asarray(data_tx).astype(bool)
    results = []
    for tx in (data_tx, ~data_tx):
        idx = int(find_sequence_offset(tx.astype(np.float32) - 0.5,
                                       data_rx.astype(np.float32) - 0.5))
        tx_sync, rx = adjust_data_length(torch.as_tensor(np.roll(tx, -idx)),
                                         torch.as_tensor(data_rx))
        tx_sync, rx = tx_sync.numpy(), rx.numpy()
        results.append((int(np.count_nonzero(tx_sync != rx)), tx_sync, rx))
    _, tx_sync, rx = min(results, key=lambda r: r[0])
    return cal_ber_syncd(rx, tx_sync)


def _sync_by_search(data_tx, data_rx, Lsync, imax):
    data_tx = np.asarray(data_tx)
    data_rx = np.asarray(data_rx)
    for i in np.arange(imax) * Lsync:
        try:
            return utils.find_offset(data_rx[i:i + Lsync], data_tx) - i
        except ValueError:
            pass
    raise DataSyncError("maximum iterations exceeded")


def sync_rx2tx(data_tx, data_rx, Lsync, imax=200):
    """Sync rx to tx by searching tx for pieces of rx (sync.py:214-225): (offset, rx rolled)."""
    offs = _sync_by_search(data_tx, data_rx, Lsync, imax)
    return offs, np.roll(np.asarray(data_rx), offs)


def sync_tx2rx(data_tx, data_rx, Lsync, imax=200):
    """Sync tx to rx by searching tx for pieces of rx (sync.py:228-239): (offset, tx rolled)."""
    offs = _sync_by_search(data_tx, data_rx, Lsync, imax)
    return offs, np.roll(np.asarray(data_tx), -offs)
