"""Bit-level and windowing helpers (counterpart of ``qampy_tpu/utils.py``) and the device rule.

The bit helpers are host numpy, as in the reference; ``rolling_window`` and
``segment_axis`` are gathers on a tensor of any device, as the reference's
are gathers on a device array.
"""
from __future__ import annotations

import numpy as np
import torch


def bin2gray(value):
    """Convert binary value(s) to gray code (reference core/utils.py:195-200)."""
    return value ^ (value >> 1)


def resolve_device(device):
    """The device an entry point runs on: the card unless the caller names another.

    ``None`` is ``torch.device("cuda")``; on a machine without a card the
    first tensor moved there raises, and nothing carries on on the CPU.
    """
    return torch.device("cuda" if device is None else device)


def as_tensor(x, device=None):
    """``x`` as a tensor, on ``device`` if one is named.

    A tensor stays as it is; a host array is shared, or copied where it is
    read-only (as a JAX array's numpy view is), since torch may write to it.
    """
    if not torch.is_tensor(x):
        a = np.asarray(x)
        x = torch.as_tensor(a if a.flags.writeable else a.copy())
    return x if device is None else x.to(device)


def bool2bin(x):
    """Booleans as a binary number, the first element the lowest bit (utils.py:18-25)."""
    x = np.asarray(x, dtype=bool)
    if len(x) >= 64:
        raise ValueError("array must not be longer than 63")
    return sum(int(j) << i for i, j in enumerate(x))


def find_offset(sequence, data):
    """Index where ``sequence`` first occurs in ``data`` (utils.py:28-35); ValueError if nowhere."""
    sequence = np.asarray(sequence)
    data = np.asarray(data)
    if len(data) <= len(sequence):
        raise ValueError("data has to be longer than sequence")
    if data.dtype != sequence.dtype:
        data = data.astype(sequence.dtype)
    return data.tobytes().index(sequence.tobytes()) // data.itemsize


def rolling_window(data, size, wrap=False):
    """Overlapping frames of ``size`` along the last axis (utils.py:38-53): (..., nwin, size).

    With ``wrap`` the row is continued by its first size-1 samples, so there
    is one frame per sample.
    """
    data = torch.as_tensor(data)
    n = data.shape[-1]
    if wrap:
        data = torch.cat([data, data[..., :size - 1]], dim=-1)
        nwin = n
    else:
        nwin = n - size + 1
    idx = torch.arange(nwin, device=data.device)[:, None] + torch.arange(size, device=data.device)
    return data[..., idx]


def segment_axis(a, length, overlap=0, axis=-1, end='cut', endvalue=0):
    """Overlapping frames along an axis (utils.py:56-114, reference core/segmentaxis.py:26-128).

    ``end='cut'`` drops a partial last frame, ``'pad'`` extends the axis
    with ``endvalue`` and ``'wrap'`` with its first values, each to the next
    whole frame. ``axis=None`` flattens first; the (nseg, length) pair takes
    the place of the segmented axis.
    """
    a = torch.as_tensor(a)
    if axis is None:
        a = a.reshape(-1)
        axis = -1
    pos = axis % a.dim() if axis != -1 else None
    if axis != -1:
        a = torch.movedim(a, axis, -1)
    step = length - overlap
    if overlap >= length:
        raise ValueError("frames cannot overlap by more than 100%")
    if overlap < 0 or length <= 0:
        raise ValueError("overlap must be nonnegative and length must be positive")
    n = a.shape[-1]
    if n < length or (n - length) % step:
        if end == 'cut':
            if n < length:
                raise ValueError("Not enough data points to segment array in 'cut' mode; "
                                 "try 'pad' or 'wrap'")
        elif end in ('pad', 'wrap'):
            roundup = length if n < length else length + (1 + (n - length) // step) * step
            extra = roundup - n
            if end == 'pad':
                tail = torch.full(a.shape[:-1] + (extra,), endvalue, dtype=a.dtype,
                                  device=a.device)
            else:
                if extra > n:
                    raise ValueError("'wrap' needs at least length-overlap data points")
                tail = a[..., :extra]
            a = torch.cat([a, tail], dim=-1)
            n = roundup
        else:
            raise ValueError("end must be 'cut', 'pad' or 'wrap'")
    nseg = 1 + (n - length) // step
    idx = (torch.arange(nseg, device=a.device)[:, None] * step
           + torch.arange(length, device=a.device)[None, :])
    out = a[..., idx]
    if pos is not None:
        out = torch.movedim(out, (-2, -1), (pos, pos + 1))
    return out


def linspacestep(start, step, N):
    """N values from ``start`` with step ``step`` (utils.py:117-119)."""
    return np.arange(start, start + N * step, step=step)


def factorial(n):
    """n! (utils.py:122-124)."""
    return int(np.prod(np.arange(1, n + 1))) if n > 0 else 1


def convert_iqtosinglebitstream(idat, qdat, nbits):
    """Interleave two bitstreams into one of ``nbits`` per symbol (utils.py:127-138)."""
    idat = np.asarray(idat)
    qdat = np.asarray(qdat)
    N = [nbits // 2 + 1, nbits // 2] if nbits % 2 else [nbits // 2, nbits // 2]
    idat_n = idat[: len(idat) - (len(idat) % N[0])].reshape(N[0], -1)
    qdat_n = qdat[: len(qdat) - (len(qdat) % N[1])].reshape(N[1], -1)
    n = min(idat_n.shape[1], qdat_n.shape[1])
    return np.vstack([idat_n[:, :n], qdat_n[:, :n]]).flatten()


def lfsr_int(seed, mask):
    """Galois (internal-XOR) LFSR generator yielding (bit, state) (utils.py:141-155)."""
    state = int(seed)
    nbits = int(mask).bit_length() - 1
    while True:
        state = state << 1
        xor = state >> nbits
        if xor != 0:
            state ^= mask
        yield xor, state


def lfsr_ext(seed, taps, nbits):
    """Fibonacci (external-XOR) LFSR generator yielding (bit, state) (utils.py:158-166)."""
    sr = int(seed)
    while True:
        xor = 0
        for t in taps:
            if (sr & (1 << (nbits - t))) != 0:
                xor ^= 1
        sr = (xor << nbits - 1) + (sr >> 1)
        yield xor, sr
