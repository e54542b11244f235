"""Convenient helper functions on tensors (counterpart of ``qampy_tpu/helpers.py``).

Each takes a complex or real tensor of any device, or a signal object of
``qampy_tpu_torch.signals``: a function given a signal returns a signal
with the same attributes (``_object_aware``, reference helpers.py:14-28).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _object_aware(fn):
    """Take a signal as the first argument and return a signal of the result (helpers.py:14)."""
    @functools.wraps(fn)
    def wrapped(E, *args, **kwargs):
        if hasattr(E, "samples") and hasattr(E, "replace"):
            return E.replace(samples=fn(E.samples, *args, **kwargs))
        return fn(E, *args, **kwargs)
    return wrapped


def cabssquared(x):
    """|x|^2 without the square root (helpers.py:31-33)."""
    return x.real ** 2 + x.imag ** 2 if torch.is_complex(x) else x * x


def dB2lin(x):
    """dB(m) to linear units (helpers.py:36-38); numbers stay numbers, tensors stay tensors."""
    return 10 ** (x / 10) if torch.is_tensor(x) else 10 ** (np.asarray(x) / 10)


def lin2dB(x):
    """Linear units to dB(m) (helpers.py:41-43)."""
    return 10 * torch.log10(x) if torch.is_tensor(x) else 10 * np.log10(np.asarray(x))


def _mean_rows(E):
    """The mean of each row of a complex or real tensor, kept as a column."""
    return torch.mean(E, dim=-1, keepdim=True)


@_object_aware
def normalise_and_center(E):
    """Each mode centred to zero mean and scaled to unit average power (helpers.py:46-59)."""
    E = torch.as_tensor(E)
    E = E - _mean_rows(E)
    P = torch.sqrt(torch.mean(cabssquared(E), dim=-1, keepdim=True))
    return E / P


@_object_aware
def normalise_and_center_pil(sig, idx_pil):
    """Centre and normalise by the pilot symbols only (helpers.py:62-74)."""
    sig = torch.as_tensor(sig)
    idx = torch.as_tensor(np.asarray(idx_pil), device=sig.device)
    sig_pil = sig[..., idx]
    ct = -_mean_rows(sig_pil)
    p = torch.sqrt(torch.mean(cabssquared(sig_pil + ct), dim=-1, keepdim=True))
    return (sig + ct) / p


@_object_aware
def dump_edges(E, N):
    """Remove N samples from the beginning and end (helpers.py:77-82)."""
    return E[..., N:-N]


@_object_aware
def set_mid_point(E, mid_pos=0):
    """Move the middle of the signal's range to ``mid_pos`` (helpers.py:85-93).

    The middle is taken over the whole tensor, as in the reference.
    """
    E = torch.as_tensor(E)
    if torch.is_complex(E):
        mid = torch.complex((E.real.max() + E.real.min()) / 2, (E.imag.max() + E.imag.min()) / 2)
    else:
        mid = (E.max() + E.min()) / 2
    return E - mid + mid_pos


@_object_aware
def rescale_signal(E, swing=1):
    """Rescale each mode to (-swing, swing) (helpers.py:96-105)."""
    E = torch.atleast_2d(torch.as_tensor(E))
    swing = torch.atleast_1d(torch.as_tensor(swing, device=E.device))
    if torch.is_complex(E):
        scale = torch.maximum(E.real.abs().amax(-1), E.imag.abs().amax(-1))
    else:
        scale = E.abs().amax(-1)
    return E / scale[:, None] * swing[:, None].to(scale.dtype)


def set_mid_and_rescale(E, mid_pos=0, swing=1):
    """Centre to ``mid_pos``, then rescale (helpers.py:108-110)."""
    return rescale_signal(set_mid_point(E, mid_pos), swing)


# the reference spells this "resale" (helpers.py:114); keep that name working
set_mid_and_resale = set_mid_and_rescale


def get_center_shift_fac(E):
    """The shift that centres each mode (helpers.py:117-122)."""
    return -_mean_rows(torch.as_tensor(E))


def find_pilot_idx(nframe=2, frame_len=2 ** 16, os_rate=2, pilot_seq_len=1024, pilot_ins_rat=32):
    """Pilot mask of an oversampled multi-frame pilot signal (helpers.py:125-140), host numpy."""
    idx_os = np.arange(frame_len * nframe * os_rate)
    mask = np.zeros(idx_os.shape, dtype=bool)
    for i in range(nframe):
        t = frame_len * os_rate * i
        mask |= (t <= idx_os) & (idx_os < t + pilot_seq_len * os_rate)
        d = idx_os - pilot_seq_len * os_rate - t
        r = d % (pilot_ins_rat * os_rate)
        mask |= (r <= 1) & (d >= 0) & (idx_os < t + frame_len * os_rate)
    return mask
