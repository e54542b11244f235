"""Rational resampling with root-raised-cosine shaping (``qampy_tpu/core/resample.py``).

``rrcos_resample`` runs on the tensor's device: zero insertion, the FFT
RRC filter, decimation. ``resample_poly`` runs scipy on the host, as the
reference does, and hands the result back on the input's device.
"""
from __future__ import annotations

import fractions

import numpy as np
import torch
from scipy import signal as scisig

from qampy_tpu_torch.core.filter import rrcos_pulseshaping
from qampy_tpu_torch.helpers import normalise_and_center


def _resamplingfactors(fold, fnew):
    """(up, down) of the ratio fnew / fold, as the nearest small fraction (reference :21-23)."""
    ratn = fractions.Fraction(fnew / fold).limit_denominator()
    return ratn.numerator, ratn.denominator


def resample_poly(signal, fold, fnew, window=None, renormalise=False):
    """Polyphase rational resampling of a flattened signal (reference :26-41).

    ``scipy.signal.resample_poly`` on the host, as in the reference, which
    flattens its input; the result is a tensor on the input's device (the
    CPU for a host array).
    """
    dev = signal.device if torch.is_tensor(signal) else torch.device("cpu")
    sig = (signal.detach().cpu().numpy() if torch.is_tensor(signal)
           else np.asarray(signal)).flatten()
    up, down = _resamplingfactors(fold, fnew)
    if window is None:
        sig_new = scisig.resample_poly(sig, up, down)
    else:
        sig_new = scisig.resample_poly(sig, up, down, window=np.asarray(window))
    out = torch.as_tensor(sig_new)
    if renormalise:
        out = normalise_and_center(out) * np.sqrt(np.mean(abs(sig) ** 2))
    return out.to(dev)


def rrcos_resample(signal, fold, fnew, Ts=None, beta=None, taps=4001, renormalise=False,
                   fftconv=True):
    """RRC pulse shaping and rational resampling along the last axis (reference :44-68).

    Zero insertion by ``up``, the RRC filter of ``taps`` taps at the
    upsampled rate (``taps=None``: in the spectrum), every ``down``-th
    sample, all on the signal's device; with ``renormalise`` the result is
    centred and scaled to the input's mean power. Without ``beta`` it is
    :func:`resample_poly`. ``fftconv`` is accepted as in the reference,
    whose default path this is.
    """
    if beta is None:
        return resample_poly(signal, fold, fnew)
    if not 0 < beta <= 1:
        raise ValueError("beta needs to be in interval (0,1]")
    if Ts is None:
        Ts = 1 / fold
    up, down = _resamplingfactors(fold, fnew)
    sig = torch.as_tensor(signal)
    sig_new = torch.zeros(sig.shape[:-1] + (sig.shape[-1] * up,), dtype=sig.dtype,
                          device=sig.device)
    sig_new[..., ::up] = sig
    sig_new = rrcos_pulseshaping(sig_new, up * fold, Ts, beta, taps)[..., ::down]
    if renormalise:
        p = torch.mean(sig.abs() ** 2)
        sig_new = normalise_and_center(sig_new) * torch.sqrt(p)
    return sig_new
