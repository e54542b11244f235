"""Filters on signal objects (counterpart of ``qampy_tpu/filtering.py``).

Each takes a signal of ``qampy_tpu_torch.signals`` and returns a signal
with the same attributes (``moving_average`` returns the tensor), on the
signal's device, through ``core.filter``.
"""
from __future__ import annotations

from qampy_tpu_torch.core import filter as cfilter
from qampy_tpu_torch.signals import rewrap, samples_of

__all__ = ["filter_signal", "filter_signal_analog", "pre_filter", "rrcos_pulseshaping",
           "moving_average"]


def filter_signal(sig, cutoff, ftype="bessel", order=2):
    """A digital filter emulating an analog low-pass at ``cutoff`` Hz (reference :23-27)."""
    return rewrap(sig, cfilter.filter_signal(samples_of(sig), sig.fs, cutoff, ftype=ftype,
                                              order=order))


def filter_signal_analog(sig, cutoff, ftype="bessel", order=2):
    """The analog prototype simulated in continuous time (reference :30-41).

    Both quadratures of a complex signal are filtered (scipy's ``lsim``
    casts complex input to real; the reference and the port do not).
    """
    return rewrap(sig, cfilter.filter_signal(samples_of(sig), sig.fs, cutoff, ftype=ftype,
                                              order=order, analog=True))


def pre_filter(sig, bw):
    """Brick-wall pre-filter (reference :44-47)."""
    return rewrap(sig, cfilter.pre_filter(samples_of(sig), bw))


def rrcos_pulseshaping(sig, beta, T=None, taps=1001):
    """Root-raised-cosine filter of roll-off ``beta``, symbol time ``T`` (1/fb) (:50-54)."""
    T = 1 / sig.fb if T is None else T
    return rewrap(sig, cfilter.rrcos_pulseshaping(samples_of(sig), sig.fs, T, beta, taps=taps))


def moving_average(sig, N=3):
    """Moving average of length N over the valid region, as a tensor (reference :57)."""
    return cfilter.moving_average(samples_of(sig), N)
