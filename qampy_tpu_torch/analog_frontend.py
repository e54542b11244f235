"""Analog frontend compensation on signal objects (``qampy_tpu/analog_frontend.py``)."""
from __future__ import annotations

from qampy_tpu_torch.core import analog_frontend as caf
from qampy_tpu_torch.signals import rewrap, samples_of

__all__ = ["comp_IQ_inbalance", "comp_rf_delay", "orthonormalize_signal"]


def comp_IQ_inbalance(signal):
    """Compensate the I/Q imbalance (reference qampy/analog_frontend.py:23-25)."""
    return rewrap(signal, caf.comp_IQ_inbalance(samples_of(signal)))


def comp_rf_delay(signal, delay):
    """Compensate an RF delay at the signal's rate (reference :28-30)."""
    return rewrap(signal, caf.comp_rf_delay(samples_of(signal), delay, signal.fs))


def orthonormalize_signal(signal, os=None):
    """Gram-Schmidt orthonormalisation over every ``os``-th sample (default: the signal's os)."""
    os = signal.os if os is None else os
    return rewrap(signal, caf.orthonormalize_signal(samples_of(signal), os=os))
