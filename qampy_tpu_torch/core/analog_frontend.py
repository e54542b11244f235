"""Compensation of the receiver's analog frontend (``qampy_tpu/core/analog_frontend.py``).

On complex tensors of any device: I/Q imbalance, an RF delay, and the
Gram-Schmidt orthonormalisation of I and Q.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["comp_IQ_inbalance", "comp_rf_delay", "orthonormalize_signal"]


def comp_IQ_inbalance(signal):
    """Compensate the I/Q imbalance of an optical hybrid, per mode (reference :10-21).

    The phase imbalance is arcsin of -<IQ>/<I^2>, the amplitude imbalance
    <I^2>/<Q'^2> of the phase-corrected Q'.
    """
    signal = torch.as_tensor(signal)
    signal = signal - torch.mean(signal, dim=-1, keepdim=signal.dim() > 1)
    I, Q = signal.real, signal.imag
    mon = torch.sum(I * Q, dim=-1, keepdim=True) / torch.sum(I ** 2, dim=-1, keepdim=True)
    phase_inb = torch.arcsin(-mon)
    Q_balcd = (Q + torch.sin(phase_inb) * I) / torch.cos(phase_inb)
    amp_inb = torch.sum(I ** 2, dim=-1, keepdim=True) / torch.sum(Q_balcd ** 2, dim=-1,
                                                                   keepdim=True)
    return torch.complex(I, Q_balcd * torch.sqrt(amp_inb))


def comp_rf_delay(signal, delay, sampling_rate=50e9):
    """Compensate an RF delay in the spectrum; the real part (reference :24-33).

    The frequency axis is the reference's ``fftfreq(N, sampling_rate / 2)``.
    """
    signal = torch.as_tensor(signal)
    sig = torch.atleast_2d(signal)
    f = torch.fft.fftfreq(sig.shape[-1], sampling_rate / 2, dtype=torch.float64,
                          device=sig.device)
    ph = torch.remainder(-2 * np.pi * delay * f, 2 * np.pi).to(sig.real.dtype)
    out = torch.fft.ifft(torch.polar(torch.ones_like(ph), ph) * torch.fft.fft(sig, dim=-1),
                         dim=-1).real
    return out if signal.dim() > 1 else out.flatten()


def orthonormalize_signal(E, os=1):
    """Gram-Schmidt orthonormalisation of I and Q, then centred and normalised (reference :36-46).

    The mean and power of the last step are taken over every ``os``-th sample.
    """
    E = torch.atleast_2d(torch.as_tensor(E))
    real_out = E.real - E.real.mean(dim=-1, keepdim=True)
    tmp_imag = E.imag - E.imag.mean(dim=-1, keepdim=True)
    p_i = torch.mean(real_out ** 2, dim=-1, keepdim=True)
    p_q = torch.mean(tmp_imag ** 2, dim=-1, keepdim=True)
    p_iq = torch.mean(real_out * tmp_imag, dim=-1, keepdim=True)
    sig_out = torch.complex(real_out / torch.sqrt(p_i),
                            (tmp_imag - p_iq * real_out / p_i) / torch.sqrt(p_q))
    sig_out = sig_out - torch.mean(sig_out[:, ::os], dim=-1, keepdim=True)
    return sig_out / torch.sqrt(torch.mean(sig_out[:, ::os].abs() ** 2, dim=-1, keepdim=True))
