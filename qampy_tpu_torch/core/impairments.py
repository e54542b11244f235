"""Transmission impairments in torch (counterpart of ``qampy_tpu/core/impairments.py``).

The functions the pilot workload applies, on complex (nmodes, L) tensors
on any device. Each random function takes an explicit ``torch.Generator``
on the tensor's device: the same seed gives other numbers than the
reference's ``jax.random`` keys, so tests hand both packages one capture.
"""
from __future__ import annotations

import numpy as np
import torch


def _randn(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def phase_noise(shape, df, fs, generator):
    """Wiener phase noise, variance 2*pi*df/fs per step (reference :68-73).

    The walk is summed in float64 and returned as float32.
    """
    dev = generator.device
    steps = _randn(shape, generator, dev).double() * np.sqrt(2 * np.pi * df / fs)
    return torch.cumsum(steps, dim=-1).float()


def apply_phase_noise(sig, df, fs, generator):
    """Add laser phase noise to a complex signal (reference :76-80)."""
    ph = phase_noise(sig.shape, df, fs, generator)
    return sig * torch.polar(torch.ones_like(ph), ph)


def add_awgn(sig, strgth, generator):
    """Add complex AWGN of standard deviation ``strgth`` (reference :83-89)."""
    nr = _randn(sig.shape, generator, sig.device)
    ni = _randn(sig.shape, generator, sig.device)
    return sig + (strgth / np.sqrt(2)) * torch.complex(nr, ni)


def change_snr(sig, snr, fb, fs, generator):
    """Set the SNR of a (noiseless) signal, oversampling-aware (reference :92-98)."""
    p = torch.mean(torch.abs(sig) ** 2)
    n = 10 ** (-snr / 20) * np.sqrt(fs / fb)
    return add_awgn(sig, torch.sqrt(p) * n, generator)


def add_carrier_offset(sig, fo, fs):
    """Add a carrier frequency offset ``fo`` to a signal sampled at ``fs`` (reference :101-107).

    sig * exp(2j pi t fo / fs), t = 0, ..., L-1 along the last axis. The
    phase is reckoned in float64 cycles, reduced to [0, 1), and rounded to
    float32 once: the reference forms it in float32, whose t and phase lose
    precision over long captures (past 2^24 samples t itself rounds).
    """
    t = torch.arange(sig.shape[-1], dtype=torch.float64, device=sig.device)
    cyc = torch.remainder(t * (float(fo) / float(fs)), 1.0)
    ph = (2 * np.pi * cyc).to(torch.float32)
    return sig * torch.polar(torch.ones_like(ph), ph)


def _rotation(theta, dtype, device):
    return torch.tensor([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]],
                        dtype=dtype, device=device)


def apply_PMD_to_field(field, theta, t_dgd, fs):
    """First-order PMD on a dual-pol field: rotate, delay the axes by -+t_dgd/2, rotate back.

    Reference :49-65, in the frequency domain of the shifted spectrum.
    """
    L = field.shape[-1]
    omega = 2 * np.pi * torch.linspace(-fs / 2, fs / 2, L + 1, dtype=torch.float64,
                                       device=field.device)[:-1]
    Sf = torch.fft.fftshift(torch.fft.fft(torch.fft.ifftshift(field, dim=-1), dim=-1), dim=-1)
    Sf = _rotation(theta, Sf.dtype, field.device) @ Sf
    ph = torch.stack([-omega * t_dgd / 2, omega * t_dgd / 2]).float()
    Sf = Sf * torch.polar(torch.ones_like(ph), ph)
    Sf = _rotation(-theta, Sf.dtype, field.device) @ Sf
    out = torch.fft.fftshift(torch.fft.ifft(torch.fft.ifftshift(Sf, dim=-1), dim=-1), dim=-1)
    return out.to(field.dtype)


def add_modal_delay(sig, delay):
    """Delay mode i by ``delay[i]`` samples, circularly (reference :110-117)."""
    if len(delay) != sig.shape[0]:
        raise ValueError("Delay array must have the same length as number of modes of signal")
    return torch.stack([torch.roll(sig[i], int(d)) for i, d in enumerate(delay)])


def roll_frame_sync(sig, npilots):
    """Roll a pilot capture by its pilot count, as ``simulate_transmission(roll_frame_sync=True)``.

    Reference ``qampy_tpu/impairments.py:83-86``: the first frame then starts
    ``npilots`` samples into the capture, so the receiver has to find it.
    """
    return torch.roll(sig, int(npilots), dims=-1)


def simulate_transmission(sig, fb, fs, generator, snr=None, freq_off=None, lwdth=None,
                          dgd=None, theta=np.pi / 3.731, modal_delay=None):
    """Phase noise, carrier offset, SNR, modal delay and PMD in the reference's order.

    Reference :120-135.
    """
    if lwdth is not None:
        sig = apply_phase_noise(sig, lwdth, fs, generator)
    if freq_off is not None:
        sig = add_carrier_offset(sig, freq_off, fs)
    if snr is not None:
        sig = change_snr(sig, snr, fb, fs, generator)
    if modal_delay is not None:
        sig = add_modal_delay(sig, modal_delay)
    if dgd is not None:
        sig = apply_PMD_to_field(sig, theta, dgd, fs)
    return sig
