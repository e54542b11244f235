"""The blind receiver's capture, made in torch on the card from a seed.

The statistics of the port's host generator (``workload.make_tx``, itself the
JAX bench's ``make_tx``): dual-pol square M-QAM drawn uniformly, 2x upsampling
by zero insertion, root-raised-cosine shaping in the frequency domain, unit
power per row, Wiener phase noise, AWGN at the stated SNR (oversampling-aware),
then first-order PMD (rotation, differential delay, rotation back) in the
frequency domain. Every draw comes from one ``torch.Generator`` on the device,
so the same seed gives the same capture on the same device; the arrays are
not the host generator's, only of the same statistics. Imports nothing of the
program.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class BlindTx(NamedTuple):
    planes: torch.Tensor    # (4, 2 * nsym) float32 [Re x, Re y; Im x, Im y] at 2 samples/symbol
    idx: torch.Tensor       # (2, nsym) uint8 indices into ``const`` of the sent symbols
    const: torch.Tensor     # (M,) complex64 unit-power constellation on the device


def square_qam(M):
    """Square M-QAM at unit mean power, host complex64, in row-major level order."""
    L = int(round(math.sqrt(M)))
    if L * L != M:
        raise ValueError("square QAM needs a square M, got %d" % M)
    side = np.linspace(-(L - 1), L - 1, L)
    re, im = np.meshgrid(side, side, indexing="ij")
    c = (re + 1j * im).reshape(-1)
    return (c / np.sqrt(2 / 3 * (M - 1))).astype(np.complex64)


def rrc_response(L, os, fb, beta, device):
    """Root-raised-cosine amplitude on the FFT grid of L samples at os*fb, peak 1 (float32)."""
    f = torch.fft.fftfreq(L, device=device, dtype=torch.float64) * (os * fb)
    T = 1.0 / fb
    af = f.abs()
    lo, hi = (1 - beta) / (2 * T), (1 + beta) / (2 * T)
    rc = torch.where(af <= lo, T, 0.0)
    roll = T / 2 * (1 + torch.cos(math.pi * T / beta * (af - lo)))
    rc = torch.where((af > lo) & (af <= hi), roll, rc)
    h = torch.sqrt(rc)
    return (h / h.max()).to(torch.float32)


def _rotation(theta, device):
    c, s = math.cos(theta), math.sin(theta)
    return torch.tensor([[c, -s], [s, c]], dtype=torch.complex64, device=device)


def make(nsym, seed, M=64, fb=25e9, beta=0.1, snr_db=35.0, linewidth_hz=20e3,
         pmd_theta=math.pi / 5.6, dgd_s=50e-12, os=2, device="cuda"):
    """One dual-pol capture of ``nsym`` symbols a mode: :class:`BlindTx`."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    const = torch.as_tensor(square_qam(M), device=dev)
    idx = torch.randint(0, M, (2, nsym), generator=g, device=dev)
    L = nsym * os
    up = torch.zeros((2, L), dtype=torch.complex64, device=dev)
    up[:, ::os] = const[idx]
    sig = torch.fft.ifft(torch.fft.fft(up, dim=-1) * rrc_response(L, os, fb, beta, dev), dim=-1)
    del up
    sig = sig / torch.sqrt(torch.mean(sig.abs() ** 2, dim=-1, keepdim=True))
    # Wiener phase noise, the walk summed in float64
    var = 2 * math.pi * linewidth_hz / (os * fb)
    steps = torch.randn((2, L), generator=g, device=dev, dtype=torch.float32).double()
    ph = torch.cumsum(steps * math.sqrt(var), dim=-1).to(torch.float32)
    sig = sig * torch.polar(torch.ones_like(ph), ph)
    del ph, steps
    n_amp = 10 ** (-snr_db / 20) * math.sqrt(os)
    nr = torch.randn((2, L), generator=g, device=dev, dtype=torch.float32)
    ni = torch.randn((2, L), generator=g, device=dev, dtype=torch.float32)
    sig = sig + (n_amp / math.sqrt(2)) * torch.complex(nr, ni)
    del nr, ni
    # first-order PMD on the shifted spectrum
    omega = 2 * math.pi * (torch.arange(L, device=dev, dtype=torch.float64) / L - 0.5) * (os * fb)
    Sf = torch.fft.fftshift(torch.fft.fft(torch.fft.ifftshift(sig, dim=-1), dim=-1), dim=-1)
    Sf = _rotation(pmd_theta, dev) @ Sf
    dph = torch.stack([-omega * dgd_s / 2, omega * dgd_s / 2]).to(torch.float32)
    Sf = Sf * torch.polar(torch.ones_like(dph), dph)
    Sf = _rotation(-pmd_theta, dev) @ Sf
    sig = torch.fft.fftshift(torch.fft.ifft(torch.fft.ifftshift(Sf, dim=-1), dim=-1), dim=-1)
    planes = torch.cat([sig.real, sig.imag]).to(torch.float32).contiguous()
    return BlindTx(planes, idx.to(torch.uint8), const)
