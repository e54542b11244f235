"""The pilot receiver's captures, made in torch on the card from a seed.

The statistics of the port's pilot generator (``workload.make_pilot_tx``, the
JAX bench's ``pilot_maketx``): per mode one frame of QAMpy's
``SignalWithPilots(M, frame_len, seq_len, ins_rat)`` (a Gray-coded QPSK pilot
sequence and phase pilots, Gray-coded M-QAM payload) tiled over the frames,
2x root-raised-cosine shaping at beta 0.1, a roll by the frame's pilot count,
Wiener phase noise, AWGN at the stated SNR and first-order PMD, in that order.

A transmitter keeps its pilots: the pilots of a pool are drawn once from the
seed, and each capture of the pool draws its payload and its channel from a
generator of its own. Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.gen.blind_tx import _rotation, rrc_response, square_qam


class Pilots(NamedTuple):
    seq: np.ndarray          # (nmodes, seq_len) complex64 pilot sequence
    phase: np.ndarray        # (nmodes, nph) complex64 phase pilots
    all: torch.Tensor        # (nmodes, npil) complex64, both, in frame order


class PilotTx(NamedTuple):
    planes: torch.Tensor     # (4, frames * frame_len * 2) float32 [Re; Im] at 2 samples/symbol
    idx: torch.Tensor        # (nmodes, payload symbols a frame) int64 coded indices
    coded: torch.Tensor      # (M,) complex64 constellation by coded index
    bits: torch.Tensor       # (M, log2 M) bool, the bits of each coded index


def pilot_layout(frame_len, seq_len, ins_rat):
    """(payload mask, pilot mask) of a frame: the sequence, then a phase pilot every ins_rat."""
    i = np.arange(frame_len)
    if (frame_len - seq_len) % ins_rat:
        raise ValueError("the frame less its pilot sequence must divide by the pilot rate")
    phase = ((i - seq_len) % ins_rat != 0) & (i - seq_len > 0)
    return phase, ~phase


def gray_mapping(M):
    """Gray-coded square M-QAM: (points by coded index, bits of each index, MSB first)."""
    nb = int(round(math.log2(M)))
    n = nb // 2
    idx = np.mgrid[0:2 ** n, 0:2 ** n]
    gidx = idx ^ (idx >> 1)
    gray = ((gidx[0] << n) | gidx[1]).reshape(-1)
    u = np.zeros_like(gray)
    u[gray] = np.arange(u.size)
    coded = square_qam(M)[u]
    bits = ((np.arange(M)[:, None] >> np.arange(nb - 1, -1, -1)) & 1).astype(bool)
    return coded, bits


def draw_pilots(seed, frame_len=2 ** 16, seq_len=1024, ins_rat=32, nmodes=2, device="cuda"):
    """The QPSK pilots of a transmitter, drawn from ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    _, pil_mask = pilot_layout(frame_len, seq_len, ins_rat)
    coded_p, _ = gray_mapping(4)
    pil = torch.as_tensor(coded_p, device=dev)[
        torch.randint(0, 4, (nmodes, int(pil_mask.sum())), generator=g, device=dev)]
    h = pil.cpu().numpy()
    return Pilots(h[:, :seq_len], h[:, seq_len:], pil)


def make(pilots, nframes, seed, M=64, frame_len=2 ** 16, seq_len=1024, ins_rat=32, fb=24e9,
         snr_db=35.0, linewidth_hz=20e3, dgd_s=20e-12, pmd_theta=math.pi / 4.3, beta=0.1,
         device="cuda"):
    """One capture of ``nframes`` frames with the transmitter's ``pilots``: :class:`PilotTx`."""
    nmodes, os = pilots.all.shape[0], 2
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    dat_mask, pil_mask = pilot_layout(frame_len, seq_len, ins_rat)
    coded_h, bits_h = gray_mapping(M)
    coded = torch.as_tensor(coded_h, device=dev)
    idx = torch.randint(0, M, (nmodes, int(dat_mask.sum())), generator=g, device=dev)
    frame = torch.empty((nmodes, frame_len), dtype=torch.complex64, device=dev)
    frame[:, torch.as_tensor(np.nonzero(pil_mask)[0], device=dev)] = pilots.all
    frame[:, torch.as_tensor(np.nonzero(dat_mask)[0], device=dev)] = coded[idx]
    N = frame_len * int(nframes)
    up = torch.zeros((nmodes, N * os), dtype=torch.complex64, device=dev)
    up[:, ::os] = frame.repeat(1, int(nframes))
    del frame
    sig = torch.fft.ifft(torch.fft.fft(up, dim=-1) * rrc_response(N * os, os, fb, beta, dev),
                         dim=-1)
    del up
    sig = sig / torch.sqrt(torch.mean(sig.abs() ** 2, dim=-1, keepdim=True))
    sig = torch.roll(sig, int(pil_mask.sum()), dims=-1)
    fs, L = os * fb, N * os
    steps = torch.randn((nmodes, L), generator=g, device=dev, dtype=torch.float32).double()
    ph = torch.cumsum(steps * math.sqrt(2 * math.pi * linewidth_hz / fs), dim=-1).float()
    del steps
    sig = sig * torch.polar(torch.ones_like(ph), ph)
    del ph
    strength = torch.sqrt(torch.mean(sig.abs() ** 2)) * (10 ** (-snr_db / 20) * math.sqrt(fs / fb))
    nr = torch.randn((nmodes, L), generator=g, device=dev, dtype=torch.float32)
    ni = torch.randn((nmodes, L), generator=g, device=dev, dtype=torch.float32)
    sig = sig + (strength / math.sqrt(2)) * torch.complex(nr, ni)
    del nr, ni
    omega = 2 * math.pi * (torch.arange(L, device=dev, dtype=torch.float64) / L - 0.5) * fs
    Sf = torch.fft.fftshift(torch.fft.fft(torch.fft.ifftshift(sig, dim=-1), dim=-1), dim=-1)
    del sig
    Sf = _rotation(pmd_theta, dev) @ Sf
    dph = torch.stack([-omega * dgd_s / 2, omega * dgd_s / 2]).float()
    del omega
    Sf = Sf * torch.polar(torch.ones_like(dph), dph)
    del dph
    Sf = _rotation(-pmd_theta, dev) @ Sf
    sig = torch.fft.fftshift(torch.fft.ifft(torch.fft.ifftshift(Sf, dim=-1), dim=-1), dim=-1)
    del Sf
    planes = torch.cat([sig.real, sig.imag]).contiguous()
    return PilotTx(planes, idx, coded, torch.as_tensor(bits_h, device=dev))
