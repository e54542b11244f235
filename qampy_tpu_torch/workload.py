"""The blind receiver's benchmark workload without JAX (counterpart of two pieces of ``bench.py``).

``make_tx`` synthesises the dual-pol capture host-side in numpy
(bench.py:24-87); ``ser_gate`` is the bench's correctness gate in torch
(bench.py:127-154).
"""
from __future__ import annotations

import numpy as np
import torch

from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam

#: the gate's edge trim: dec*N of the decimated search must stay inside it
GATE_TRIM = 200


def make_tx(Nsym=2 ** 20, M=64, fb=25e9, seed=1, snr=35):
    """Host-side TX synthesis: dual-pol M-QAM, RRC 2x oversampling, phase noise, AWGN, PMD.

    Same array as ``bench.make_tx`` for the same arguments (its shaped and
    custom-alphabet options are not ported). Returns (capture (2, 2*Nsym)
    complex64, transmitted symbols (2, Nsym) complex64, constellation).
    """
    rng = np.random.default_rng(seed)
    const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
    coded = const
    sym_idx = rng.integers(0, M, size=(2, Nsym))
    syms = coded[sym_idx]
    # zero-insertion upsample + RRC shaping (frequency domain)
    os = 2
    L = Nsym * os
    up = np.zeros((2, L), dtype=np.complex64)
    up[:, ::os] = syms
    f = np.fft.fftfreq(L) * (os * fb)
    T = 1 / fb
    beta = 0.1
    af = np.abs(f)
    rc = np.zeros(L)
    rc[af <= (1 - beta) / (2 * T)] = T
    mask = (af > (1 - beta) / (2 * T)) & (af <= (1 + beta) / (2 * T))
    rc[mask] = T / 2 * (1 + np.cos(np.pi * T / beta * (af[mask] - (1 - beta) / (2 * T))))
    h = np.sqrt(rc)
    h /= h.max()
    sig = np.fft.ifft(np.fft.fft(up, axis=-1) * h, axis=-1).astype(np.complex64)
    sig /= np.sqrt(np.mean(np.abs(sig) ** 2, axis=-1, keepdims=True))
    # phase noise (Wiener, 20 kHz combined linewidth)
    var = 2 * np.pi * 20e3 / (os * fb)
    ph = np.cumsum(rng.normal(scale=np.sqrt(var), size=(2, L)), axis=-1)
    sig = sig * np.exp(1j * ph).astype(np.complex64)
    # AWGN (os-aware; default 35 dB)
    n_amp = 10 ** (-snr / 20) * np.sqrt(os)
    sig = sig + (n_amp / np.sqrt(2) * (rng.standard_normal((2, L)) +
                 1j * rng.standard_normal((2, L)))).astype(np.complex64)
    # PMD: rotation + DGD in the frequency domain
    theta = np.pi / 5.6
    t_dgd = 50e-12
    omega = 2 * np.pi * np.linspace(-os * fb / 2, os * fb / 2, L, endpoint=False)
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    Sf = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(sig, axes=-1), axis=-1), axes=-1)
    Sf = R @ Sf
    Sf *= np.exp(np.array([-1, 1])[:, None] * 1j * omega * t_dgd / 2)
    Sf = R.T @ Sf
    sig = np.fft.fftshift(np.fft.ifft(np.fft.ifftshift(Sf, axes=-1), axis=-1), axes=-1)
    return sig.astype(np.complex64), syms.astype(np.complex64), coded


def decide(z, const):
    """Nearest constellation level per axis (round half to even, clamped), as complex."""
    levels = np.unique(np.asarray(const).real)
    d0, lo, n = float(levels[1] - levels[0]), float(levels[0]), int(levels.size)

    def q(x):
        return lo + d0 * torch.clamp(torch.round((x - lo) / d0), 0, n - 1)
    return torch.complex(q(z.real), q(z.imag))


def ser_gate(out, ref, const):
    """Symbol error rate of the recovered symbols, as the bench gates it.

    out: (nmodes, Lout) complex recovered symbols; ref: (nref, Nsym) complex
    transmitted symbols on the same device; const: the host constellation.
    After a 200-sample trim at both ends, each output mode is decided on the
    constellation's levels and compared against every transmitted mode at
    delays 3-5 (the taps-centre offset) under each pi/2 rotation; a symbol
    is wrong when the decision lies more than d0/4 from the reference. Each
    mode keeps its best pairing; the result is the mean over modes.
    """
    levels = np.unique(np.asarray(const).real)
    d0 = float(levels[1] - levels[0])
    o = out[:, GATE_TRIM:-GATE_TRIM]
    L = o.shape[1]
    sers = []
    for m in range(o.shape[0]):
        decs = [decide(o[m] * (1j ** rot), const) for rot in range(4)]
        cand = [torch.mean((torch.abs(dec - ref[rm, GATE_TRIM + off: GATE_TRIM + off + L])
                            > d0 / 4).to(torch.float32))
                for rm in range(ref.shape[0]) for off in (3, 4, 5) for dec in decs]
        sers.append(torch.min(torch.stack(cand)))
    return float(torch.mean(torch.stack(sers)))
