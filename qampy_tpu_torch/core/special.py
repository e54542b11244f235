"""Pulse shapes and special functions on tensors (counterpart of ``qampy_tpu/core/special.py``).

Each takes a tensor (or numbers, which become a float32 tensor) and
computes in its dtype. ``erfc`` is ``torch.special.erfc`` on such a
tensor, standing in for ``jax.scipy.special.erfc``.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.as_tensor(x) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float32))


def ttanh(x, A, x0, w):
    """Amplitude/offset/width parametrised tanh (special.py:14-16)."""
    return A * torch.tanh((_t(x) - x0) / w)


def gauss(x, A, x0, w):
    """Gaussian (special.py:19-21)."""
    return A * torch.exp(-((_t(x) - x0) / w) ** 2 / 2.)


def supergauss(x, A, x0, w, o):
    """Super-Gaussian of order o (special.py:24-26)."""
    return A * torch.exp(-((_t(x) - x0) / w) ** (2 * o) / 2.)


def sech(x, A, x0, w):
    """Hyperbolic secant (special.py:29-31)."""
    return A / torch.cosh((_t(x) - x0) / w)


def rcos_time(t, beta, T):
    """Raised cosine time response (special.py:34-37)."""
    t = _t(t)
    return torch.sinc(t / T) * torch.cos(t / T * np.pi * beta) / (1 - 4 * (beta * t / T) ** 2)


def rcos_freq(f, beta, T):
    """Raised cosine frequency response (special.py:40-48)."""
    f = _t(f)
    af = f.abs()
    flat = af <= (1 - beta) / (2 * T)
    roll = (af > (1 - beta) / (2 * T)) & (af <= (1 + beta) / (2 * T))
    if beta > 0:
        rolled = T / 2 * (1 + torch.cos(np.pi * T / beta * (af - (1 - beta) / (2 * T))))
    else:
        rolled = torch.zeros_like(af)
    zero = torch.zeros_like(af)
    return torch.where(flat, torch.full_like(af, T), torch.where(roll, rolled, zero)).to(f.dtype)


def rrcos_freq(f, beta, T):
    """Root-raised cosine frequency response (special.py:50-53)."""
    return torch.sqrt(rcos_freq(f, beta, T))


def rrcos_time(t, beta, T):
    """Root-raised cosine impulse response (special.py:55-74).

    The removable singularities at t = 0 and |t| = T/(4 beta) are patched
    within a quarter of the sample spacing, as in the reference.
    """
    t = _t(t)
    if not t.is_floating_point():
        t = t.to(torch.get_default_dtype())
    eps = (t[0] - t[1]).abs() / 4
    denom = np.pi * t / T * (1 - (4 * beta * t / T) ** 2)
    safe = torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
    gen = 1 / T * ((torch.sin(np.pi * t / T * (1 - beta))
                    + 4 * beta * t / T * torch.cos(np.pi * t / T * (1 + beta))) / safe)
    at0 = 1 / T * (1 + beta * (4 / np.pi - 1))
    if beta > 0:
        atsing = beta / (T * np.sqrt(2)) * ((1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                                            + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        gen = torch.where((t.abs() - abs(T / (4 * beta))).abs() < eps,
                          torch.full_like(gen, atsing), gen)
    return torch.where(t.abs() < eps, torch.full_like(gen, at0), gen)


def erfc(x):
    """The complementary error function of a tensor or of numbers (the reference's import)."""
    return torch.special.erfc(_t(x))


def q_function(x):
    """Gaussian tail probability (special.py:76-78)."""
    return 0.5 * erfc(_t(x) / np.sqrt(2))
