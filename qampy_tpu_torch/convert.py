"""Carry parameters and signals across from the JAX package.

Both take plain numpy arrays (what ``np.asarray`` gives for a JAX array),
so this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def taps_from_jax(wxy_np, device):
    """Taps of the JAX package, e.g. from ``fwd.with_taps``, as the port's taps.

    wxy_np: complex array of shape (nout, nmodes, Ntaps). Returns a complex64
    tensor of the same shape on ``device``.
    """
    w = np.asarray(wxy_np)
    if w.ndim != 3 or not np.iscomplexobj(w):
        raise ValueError("expected complex taps of shape (nout, nmodes, Ntaps), got %s %s"
                         % (w.dtype, w.shape))
    return torch.as_tensor(w.astype(np.complex64), device=device)


def planes_from_complex(E, device):
    """A complex (nmodes, L) signal as the stacked float32 [Re rows; Im rows] planes."""
    E = np.asarray(E)
    return torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=device)
