"""Carry parameters and signals across from the JAX package.

Each takes plain numpy arrays (what ``np.asarray`` gives for a JAX array),
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


def symbols_from_jax(symbols_np, device):
    """The per-method ``symbols`` rows of the JAX package's ``_reshape_symbols`` as a tensor.

    symbols_np: (nout, k) array, complex for the complex methods (constants,
    codebooks or constellations per output mode), real for the real-valued
    ones. Returns a complex64 or float32 tensor on ``device``, the form the
    port's trainers take.
    """
    s = np.asarray(symbols_np)
    if s.ndim != 2:
        raise ValueError("expected (nout, k) rows of symbols, got shape %s" % (s.shape,))
    return torch.as_tensor(s.astype(np.complex64 if np.iscomplexobj(s) else np.float32),
                           device=device)


def planes_from_complex(E, device):
    """A complex (nmodes, L) signal as the stacked float32 [Re rows; Im rows] planes.

    This is also the real-valued stacking of a capture that the real-valued
    equaliser methods train on (the reference's ``_convert_sig_to_real``).
    """
    E = np.asarray(E)
    return torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=device)


def pilot_state_from_jax(taps, shift, mode_order, device):
    """The pilot chain's acquired state, ``info`` of the JAX package's chain, as the port's.

    taps: complex (nmodes, nmodes, Ntaps); shift and mode_order: integer
    (nmodes,) arrays. Returns (taps complex64, shift int64, mode_order
    int64) tensors on ``device``, ready for ``PilotRxChain.tracking_planes``.
    """
    shift, mode_order = np.asarray(shift), np.asarray(mode_order)
    if shift.ndim != 1 or mode_order.shape != shift.shape:
        raise ValueError("expected (nmodes,) shift and mode_order, got %s and %s"
                         % (shift.shape, mode_order.shape))
    if not (np.issubdtype(shift.dtype, np.integer)
            and np.issubdtype(mode_order.dtype, np.integer)):
        raise ValueError("shift and mode_order must be integer arrays")
    return (taps_from_jax(taps, device),
            torch.as_tensor(shift.astype(np.int64), device=device),
            torch.as_tensor(mode_order.astype(np.int64), device=device))
