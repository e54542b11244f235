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


def grid_from_jax(grid):
    """A grid spec of the JAX package's ``detect_grid`` as the port's: plain floats and ints.

    The two packages share the format ((d, lo, n), ("x", d, lo, n, c),
    ("r", d, lor, nr, loi, ni), ("gen", sr, si)); this checks the kind and
    the length and strips numpy scalar types.
    """
    if grid is None:
        raise ValueError("the constellation was not classified (grid spec None)")
    kind = grid[0] if isinstance(grid[0], str) else "sq"
    want = {"sq": 3, "x": 5, "r": 6, "gen": 3}
    if kind not in want or len(grid) != want[kind]:
        raise ValueError("not a grid spec: %r" % (grid,))
    if kind == "gen":
        return ("gen", tuple(float(x) for x in grid[1]), tuple(float(x) for x in grid[2]))
    ints = {"sq": (2,), "x": (3, 4), "r": (3, 5)}[kind]
    vals = [int(v) if i in ints else float(v) for i, v in enumerate(grid) if i or kind == "sq"]
    return tuple(vals) if kind == "sq" else (kind, *vals)


def decision_from_jax(method, symbols_np, grid=None):
    """The port's (``ErrSpec``, ``GridConsts``) for a method's symbols rows of the JAX package.

    symbols_np: the (nout, k) rows of the reference's ``_reshape_symbols``
    or ``generate_symbols_for_eq_from_alphabet`` for ``method``; ``grid``:
    the reference's grid spec of the constellation, for the searches (None:
    classified from the first row, which for cma, mcma and rde holds
    constants and gives no search constants). So a test builds both sides
    from one alphabet.
    """
    from qampy_tpu_torch.ops import equaliser as eqops
    from qampy_tpu_torch.ops import phase as phops
    spec = eqops.err_spec(method, np.asarray(symbols_np))
    if grid is None:
        if method not in eqops.DECISION_BLOCK_METHODS:
            return spec, None
        grid = spec.consts
    return spec, phops.grid_consts(grid_from_jax(grid))


def planes_from_complex(E, device):
    """A complex (nmodes, L) signal as the stacked float32 [Re rows; Im rows] planes.

    This is also the real-valued stacking of a capture that the real-valued
    equaliser methods train on (the reference's ``_convert_sig_to_real``).
    """
    E = np.asarray(E)
    return torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=device)


def pilot_state_from_jax(taps, shift, mode_order, device, foe=None):
    """The pilot chain's acquired state, ``info`` of the JAX package's chain, as the port's.

    taps: complex (nmodes, nmodes, Ntaps); shift and mode_order: integer
    (nmodes,) arrays. Returns (taps complex64, shift int64, mode_order
    int64) tensors on ``device``, ready for ``PilotRxChain.tracking_planes``;
    with ``foe`` (a scalar, ``info["foe_pil"]`` of a ``foe_comp`` chain) a
    fourth, the float32 0-d offset, which that entry takes after them.
    """
    shift, mode_order = np.asarray(shift), np.asarray(mode_order)
    if shift.ndim != 1 or mode_order.shape != shift.shape:
        raise ValueError("expected (nmodes,) shift and mode_order, got %s and %s"
                         % (shift.shape, mode_order.shape))
    if not (np.issubdtype(shift.dtype, np.integer)
            and np.issubdtype(mode_order.dtype, np.integer)):
        raise ValueError("shift and mode_order must be integer arrays")
    state = (taps_from_jax(taps, device),
             torch.as_tensor(shift.astype(np.int64), device=device),
             torch.as_tensor(mode_order.astype(np.int64), device=device))
    if foe is None:
        return state
    foe = np.asarray(foe)
    if foe.ndim != 0:
        raise ValueError("expected a scalar foe, got shape %s" % (foe.shape,))
    return state + (torch.as_tensor(foe.astype(np.float32), device=device),)
