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


def signal_from_jax(fields, device):
    """The port's signal object of a JAX signal, from its arrays and metadata.

    ``fields``: a dict of plain values (what ``np.asarray`` gives for a JAX
    array) with the keys ``class`` (the class's name in
    ``qampy_tpu_torch.signals``), ``samples``, ``symbols``, ``fb``, ``fs``
    and ``M``; for the classes with bits also ``coded_symbols`` and
    ``bits``; for ``SymbolOnlySignal`` ``coded_symbols``; for
    ``SignalWithPilots`` ``frame_len``, ``pilot_seq_len``,
    ``pilot_ins_rat``, ``pilot_scale``, and ``payload`` and ``pilots``, each
    a dict of these keys of its own, and for a signal that ``sync2frame``
    synced its state: ``shiftfctrs``, ``synctaps`` and the coarse FOE
    ``foe`` (absent or None for an unsynced one). The Gray encoding and the bit map are
    rebuilt from the coded alphabet, as the reference builds them. Returns
    the signal on ``device``.
    """
    from qampy_tpu_torch import signals as sig_mod
    cls = getattr(sig_mod, fields["class"])
    obj = object.__new__(cls)
    if issubclass(cls, sig_mod.SignalWithPilots):
        payload = signal_from_jax(fields["payload"], device)
        pilots = signal_from_jax(fields["pilots"], device)
        sig_mod.Signal.__init__(obj, np.asarray(fields["samples"]), fb=fields["fb"],
                                fs=fields["fs"], device=device)
        _, idx_dat, _ = sig_mod.cal_pilot_idx(fields["frame_len"], fields["pilot_seq_len"],
                                              fields["pilot_ins_rat"])
        obj._set_frame(fields["frame_len"], fields["pilot_seq_len"], fields["pilot_ins_rat"],
                       payload, pilots, idx_dat, fields["pilot_scale"])
        if fields.get("shiftfctrs") is not None:
            obj._shiftfctrs = np.asarray(fields["shiftfctrs"]).astype(np.int64)
            obj._synctaps = int(fields["synctaps"])
            obj._foe = np.asarray(fields["foe"])
        return obj
    coded = fields.get("coded_symbols")
    sig_mod.Signal.__init__(obj, np.asarray(fields["samples"]), np.asarray(fields["symbols"]),
                            None if coded is None else np.asarray(coded), fb=fields["fb"],
                            fs=fields["fs"], M=fields["M"], device=device)
    if issubclass(cls, sig_mod.SignalQAMGrayCoded):
        coded = np.asarray(coded)
        M = int(fields["M"])
        nbits = int(np.log2(M))
        encoding = ((np.arange(M)[:, None] >> np.arange(nbits - 1, -1, -1)) & 1).astype(bool)
        obj._encoding = encoding
        obj._code = np.asarray([v ^ (v >> 1) for v in range(M)]) \
            if issubclass(cls, sig_mod.SignalPSKGrayCoded) else sig_mod.gray_code_qam(M)
        obj._bits = np.asarray(fields["bits"])
        from qampy_tpu_torch.core.metrics import generate_bitmapping_mtx
        obj._bitmap_mtx = torch.as_tensor(
            generate_bitmapping_mtx(coded, encoding, M, dtype=coded.dtype), device=obj.device)
    return obj
