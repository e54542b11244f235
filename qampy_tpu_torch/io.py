"""Signal objects from and to files (counterpart of ``qampy_tpu/io.py``)."""
from __future__ import annotations

import numpy as np

from qampy_tpu_torch import helpers, signals
from qampy_tpu_torch.core.io import load_signal, ndarray_from_matlab, save_signal
from qampy_tpu_torch.utils import as_tensor, resolve_device

__all__ = ["save_signal", "load_signal", "load_symbols_from_matlab_file",
           "create_signal_from_matlab"]


def load_symbols_from_matlab_file(fn, M, keys, fb=10e9, fake_polmux=False, fake_pm_delay=0,
                                  normalise=True, device=None, **kwargs):
    """A QAM signal of the symbols in a matlab file (reference qampy/io.py:28-75).

    The file is read on the host (:func:`ndarray_from_matlab`, ``kwargs``);
    ``fake_polmux`` stacks a copy rolled by ``fake_pm_delay`` above the
    symbols, ``normalise`` centres and scales each mode; the signal is made
    in complex64, as the reference makes it, on ``device`` (None: the card).
    """
    symbs = np.atleast_2d(ndarray_from_matlab(fn, keys, **kwargs))
    if fake_polmux:
        symbs = np.vstack([np.roll(symbs, fake_pm_delay), symbs])
    symbs = as_tensor(symbs.astype(np.complex64), resolve_device(device))
    if normalise:
        symbs = helpers.normalise_and_center(symbs)
    return signals.SignalQAMGrayCoded.from_symbol_array(symbs, M, fb)


def create_signal_from_matlab(symbols, fn, fs, keys, **kwargs):
    """Measured samples of a matlab file attached to the signal ``symbols`` (reference :78-110)."""
    data = ndarray_from_matlab(fn, keys, **kwargs)
    return symbols.recreate_from_np_array(np.atleast_2d(data), fs=fs)
