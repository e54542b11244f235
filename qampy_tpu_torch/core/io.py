"""Saving and loading signal objects, and matlab import (counterpart of ``qampy_tpu/core/io.py``).

A signal is saved as a zlib-compressed pickle of its **host form**: every
tensor in it (the samples, the symbols, the alphabet, the payload and pilot
signals of a pilot signal) becomes a numpy array first, so a file written
on a machine with a card loads on one without. Loading puts those arrays
back as tensors on ``device``, the card unless the caller names another.

The files of the two packages are not interchangeable: one the JAX package
wrote holds its classes (pytrees of JAX arrays), which the port does not
read, and the JAX package does not read the port's. Unpickling runs code:
load only files this package wrote.
"""
from __future__ import annotations

import pickle
import zlib

import numpy as np
import torch

from qampy_tpu_torch.utils import resolve_device


class _HostTensor:
    """A tensor's values on the host, marked so that loading makes a tensor of them again."""

    def __init__(self, array):
        self.array = array


def _to_host(obj):
    from qampy_tpu_torch.signals import Signal
    if torch.is_tensor(obj):
        return _HostTensor(obj.detach().cpu().numpy())
    if isinstance(obj, Signal):
        out = object.__new__(type(obj))
        out.__dict__.update({k: _to_host(v) for k, v in obj.__dict__.items()})
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _to_device(obj, device):
    from qampy_tpu_torch.signals import Signal
    if isinstance(obj, _HostTensor):
        return torch.as_tensor(obj.array).to(device)
    if isinstance(obj, Signal):
        obj.__dict__.update({k: _to_device(v, device) for k, v in obj.__dict__.items()})
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


def save_signal(fn, signal, lvl=4):
    """Save a signal object (or any object holding tensors) as a zlib pickle of its host form.

    Reference core/io.py:29-46.
    """
    with open(fn, "wb") as fp:
        fp.write(zlib.compress(pickle.dumps(_to_host(signal), protocol=pickle.HIGHEST_PROTOCOL),
                               level=lvl))


def load_signal(fn, device=None):
    """Load what :func:`save_signal` wrote, its tensors on ``device`` (None: the card).

    Reference core/io.py:48-64.
    """
    with open(fn, "rb") as fp:
        obj = pickle.loads(zlib.decompress(fp.read()))
    return _to_device(obj, resolve_device(device))


def ndarray_from_matlab(fn, keys, transpose=False, dim2cmplx=False, portmap=[[0, 1], [2, 3]]):
    """Symbols of a matlab file as a (nmodes, N) host array (reference core/io.py:66-127).

    ``keys``: one or more entries, each [name] for a complex variable or
    [real name, imaginary name]; ``dim2cmplx`` pairs real rows into complex
    ones by ``portmap``. ``scipy.io.loadmat`` on the host, as in the reference.
    """
    from scipy.io import loadmat
    mat_dict = loadmat(fn)
    if len(keys) == 1:
        if len(keys[0]) == 2:
            symbs = mat_dict[keys[0][0]] + 1j * mat_dict[keys[0][1]]
        elif len(keys[0]) == 1:
            symbs = mat_dict[keys[0][0]]
        else:
            raise ValueError("Keys is in the wrong format, see documentation for correct format")
        if transpose:
            symbs = np.transpose(symbs)
    else:
        rows = []
        for i in range(len(keys)):
            if len(keys[0]) == 2:
                rows.append(mat_dict[keys[i][0]].flatten() + 1j * mat_dict[keys[i][1]].flatten())
            elif len(keys[0]) == 1:
                rows.append(mat_dict[keys[i][0]].flatten())
            else:
                raise ValueError("Keys is in the wrong format, see documentation for correct "
                                 "format")
        symbs = np.vstack(rows) if len(rows) > 1 else rows[0]
    if dim2cmplx:
        symbs = np.array([symbs[p[0]] + 1j * symbs[p[1]] for p in portmap])
    return symbs
