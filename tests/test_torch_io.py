"""The port's signal files and matlab import (``core/io.py``, ``io.py``).

A saved signal holds its host form (numpy, no tensor), loads onto the
device asked for with every array and attribute equal; the matlab readers
are the JAX package's host code, so their arrays are equal.
"""
import pickle
import zlib

import numpy as np
import pytest
import scipy.io
import torch

import qampy_tpu as qt
from qampy_tpu import io as jio
from qampy_tpu_torch import io as tio
from qampy_tpu_torch import signals as tsig
from qampy_tpu_torch.core import io as tcio

CPU = "cpu"


def _equal(a, b):
    """Two objects' fields equal: tensors and arrays element for element, signals field by field."""
    if isinstance(a, tsig.Signal):
        assert type(a) is type(b) and a.__dict__.keys() == b.__dict__.keys()
        for k in a.__dict__:
            _equal(a.__dict__[k], b.__dict__[k])
    elif torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b)
    else:
        assert a == b


def _signals():
    pil = tsig.SignalWithPilots(16, 2 ** 10, 64, 16, nframes=2, nmodes=2, seed=1, device=CPU)
    pil.shiftfctrs, pil.synctaps = np.array([3, 5]), 17
    return {"qam": tsig.SignalQAMGrayCoded(64, 1000, nmodes=2, fb=20e9, seed=2, device=CPU),
            "resampled": tsig.ResampledQAM(4, 500, fb=10e9, fs=20e9, seed=3, device=CPU),
            "pilots": pil,
            "tdhqam": tsig.TDHQAMSymbols((16, 4), 600, fr=1 / 3, seed=0, device=CPU),
            "symbol_only": tsig.SymbolOnlySignal(6, 300, np.exp(2j * np.pi * np.arange(6) / 6),
                                                 seed=0, device=CPU)}


@pytest.mark.parametrize("kind", ["qam", "resampled", "pilots", "tdhqam", "symbol_only"])
def test_round_trip(tmp_path, kind):
    sig = _signals()[kind]
    fn = tmp_path / "sig.qz"
    sig.save_to_file(fn)
    back = tio.load_signal(fn, device=CPU)
    _equal(sig, back)
    if kind in ("qam", "resampled"):
        assert torch.equal(back.cal_ser(), sig.cal_ser())


def test_the_file_holds_the_host_form(tmp_path):
    """Every tensor of the signal, nested ones too, is numpy in the file."""
    sig = _signals()["pilots"]
    fn = tmp_path / "sig.qz"
    tcio.save_signal(fn, sig, lvl=1)
    raw = pickle.loads(zlib.decompress(fn.read_bytes()))

    def tensors(obj):
        if torch.is_tensor(obj):
            return 1
        if isinstance(obj, tsig.Signal):
            return sum(tensors(v) for v in obj.__dict__.values())
        return 0
    assert tensors(raw) == 0 and tensors(sig) > 0
    assert isinstance(raw.__dict__["samples"], tcio._HostTensor)


def test_other_objects_round_trip(tmp_path):
    obj = {"taps": torch.arange(6.).reshape(2, 3), "meta": (1, "a"), "host": np.ones(2)}
    fn = tmp_path / "obj.qz"
    tcio.save_signal(fn, obj)
    back = tcio.load_signal(fn, device=CPU)
    assert torch.equal(back["taps"], obj["taps"]) and back["meta"] == (1, "a")
    assert np.array_equal(back["host"], obj["host"])


def test_load_defaults_to_the_card(tmp_path):
    fn = tmp_path / "sig.qz"
    _signals()["qam"].save_to_file(fn)
    if torch.cuda.is_available():
        assert tio.load_signal(fn).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tio.load_signal(fn)


def _mat(tmp_path, rng):
    d = {"re0": rng.standard_normal((1, 400)), "im0": rng.standard_normal((1, 400)),
         "re1": rng.standard_normal((1, 400)), "im1": rng.standard_normal((1, 400)),
         "c": (rng.standard_normal((2, 400)) + 1j * rng.standard_normal((2, 400)))}
    fn = tmp_path / "syms.mat"
    scipy.io.savemat(fn, d)
    return str(fn)


@pytest.mark.parametrize("keys, kw", [([["c"]], {}), ([["c"]], dict(transpose=True)),
                                      ([["re0", "im0"]], {}),
                                      ([["re0", "im0"], ["re1", "im1"]], {}),
                                      ([["re0"], ["im0"], ["re1"], ["im1"]], dict(dim2cmplx=True))])
def test_ndarray_from_matlab(tmp_path, keys, kw):
    fn = _mat(tmp_path, np.random.default_rng(1))
    assert np.array_equal(tcio.ndarray_from_matlab(fn, keys, **kw),
                          jio.ndarray_from_matlab(fn, keys, **kw))


def test_ndarray_from_matlab_refuses_bad_keys(tmp_path):
    fn = _mat(tmp_path, np.random.default_rng(1))
    with pytest.raises(ValueError, match="wrong format"):
        tcio.ndarray_from_matlab(fn, [["re0", "im0", "c"]])


@pytest.mark.parametrize("kw", [dict(), dict(fake_polmux=True, fake_pm_delay=7)])
def test_symbols_from_matlab(tmp_path, kw):
    ref = qt.SignalQAMGrayCoded(16, 400, nmodes=1, seed=4)
    fn = tmp_path / "q.mat"
    scipy.io.savemat(fn, {"s": np.asarray(ref.symbols) * 3.0})
    want = jio.load_symbols_from_matlab_file(str(fn), 16, [["s"]], fb=10e9, **kw)
    got = tio.load_symbols_from_matlab_file(str(fn), 16, [["s"]], fb=10e9, device=CPU, **kw)
    assert isinstance(got, tsig.SignalQAMGrayCoded) and got.fb == 10e9 and got.M == 16
    # the alphabet's scale comes from the normalised symbols' power: float32 sums
    np.testing.assert_allclose(got.symbols.numpy(), np.asarray(want.symbols), rtol=1e-6)
    assert np.array_equal(got.bits, np.asarray(want.bits))


def test_create_signal_from_matlab(tmp_path):
    fn = _mat(tmp_path, np.random.default_rng(2))
    syms = tsig.SignalQAMGrayCoded(4, 200, nmodes=2, fb=10e9, seed=1, device=CPU)
    got = tio.create_signal_from_matlab(syms, fn, 20e9, [["c"]])
    want = np.atleast_2d(jio.ndarray_from_matlab(fn, [["c"]]))
    assert got.fs == 20e9 and got.os == 2 and got.shape == want.shape
    assert np.allclose(got.samples.numpy(), want.astype(got.samples.numpy().dtype))
