"""The port's resampling against the JAX package's.

``core/resample.py``, ``Signal.resample`` and ``ResampledQAM``.

The signals are built from one seed in both packages (bit-equal symbols);
the resampled samples agree within 1e-5 of their rms (float32 FFTs and RRC
taps of other libraries). ``resample_poly`` is scipy on the host in both.
"""
import numpy as np
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu.core import resample as jres
from qampy_tpu_torch import signals as tsig
from qampy_tpu_torch.core import resample as tres

CPU = "cpu"
REL = 1e-5


def _rms_close(got, want, rel=REL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.sqrt(np.mean(np.abs(want) ** 2))


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("fold, fnew, kw", [
    (1, 2, dict(beta=0.1)), (1, 2, dict(beta=0.2, taps=None)),
    (2, 3, dict(beta=0.5, renormalise=True)), (2, 3, dict(beta=0.01, taps=1001)),
    (2, 1, dict(beta=0.1)), (2, 1, dict(beta=0.2, taps=None)),
    (3, 2, dict(beta=0.5, renormalise=True))])
def test_rrcos_resample_matches_jax(fold, fnew, kw):
    x = _x((2, 3000), fold * 10 + fnew)
    want = jres.rrcos_resample(x, fold, fnew, **kw)
    got = tres.rrcos_resample(torch.as_tensor(x), fold, fnew, **kw)
    assert got.dtype == torch.complex64
    _rms_close(got, want)


def test_rrcos_resample_refuses_beta_out_of_range():
    with pytest.raises(ValueError, match="beta"):
        tres.rrcos_resample(torch.zeros(1, 8, dtype=torch.complex64), 1, 2, beta=1.5)


@pytest.mark.parametrize("renormalise", [False, True])
def test_resample_poly_matches_jax(renormalise):
    x = _x((1000,), 3)
    want = jres.resample_poly(x, 2, 3, renormalise=renormalise)
    got = tres.resample_poly(torch.as_tensor(x), 2, 3, renormalise=renormalise)
    _rms_close(got, want)
    # without beta, rrcos_resample is resample_poly
    _rms_close(tres.rrcos_resample(torch.as_tensor(x), 2, 3), jres.rrcos_resample(x, 2, 3))


@pytest.mark.parametrize("fold, fnew", [(10e9, 20e9), (32e9, 48e9), (25e9, 25e9 * 1.25)])
def test_resamplingfactors(fold, fnew):
    assert tres._resamplingfactors(fold, fnew) == jres._resamplingfactors(fold, fnew)


@pytest.mark.parametrize("factor, kw", [(2, dict(beta=0.1)), (1.5, dict(beta=0.3)),
                                        (2, dict(beta=0.5, renormalise=True))])
def test_signal_resample_matches_jax(factor, kw):
    r = qt.SignalQAMGrayCoded(16, 4000, nmodes=2, fb=20e9, seed=7)
    t = tsig.SignalQAMGrayCoded(16, 4000, nmodes=2, fb=20e9, seed=7, device=CPU)
    r2, t2 = r.resample(factor * r.fb, **kw), t.resample(factor * t.fb, **kw)
    _rms_close(t2.samples, r2.samples)
    assert (t2.fs, t2.fb, t2.os, t2.M) == (r2.fs, r2.fb, r2.os, r2.M)
    assert t2.dtype == torch.complex64 and torch.equal(t2.symbols, t.symbols)
    back = t2.resample(t2.fb, beta=kw["beta"])
    assert back.fs == t.fs and back.shape == t.shape


def test_signal_resample_to_its_own_rate_is_a_copy():
    t = tsig.SignalQAMGrayCoded(4, 1000, fb=10e9, seed=1, device=CPU)
    c = t.resample(10e9 * (1 + 1e-12), beta=0.1)
    assert c is not t and torch.equal(c.samples, t.samples) and c.fs == t.fs


def test_pilot_signal_resample_keeps_its_frame():
    r = qt.SignalWithPilots(64, 2 ** 12, 256, 32, nframes=2, nmodes=2, fb=24e9, seed=2)
    t = tsig.SignalWithPilots(64, 2 ** 12, 256, 32, nframes=2, nmodes=2, fb=24e9, seed=2,
                              device=CPU)
    r2 = r.resample(2 * r.fb, beta=0.1, renormalise=True)
    t2 = t.resample(2 * t.fb, beta=0.1, renormalise=True)
    _rms_close(t2.samples, r2.samples)
    assert isinstance(t2, tsig.SignalWithPilots) and t2.nframes == r2.nframes == 2
    assert np.array_equal(t2.pilot_seq.numpy(), np.asarray(r2.pilot_seq))


@pytest.mark.parametrize("fs, kw", [(40e9, {"beta": 0.1}), (30e9, {"beta": 0.3}),
                                    (20e9, {"beta": 0.1})])
def test_resampled_qam_matches_jax(fs, kw):
    r = qt.ResampledQAM(16, 2000, fb=20e9, fs=fs, nmodes=2, resamplekwargs=kw, seed=4)
    t = tsig.ResampledQAM(16, 2000, fb=20e9, fs=fs, nmodes=2, resamplekwargs=kw, seed=4,
                          device=CPU)
    _rms_close(t.samples, r.samples)
    assert (t.fs, t.fb, t.os) == (r.fs, r.fb, r.os)
    assert np.array_equal(t.symbols.numpy(), np.asarray(r.symbols))
    assert np.array_equal(t.bits, np.asarray(r.bits))


def test_resampled_qam_from_symbol_array():
    t = tsig.SignalQAMGrayCoded(4, 1000, fb=10e9, seed=1, device=CPU)
    out = tsig.ResampledQAM.from_symbol_array(t, 20e9, beta=0.1)
    assert out.fs == 20e9 and out.shape == (1, 2000)
    with pytest.raises(ValueError, match="Signal object"):
        tsig.ResampledQAM.from_symbol_array(np.zeros((1, 10)), 20e9)
