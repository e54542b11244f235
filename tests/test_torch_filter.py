"""The port's filters (``core/filter.py``) against the JAX package's and scipy's.

The IIR filters in float32 are held to the JAX package on both sides of
its ``IIR_ASSOC_MIN_SAMPLES`` switch (N = 1,000 and 8,192; its own test's
rtol 2e-4 and atol 2e-5, tests/test_filter.py:198, since the two sum the
same recurrence in other orders); in float64 to scipy's ``sosfilt`` and
``lsim`` at rtol 1e-8 and atol 1e-10. The FFT filters agree with the JAX
package within 1e-5 of the output's rms (float32 FFTs of other libraries).
"""
import warnings

import jax
import numpy as np
import pytest
import scipy.signal as scisig
import torch

from qampy_tpu.core import filter as jfilter
from qampy_tpu_torch.core import filter as tfilter

RTOL32, ATOL32 = 2e-4, 2e-5
RTOL64, ATOL64 = 1e-8, 1e-10
FFT_REL = 1e-5


def _rms_close(got, want, rel=FFT_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.abs(got - want).max() <= rel * rms


def _jax_filter(x, *args, **kwargs):
    """The JAX package's filter_signal under one jit (op by op, its associative scan
    compiles each of its hundreds of small steps apart: ~20 s a call)."""
    return np.asarray(jax.jit(lambda v: jfilter.filter_signal(v, *args, **kwargs))(x))


def _x(shape, seed, cplx=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


@pytest.mark.parametrize("N", [1000, 8192])
@pytest.mark.parametrize("ftype, order, cplx", [("bessel", 1, False), ("bessel", 2, False),
                                                ("butter", 3, False), ("bessel", 4, False),
                                                ("butter", 4, True)])
def test_digital_iir_float32_matches_jax(N, ftype, order, cplx):
    x = _x((2, N), N + order, cplx, np.complex64 if cplx else np.float32)
    want = _jax_filter(x, 80e9, 16e9, ftype=ftype, order=order)
    got = tfilter.filter_signal(torch.as_tensor(x), 80e9, 16e9, ftype=ftype, order=order)
    assert got.dtype == torch.as_tensor(x).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL32, atol=ATOL32)


@pytest.mark.parametrize("N", [1000, 8192])
@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_analog_iir_float32_matches_jax(N, order):
    """Order 5 above 4,096 samples is the reference's sequential scan (its state cap)."""
    x = _x((2, N), 7 * order + N)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _jax_filter(x, 4.0, 0.3, ftype="bessel", order=order, analog=True)
    got = tfilter.filter_signal(torch.as_tensor(x), 4.0, 0.3, ftype="bessel", order=order,
                                analog=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL32, atol=ATOL32)


@pytest.mark.parametrize("N", [1000, 8192])
@pytest.mark.parametrize("ftype, order", [("bessel", 1), ("butter", 2), ("bessel", 3),
                                          ("butter", 4), ("bessel", 5)])
def test_sosfilt_float64_matches_scipy(N, ftype, order):
    x = _x((2, N), order, dtype=np.float64)
    design = scisig.bessel if ftype == "bessel" else scisig.butter
    kw = dict(norm="mag") if ftype == "bessel" else {}
    sos = design(order, 0.3, 'low', output='sos', fs=2, **kw)
    got = tfilter.filter_signal(torch.as_tensor(x), 2.0, 0.3, ftype=ftype, order=order)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), scisig.sosfilt(sos, x, axis=-1), rtol=RTOL64,
                               atol=ATOL64)


def test_sosfilt_complex128_matches_scipy():
    x = _x((2, 4500), 3, cplx=True, dtype=np.complex128)
    sos = scisig.butter(3, 0.3, 'low', output='sos', fs=2)
    got = tfilter.filter_signal(torch.as_tensor(x), 2.0, 0.3, ftype="butter", order=3)
    np.testing.assert_allclose(got.numpy(), scisig.sosfilt(sos, x, axis=-1), rtol=RTOL64,
                               atol=ATOL64)


def _lsim(ftype, order, u, fs, cutoff):
    Wn = cutoff * 2 * np.pi
    system = scisig.bessel(order, Wn, 'low', norm='mag', analog=True, output='ba') \
        if ftype == "bessel" else scisig.butter(order, Wn, 'low', analog=True, output='ba')
    t = np.arange(u.shape[-1]) / fs
    return np.stack([scisig.lsim(system, row, t)[1] for row in np.atleast_2d(u)])


@pytest.mark.parametrize("N", [512, 5000])
@pytest.mark.parametrize("ftype, order", [("bessel", 1), ("bessel", 2), ("butter", 3),
                                          ("butter", 4), ("bessel", 5)])
def test_lsim_float64_matches_scipy(N, ftype, order):
    u = _x((2, N), 11 + order, dtype=np.float64)
    got = tfilter.filter_signal(torch.as_tensor(u), 4.0, 0.3, ftype=ftype, order=order,
                                analog=True)
    np.testing.assert_allclose(got.numpy(), _lsim(ftype, order, u, 4.0, 0.3), rtol=RTOL64,
                               atol=ATOL64)


@pytest.mark.parametrize("order", [6, 8])
def test_high_order_analog_takes_the_same_path(order):
    """No state cap: the reference warns and scans per sample past order 4 above 4,096
    samples (tests/test_filter.py:241); the port's doubling form matches scipy there."""
    u = _x((1, 5000), 13, dtype=np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tfilter.filter_signal(torch.as_tensor(u), 4.0, 0.3, ftype="butter", order=order,
                                    analog=True)
    np.testing.assert_allclose(got.numpy(), _lsim("butter", order, u, 4.0, 0.3), rtol=RTOL64,
                               atol=ATOL64)


def test_lsim_filters_both_quadratures():
    """The documented deviation from scipy, as the JAX package pins it: Re and Im each
    filtered (scipy casts complex input to real)."""
    u = _x((256,), 5, cplx=True, dtype=np.complex128)
    got = tfilter.filter_signal(torch.as_tensor(u), 4.0, 0.25, ftype="bessel", order=2,
                                analog=True).numpy()
    np.testing.assert_allclose(got.real, _lsim("bessel", 2, u.real, 4.0, 0.25)[0], rtol=RTOL64,
                               atol=ATOL64)
    np.testing.assert_allclose(got.imag, _lsim("bessel", 2, u.imag, 4.0, 0.25)[0], rtol=RTOL64,
                               atol=ATOL64)


def test_prefix_states_match_the_recurrence():
    """affine_prefix_states against the loop s[k] = M s[k-1] + b[k] in float64, at a length
    that is no power of 2 and an M whose powers do not vanish within the passes."""
    rng = np.random.default_rng(2)
    M = np.array([[0.9, 0.3, 0.0], [-0.2, 0.8, 0.1], [0.05, 0.0, 0.95]])
    b = rng.standard_normal((777, 3, 4))
    s, want = np.zeros((3, 4)), np.empty_like(b)
    for k in range(b.shape[0]):
        s = M @ s + b[k]
        want[k] = s
    got = tfilter.affine_prefix_states(M, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_iir_is_deterministic():
    x = torch.as_tensor(_x((2, 9000), 4, cplx=True, dtype=np.complex64))
    a = tfilter.filter_signal(x, 80e9, 16e9, ftype="bessel", order=2)
    b = tfilter.filter_signal(x, 80e9, 16e9, ftype="bessel", order=2)
    assert torch.equal(a, b)


def test_unknown_filter_types_raise():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="unknown filter type"):
        tfilter.filter_signal(x, 2.0, 0.3, ftype="cheby")
    with pytest.raises(ValueError, match="unknown analog filter type"):
        tfilter.filter_signal(x, 2.0, 0.3, ftype="cheby", analog=True)


@pytest.mark.parametrize("ftype", ["gauss", "exp"])
@pytest.mark.parametrize("shape", [(2, 4096), (3001,)])
def test_spectral_filters_match_jax(ftype, shape):
    x = _x(shape, 8, cplx=True, dtype=np.complex64)
    want = jfilter.filter_signal(x, 80e9, 20e9, ftype=ftype)
    got = tfilter.filter_signal(torch.as_tensor(x), 80e9, 20e9, ftype=ftype)
    _rms_close(got.numpy(), want)


@pytest.mark.parametrize("n, m, cplx", [(4096, 101, True), (1000, 64, False), (5, 7, True)])
def test_fftconvolve_same_matches_jax(n, m, cplx):
    x = _x((2, n), n, cplx, np.complex64 if cplx else np.float32)
    h = _x((m,), m)
    want = np.asarray(jfilter.fftconvolve_same(x, h))
    got = tfilter.fftconvolve_same(torch.as_tensor(x), torch.as_tensor(h))
    assert got.dtype == torch.as_tensor(x).dtype
    _rms_close(got.numpy(), want)
    _rms_close(got.numpy(), np.stack([scisig.fftconvolve(r, h, 'same') for r in x]))


@pytest.mark.parametrize("shape", [(2, 2048), (1000,)])
def test_pre_filters_match_jax(shape):
    x = _x(shape, 9, cplx=True, dtype=np.complex64)
    want = jfilter.pre_filter(x, 8.0)
    assert np.abs(want).max() > 0.1
    _rms_close(tfilter.pre_filter(torch.as_tensor(x), 8.0).numpy(), want)
    # band edges off the bins k / (N / os), where float32 and float64 could differ
    for cf in (0, 0.3001):
        _rms_close(tfilter.pre_filter_wdm(torch.as_tensor(x), 0.7003, 2, center_freq=cf)
                   .numpy(), jfilter.pre_filter_wdm(x, 0.7003, 2, center_freq=cf))


@pytest.mark.parametrize("taps", [1001, 257, None])
@pytest.mark.parametrize("beta", [0.1, 0.5])
def test_rrcos_pulseshaping_matches_jax(taps, beta):
    x = _x((2, 4096), 10, cplx=True, dtype=np.complex64)
    want = jfilter.rrcos_pulseshaping(x, 80e9, 1 / 40e9, beta, taps=taps)
    got = tfilter.rrcos_pulseshaping(torch.as_tensor(x), 80e9, 1 / 40e9, beta, taps=taps)
    _rms_close(got.numpy(), want)
