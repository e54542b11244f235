"""``phaserec`` on the port's signal objects against the JAX package's.

The captures are the JAX package's (``tests/test_torch_phaserec.py``'s
builder), carried across by ``convert.signal_from_jax``. The searches must
keep the signal's attributes (tests/test_phaserec.py:37) and recover it
under the reference tests' gates; FOE, compensation, the pilot CPE and the
pilot constant phase agree with the reference within the stated tolerance.
"""
import numpy as np
import jax.random as jr
import pytest
import torch

from qampy_tpu import impairments as rimp
from qampy_tpu import phaserec as rphr
from qampy_tpu import signals as rsig
from qampy_tpu_torch import phaserec as tphr
from qampy_tpu_torch import signals as tsig
from qampy_tpu_torch.convert import signal_from_jax
from qampy_tpu_torch.ops import phase as tph
from test_torch_phaserec import _capture
from test_torch_signals import fields_of, first_vml_call  # noqa: F401 (autouse fixture)

CPU = "cpu"


@pytest.fixture(scope="module")
def qam64():
    return _capture(64, 100e3, 30, seed=3)


@pytest.fixture(scope="module")
def qam16():
    return _capture(16, 50, 30, seed=2)


def _ser(sig, n=20):
    return sig.replace(samples=sig.samples[:, n:-n]).cal_ser().numpy()


@pytest.mark.parametrize("fn, args", [("bps", (64, 14)), ("bps_twostage", (32, 14))])
def test_phaserec_bps_on_signals(qam64, fn, args):
    """Attributes carried over (tests/test_phaserec.py:37), SER 0 after the edges, and the same
    phase as the tensor driver's."""
    t = signal_from_jax(fields_of(qam64), CPU)
    kw = dict(B=8) if fn == "bps_twostage" else {}
    rec, ph = getattr(tphr, fn)(t, *args, **kw)
    assert isinstance(rec, tsig.SignalQAMGrayCoded) and (rec.M, rec.fb, rec.fs) == (64, 40e9, 40e9)
    assert rec.bits is t.bits and np.all(_ser(rec) == 0)
    _, ph2 = getattr(tph, fn)(t.samples, args[0], t.coded_symbols_host, args[1], **kw)
    assert torch.equal(ph, ph2)
    rec_r, _ = getattr(rphr, fn)(qam64, *args, **kw)
    assert np.array_equal(_ser(rec), np.asarray(rec_r.replace(
        samples=rec_r.samples[:, 20:-20]).cal_ser()))


def test_phaserec_vv_with_foe():
    """QPSK with a 50 MHz offset: FOE (this API's defaults, then 2^16 points), compensation, VV."""
    fb, fo = 40e9, 50e6
    r = _capture(4, 100, 25, seed=3, fo=fo)
    t = signal_from_jax(fields_of(r), CPU)
    for kw in (dict(), dict(fft_size=2 ** 16), dict(average_over_modes=True, fft_size=2 ** 16)):
        est_t, est_r = tphr.find_freq_offset(t, **kw), np.asarray(rphr.find_freq_offset(r, **kw))
        assert est_t.shape == est_r.shape == (2, 1)
        assert np.array_equal(est_t.numpy(), est_r)
    est = tphr.find_freq_offset(t, fft_size=2 ** 16)
    assert np.all(np.abs(est.numpy() * fb - fo) < 2 * fb / 2 ** 16)
    comp = tphr.comp_freq_offset(t, est)
    comp_r = rphr.comp_freq_offset(r, np.asarray(est))
    np.testing.assert_allclose(comp.samples.numpy(), np.asarray(comp_r.samples), atol=2e-5)
    rec, ph = tphr.viterbiviterbi(comp, 11)
    assert isinstance(rec, tsig.SignalQAMGrayCoded) and rec.M == 4
    assert np.all(_ser(rec) < 1e-3)


def test_phaserec_partition_on_signals(qam16):
    t = signal_from_jax(fields_of(qam16), CPU)
    rec, ph = tphr.phase_partition_16qam(t, 128)
    assert rec.M == 16 and np.all(_ser(rec, 200) < 1e-2)


@pytest.fixture(scope="module")
def pilot_capture():
    """A 3-frame pilot signal turned by a slow phase walk, in both packages."""
    p = rsig.SignalWithPilots(16, 2 ** 12, 256, 16, nframes=3, nmodes=2, seed=5)
    p = rimp.change_snr(p, 25, key=jr.PRNGKey(1))
    p = rimp.apply_phase_noise(p, 2e-6, key=jr.PRNGKey(2)) * np.exp(0.3j).astype(np.complex64)
    return p, signal_from_jax(fields_of(p), CPU)


@pytest.mark.parametrize("kw", [dict(), dict(N=5, pilot_rat=2), dict(use_seq=True, nframes=3),
                                dict(max_blocks=100, nframes=1)],
                         ids=["default", "N5 ratio2", "with sequence", "max blocks"])
def test_pilot_cpe(pilot_capture, kw):
    """Trace and output within 1e-4 (the averages are summed directly in the port, as a
    difference of cumulative sums in the reference: core/filter.py moving_average)."""
    r, t = pilot_capture
    out_t, tr_t = tphr.pilot_cpe(t, **kw)
    out_r, tr_r = rphr.pilot_cpe(r, **kw)
    assert isinstance(out_t, tsig.SignalWithPilots) and out_t.frame_len == 2 ** 12
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_r), atol=1e-4)
    np.testing.assert_allclose(out_t.samples.numpy(), np.asarray(out_r.samples), atol=2e-4)


def test_pilot_const_phase(pilot_capture):
    """find_pilot_const_phase and correct_pilot_const_phase, on signals and on arrays."""
    r, t = pilot_capture
    rec_r, rec_t = r.extract_pilots(frames=[0]), t.extract_pilots(frames=[0])
    ph_r = np.asarray(rphr.find_pilot_const_phase(rec_r.samples,
                                                  r._pilots_obj.samples[:, :rec_r.shape[1]]))
    ph_t = tphr.find_pilot_const_phase(rec_t, t._pilots_obj.samples[:, :rec_t.shape[1]])
    assert ph_t.shape == ph_r.shape == (2, 1)
    np.testing.assert_allclose(ph_t.numpy(), ph_r, atol=1e-5)
    cor_t = tphr.correct_pilot_const_phase(t, ph_t)
    cor_r = rphr.correct_pilot_const_phase(r, ph_r)
    assert isinstance(cor_t, tsig.SignalWithPilots)
    np.testing.assert_allclose(cor_t.samples.numpy(), np.asarray(cor_r.samples), atol=2e-5)
    arr_t = tphr.correct_pilot_const_phase(t.samples, ph_t)
    assert torch.equal(arr_t, cor_t.samples)
    one = tphr.find_pilot_const_phase(rec_t.samples[0], t.pilots[0, :rec_t.shape[1]])
    assert one.shape == (1, 1)
