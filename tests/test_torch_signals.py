"""The port's signal objects against the JAX package's.

Both packages draw their bits from numpy (``RandomState(seed)`` and the
LFSRs), so one seed gives bit-equal samples, symbols, coded symbols, bits
and bit maps. A received capture is made once (by the JAX package's
impairments) and handed to both as numpy arrays, or carried across whole
by ``convert.signal_from_jax``. Counts (SER, BER) must be equal; metrics
that sum float32 values in another order (EVM, SNR, GMI, MI) agree within
the rtol each test states.
"""
import numpy as np
import jax.random as jr
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu import impairments as rimp
from qampy_tpu import signals as rsig
from qampy_tpu_torch import signals as tsig
from qampy_tpu_torch.convert import signal_from_jax

CPU = "cpu"
RTOL_SUM = 2e-5


@pytest.fixture(autouse=True, scope="module")
def first_vml_call():
    """Make the process's first ``torch.cos`` and ``torch.sin`` calls before any comparison.

    On the CPU build of torch these tests run with (MKL's vector math), the
    first call in a process now and then returns one parallel chunk of 4096
    values about 1e-4 off, as if that thread ran the low-accuracy mode; every
    later call is right (ROADMAP queue C). The port's arithmetic is what
    these tests hold, so the library's first call is made here.
    """
    x = torch.linspace(-4, 4, 2 ** 16)
    torch.cos(x)
    torch.sin(x)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def fields_of(sig):
    """A JAX signal's arrays and metadata, the dict ``convert.signal_from_jax`` takes."""
    f = dict(samples=np.array(sig.samples), fb=sig.fb, fs=sig.fs)
    f["class"] = type(sig).__name__
    if isinstance(sig, rsig.SignalWithPilots):
        return dict(f, frame_len=sig.frame_len, pilot_seq_len=sig.pilot_seq_len,
                    pilot_ins_rat=sig.pilot_ins_rat, pilot_scale=sig.pilot_scale,
                    payload=fields_of(sig._symbols_obj), pilots=fields_of(sig._pilots_obj))
    f.update(symbols=np.asarray(sig.symbols), M=sig.M,
             coded_symbols=None if sig.coded_symbols is None else np.asarray(sig.coded_symbols))
    if isinstance(sig, rsig.SignalQAMGrayCoded):
        f["bits"] = np.asarray(sig.bits)
    return f


def _same_signal(t, r):
    """Samples, symbols, coded symbols, bits and bit map equal; metadata equal."""
    assert type(t).__name__ == type(r).__name__
    assert np.array_equal(_np(t.samples), np.asarray(r.samples))
    assert np.array_equal(_np(t.symbols), np.asarray(r.symbols))
    assert (t.fb, t.fs, t.os) == (r.fb, r.fs, r.os) and t.M == r.M
    if r.coded_symbols is not None:
        assert np.array_equal(_np(t.coded_symbols), np.asarray(r.coded_symbols))
        assert np.array_equal(t.coded_symbols_host, np.asarray(r.coded_symbols))
    if isinstance(r, rsig.SignalQAMGrayCoded):
        assert np.array_equal(t.bits, np.asarray(r.bits))
        assert np.array_equal(_np(t.bitmap_mtx), np.asarray(r.bitmap_mtx))
        assert np.array_equal(t._encoding, r._encoding) and np.array_equal(t._code, r._code)


def _pair(kind):
    """(port, reference) signals of one construction."""
    if kind == "qam16":
        return (tsig.SignalQAMGrayCoded(16, 3000, nmodes=2, fb=10e9, seed=5, device=CPU),
                rsig.SignalQAMGrayCoded(16, 3000, nmodes=2, fb=10e9, seed=5))
    if kind == "qam64":
        return (tsig.SignalQAMGrayCoded(64, 2000, nmodes=1, seed=11, device=CPU),
                rsig.SignalQAMGrayCoded(64, 2000, nmodes=1, seed=11))
    if kind == "cross32":
        return (tsig.SignalQAMGrayCoded(32, 2000, nmodes=2, seed=2, device=CPU),
                rsig.SignalQAMGrayCoded(32, 2000, nmodes=2, seed=2))
    if kind == "prbs":
        return (tsig.SignalQAMGrayCoded(4, 4000, nmodes=2, bitclass=tsig.PRBSBits, seed=(3, 9),
                                        order=(7, 15), device=CPU),
                rsig.SignalQAMGrayCoded(4, 4000, nmodes=2, bitclass=rsig.PRBSBits, seed=[3, 9],
                                        order=[7, 15]))
    if kind == "psk8":
        return (tsig.SignalPSKGrayCoded(8, 2000, nmodes=2, seed=4, device=CPU),
                rsig.SignalPSKGrayCoded(8, 2000, nmodes=2, seed=4))
    if kind == "bert":
        kw = dict(prbsorders=((15,), (7,)), prbsshifts=(3, 100), prbsinvert=(True, False))
        return tsig.QPSKfromBERT(3000, nmodes=1, device=CPU, **kw), rsig.QPSKfromBERT(3000, **kw)
    if kind == "symbol_only":
        alphabet = np.exp(2j * np.pi * np.arange(6) / 6).astype(np.complex64)
        return (tsig.SymbolOnlySignal(6, 1000, alphabet, nmodes=2, seed=0, device=CPU),
                rsig.SymbolOnlySignal(6, 1000, alphabet, nmodes=2, seed=0))
    if kind == "tdhqam":
        return (tsig.TDHQAMSymbols((16, 4), 1200, fr=1 / 3, seed=0, device=CPU),
                rsig.TDHQAMSymbols((16, 4), 1200, fr=1 / 3, seed=0))
    raise ValueError(kind)


KINDS = ["qam16", "qam64", "cross32", "prbs", "psk8", "bert", "symbol_only", "tdhqam"]


@pytest.mark.parametrize("kind", KINDS)
def test_construction_equals_reference(kind):
    t, r = _pair(kind)
    _same_signal(t, r)
    if kind == "tdhqam":
        _same_signal(t.symbols_M1, r.symbols_M1)
        _same_signal(t.symbols_M2, r.symbols_M2)
        assert (t.powratio, t.f_M, t.f_M1, t.f_M2) == (r.powratio, r.f_M, r.f_M1, r.f_M2)


def test_pilot_signal_equals_reference():
    """SignalWithPilots: the frame, the payload and pilot objects and the layout."""
    kw = dict(nframes=3, nmodes=2, seed=7)
    t = tsig.SignalWithPilots(16, 2 ** 10, 64, 16, device=CPU, **kw)
    r = rsig.SignalWithPilots(16, 2 ** 10, 64, 16, **kw)
    assert np.array_equal(_np(t.samples), np.asarray(r.samples))
    _same_signal(t._symbols_obj, r._symbols_obj)
    _same_signal(t._pilots_obj, r._pilots_obj)
    for name in ("pilots", "pilot_seq", "ph_pilots", "symbols", "coded_symbols", "bitmap_mtx"):
        assert np.array_equal(_np(getattr(t, name)), np.asarray(getattr(r, name))), name
    for name in ("idx_payload", "idx_pilots", "idx_pil"):
        assert np.array_equal(getattr(t, name), getattr(r, name)), name
    assert (t.nframes, t.frame_len, t.pilot_seq_len, t.pilot_ins_rat, t.M, t.Mpilots,
            t.Nbits) == (r.nframes, r.frame_len, r.pilot_seq_len, r.pilot_ins_rat, r.M,
                         r.Mpilots, r.Nbits)
    for frames in (None, [1], [0, 2]):
        assert np.array_equal(_np(t.get_data(frames).samples), np.asarray(r.get_data(frames)))
        assert np.array_equal(_np(t.extract_pilots(frames).samples),
                              np.asarray(r.extract_pilots(frames)))
    assert float(t.cal_ser()[0]) == 0 and float(t.cal_ber()[1]) == 0
    assert np.array_equal(tsig.cal_pilot_idx(2 ** 10, 64, 16)[2],
                          rsig.SignalWithPilots._cal_pilot_idx(2 ** 10, 64, 16)[2])


def test_pilot_signal_from_symbol_array():
    """from_symbol_array with given pilots and with explicit pilot positions."""
    payload_r = rsig.SignalQAMGrayCoded(16, 900, nmodes=2, seed=3)
    payload_t = tsig.SignalQAMGrayCoded(16, 900, nmodes=2, seed=3, device=CPU)
    pil_r = rsig.SignalQAMGrayCoded(4, 124, nmodes=2, seed=8)
    pil_t = tsig.SignalQAMGrayCoded(4, 124, nmodes=2, seed=8, device=CPU)
    for kw in (dict(), dict(pilot_idx=np.arange(0, 1024, 8)[:124])):
        r = rsig.SignalWithPilots.from_symbol_array(payload_r, 1024, 64, 16, pilots=pil_r,
                                                    nframes=2, **kw)
        t = tsig.SignalWithPilots.from_symbol_array(payload_t, 1024, 64, 16, pilots=pil_t,
                                                    nframes=2, device=CPU, **kw)
        assert np.array_equal(_np(t.samples), np.asarray(r.samples))
        assert np.array_equal(_np(t.get_data().samples), np.asarray(r.get_data()))


@pytest.mark.parametrize("M", [4, 16, 64, 128])
def test_modulate_demodulate(M):
    t = tsig.SignalQAMGrayCoded(M, 1000, nmodes=2, seed=M, device=CPU)
    r = rsig.SignalQAMGrayCoded(M, 1000, nmodes=2, seed=M)
    bits = np.random.default_rng(M).integers(0, 2, (2, 600)).astype(bool)
    assert np.array_equal(_np(t.modulate(bits)), np.asarray(r.modulate(bits)))
    assert np.array_equal(_np(t.demodulate(t.samples)), np.asarray(r.demodulate(r.samples)))
    assert np.array_equal(_np(t.demodulate(t.samples)), t.bits)
    idx = np.random.default_rng(1).integers(0, M, (2, 50))
    assert np.array_equal(_np(t.demodulate(idx)), np.asarray(r.demodulate(idx)))
    fb_t = tsig.SignalQAMGrayCoded.from_bit_array(bits[:, :597], M, device=CPU)
    fb_r = rsig.SignalQAMGrayCoded.from_bit_array(bits[:, :597], M)
    _same_signal(fb_t, fb_r)
    noisy = np.asarray(r.samples) * 1.01 + 0.01
    fs_t = tsig.SignalQAMGrayCoded.from_symbol_array(noisy, M=M, device=CPU)
    fs_r = rsig.SignalQAMGrayCoded.from_symbol_array(noisy, M=M)
    _same_signal(fs_t, fs_r)


@pytest.fixture(scope="module")
def received():
    """16-QAM at 12 dB through the JAX package's impairments, and both signals."""
    r = rsig.SignalQAMGrayCoded(16, 2 ** 13, nmodes=2, fb=40e9, seed=2)
    n = rimp.change_snr(r, 12, key=jr.PRNGKey(9))
    return n, signal_from_jax(fields_of(n), CPU)


def test_signal_from_jax(received):
    n, t = received
    _same_signal(t, n)
    for kind in ("psk8", "symbol_only", "bert"):
        r = _pair(kind)[1]
        _same_signal(signal_from_jax(fields_of(r), CPU), r)
    p = rsig.SignalWithPilots(64, 2 ** 10, 64, 32, nframes=2, nmodes=2, seed=1)
    tp = signal_from_jax(fields_of(p), CPU)
    assert np.array_equal(_np(tp.samples), np.asarray(p.samples))
    _same_signal(tp._symbols_obj, p._symbols_obj)
    assert np.array_equal(_np(tp.get_data().samples), np.asarray(p.get_data()))


def test_metrics_equal_reference(received):
    """SER and BER equal counts; EVM, SNR within RTOL_SUM; GMI and MI within 1e-5."""
    n, t = received
    assert np.array_equal(_np(t.cal_ser()), np.asarray(n.cal_ser()))
    assert np.array_equal(_np(t.cal_ber()), np.asarray(n.cal_ber()))
    np.testing.assert_allclose(_np(t.cal_evm()), np.asarray(n.cal_evm()), rtol=RTOL_SUM)
    np.testing.assert_allclose(_np(t.cal_evm(blind=True)), np.asarray(n.cal_evm(blind=True)),
                               rtol=RTOL_SUM)
    np.testing.assert_allclose(_np(t.est_snr()), np.asarray(n.est_snr()), rtol=RTOL_SUM)
    for kw in (dict(), dict(llr_minmax=True), dict(snr=12.0)):
        g_t, pb_t = t.cal_gmi(**kw)
        g_r, pb_r = n.cal_gmi(**kw)
        np.testing.assert_allclose(g_t, g_r, rtol=1e-5)
        np.testing.assert_allclose(pb_t, pb_r, rtol=1e-5)
    np.testing.assert_allclose(t.cal_mi(), n.cal_mi(), rtol=1e-5)
    np.testing.assert_allclose(t.cal_mi(snr=12.0, fast=False), n.cal_mi(snr=12.0, fast=False),
                               rtol=1e-5)
    ser, errs, tx = t.cal_ser(verbose=True)
    assert errs.shape == tx.shape == (2, 2 ** 13)
    d_t = _np(t.make_decision())
    assert np.array_equal(d_t, np.asarray(n.make_decision()))


@pytest.mark.parametrize("case", ["shift", "quarter turns", "swapped modes", "cut", "longer",
                                  "synced"])
def test_sync_and_adjust(received, case):
    """_sync_and_adjust: the reference's pairing, offsets and turns, so equal counts."""
    n, t = received
    E = np.asarray(n.samples)
    if case == "shift":
        rx = np.roll(E, (37, -5), axis=(-1, -1))
    elif case == "quarter turns":
        rx = np.stack([np.roll(E[0], 100) * 1j, E[1] * -1]).astype(np.complex64)
    elif case == "swapped modes":
        rx = np.roll(E[::-1], 11, axis=-1) * np.complex64(-1j)
    elif case == "cut":
        rx = E[:, 300:-200] * np.complex64(1j)
    elif case == "longer":
        rx = np.concatenate([E, E[:, :777]], axis=-1)
    else:
        rx = E[:, :5000]
    synced = case == "synced"
    rx = np.ascontiguousarray(rx.astype(np.complex64))
    assert np.array_equal(_np(t.cal_ser(torch.as_tensor(rx), synced=synced)),
                          np.asarray(n.cal_ser(rx, synced=synced)))
    assert np.array_equal(_np(t.cal_ber(torch.as_tensor(rx), synced=synced)),
                          np.asarray(n.cal_ber(rx, synced=synced)))
    tx_t, rx_t = t._sync_and_adjust(t.symbols, torch.as_tensor(rx), synced)
    tx_r, rx_r = n._sync_and_adjust(n.symbols, rx, synced)
    assert np.array_equal(_np(tx_t), np.asarray(tx_r)) and np.array_equal(_np(rx_t),
                                                                          np.asarray(rx_r))


def test_attributes_carried_over():
    s = tsig.SignalQAMGrayCoded(16, 1000, nmodes=2, fb=10e9, seed=5, device=CPU)
    for out in (s * 2, s + 1, 1 - s, s / 2.0, 2.0 / (s + 3), -s, s.conj(), s[:, ::2], s * s,
                s.copy(), s.recreate_from_np_array(np.asarray(s) * 2)):
        assert isinstance(out, tsig.SignalQAMGrayCoded)
        assert (out.M, out.fb, out.Nbits) == (16, 10e9, 4)
        assert out.bits is s.bits and out.coded_symbols_host is s.coded_symbols_host
    assert s[:, ::2].shape == (2, 500) and len(s) == 2 and s.ndim == 2
    assert np.array_equal(np.asarray(s * 2), 2 * _np(s.samples))
    r2 = s.recreate_from_np_array(np.asarray(s), fb=20e9)
    assert (r2.fb, r2.fs, r2.os) == (20e9, 20e9, 1)
    r3 = s.replace(fs=20e9)
    assert r3.os == 2 and s.os == 1
    with pytest.raises(AttributeError, match="no field"):
        s.replace(nonsense=1)
    assert tsig.SignalBase is tsig.Signal
    b = tsig.Signal(np.ones((2, 8), np.complex64), device=CPU)
    assert b.coded_symbols is None and b.symbols is b.samples
    assert s.to("cpu").device.type == "cpu"


def test_normalize_and_center(received):
    n, t = received
    for kw in (dict(), dict(symbol_based=True)):
        np.testing.assert_allclose(_np(t.normalize_and_center(**kw).samples),
                                   np.asarray(n.normalize_and_center(**kw).samples),
                                   rtol=RTOL_SUM, atol=1e-6)


def test_symbol_only_and_hybrid_metrics():
    t, r = _pair("symbol_only")
    assert np.array_equal(_np(t.cal_ser()), np.asarray(r.cal_ser()))
    for name in ("cal_ber", "cal_gmi", "demodulate", "modulate"):
        with pytest.raises(NotImplementedError):
            getattr(t, name)()
    fs = tsig.SymbolOnlySignal.from_symbol_array(np.asarray(r) * 1.05,
                                                 coded_symbols=t.coded_symbols_host, device=CPU)
    assert np.array_equal(_np(fs.samples), np.asarray(
        rsig.SymbolOnlySignal.from_symbol_array(np.asarray(r) * 1.05,
                                                coded_symbols=np.asarray(r.coded_symbols))))
    th, rh = _pair("tdhqam")
    m1_t, m2_t = th._divide_signal_frame(th.samples)
    m1_r, m2_r = rh._divide_signal_frame(rh.samples)
    assert np.array_equal(_np(m1_t.samples), np.asarray(m1_r)) and \
        np.array_equal(_np(m2_t.samples), np.asarray(m2_r))
    hy = tsig.TDHQAMSymbols.from_symbol_arrays(th.symbols_M1, th.symbols_M2, 1 / 3)
    assert np.array_equal(_np(hy.samples), _np(th.samples))


def test_deferred_methods_raise(tmp_path):
    """The parts that waited for core/resample, core/filter and core/io (ROADMAP A9b) run now,
    as the JAX package's do: ``resample`` and ``ResampledQAM`` within 1e-5 of the rms (float32
    FFTs of other libraries), ``save_to_file`` read back equal."""
    from qampy_tpu_torch.io import load_signal
    s = tsig.SignalQAMGrayCoded(4, 100, seed=1, device=CPU)
    r = rsig.SignalQAMGrayCoded(4, 100, seed=1)
    for t, j in ((s.resample(2, beta=0.1), r.resample(2, beta=0.1)),
                 (tsig.ResampledQAM(16, 100, fs=2, seed=0, device=CPU),
                  rsig.ResampledQAM(16, 100, fs=2, seed=0))):
        want = np.asarray(j.samples)
        assert t.fs == j.fs == 2 and t.shape == want.shape
        assert np.abs(_np(t.samples) - want).max() <= 1e-5 * np.sqrt(np.mean(np.abs(want) ** 2))
    s.save_to_file(tmp_path / "x")
    back = load_signal(tmp_path / "x", device=CPU)
    assert torch.equal(back.samples, s.samples) and np.array_equal(back.bits, s.bits)


def test_card_is_the_default_device(monkeypatch):
    """Without ``device`` a signal goes to the card: the device rule of the port's entry points."""
    seen = []
    monkeypatch.setattr(tsig, "resolve_device", lambda d: seen.append(d) or torch.device("cpu"))
    tsig.SignalQAMGrayCoded(4, 100, seed=1)
    assert seen == [None]


@pytest.mark.parametrize("entry", ["cal_gmi", "sim_mi_mc"])
def test_theory_entries_default_to_the_card(monkeypatch, entry):
    """``theory.cal_gmi`` and ``theory.sim_mi_mc`` take ``device=None`` to the card, as every
    entry point does: resolved by ``resolve_device`` (here redirected to the CPU to see it
    asked), and without a card the call raises."""
    from qampy_tpu_torch import theory as ttheory
    call = {"cal_gmi": lambda: ttheory.cal_gmi(16, 10.0, N=200, seed=1),
            "sim_mi_mc": lambda: ttheory.sim_mi_mc(np.array([1, -1, 1j, -1j]), 10.0, 200)}[entry]
    seen = []
    monkeypatch.setattr(ttheory, "resolve_device",
                        lambda d: seen.append(d) or torch.device("cpu"))
    call()
    assert seen[:1] == [None]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            call()


def test_theory_anchor_on_the_port():
    """The verify skill's anchors on the port's own signal: SER within 5 % of theory at 12 dB and
    the SNR estimate within 0.3 dB (noise made by the port's impairments, CPU generator)."""
    from qampy_tpu_torch.core import impairments as timp
    from qampy_tpu_torch import theory as ttheory
    s = tsig.SignalQAMGrayCoded(16, 2 ** 16, nmodes=1, seed=2, device=CPU)
    gen = torch.Generator().manual_seed(9)
    n = s.replace(samples=timp.change_snr(s.samples, 12, s.fb, s.fs, gen))
    ser = float(n.cal_ser(synced=True)[0])
    ser_th = float(ttheory.ser_vs_es_over_n0_qam(10 ** 1.2, 16))
    assert abs(ser - ser_th) / ser_th < 0.05
    assert abs(10 * np.log10(float(n.est_snr(synced=True)[0])) - 12) < 0.3
    assert qt is not None
