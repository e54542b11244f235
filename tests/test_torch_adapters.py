"""The signal-object adapters (``equalisation``, ``impairments``, ``filtering``,
``analog_frontend``), ``core/analog_frontend.py`` and ``core/pilotbased_transmitter.py``
against the JAX package's, on the CPU.

A JAX capture crosses with ``convert.signal_from_jax``, a synced pilot
capture with its ``shiftfctrs``, ``synctaps`` and coarse FOE, so both
packages' adapters run on the same samples. The trainers are held as in
tests/test_torch_equalise.py (taps within 1e-4, outputs within 1e-3, both
float32 recurrences), the frame filter within 1e-4 of the rms (the bound
tests/test_torch_equalise.py holds the filter to), the analog frontend
within 1e-6 of its output's peak (float32 means over the capture, summed
in other orders), the deterministic impairments within 1e-5 of the peak;
the random impairments by the statistics of their noise.
"""
import jax.random as jr
import numpy as np
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu import analog_frontend as jaf
from qampy_tpu import equalisation as jeqz
from qampy_tpu import filtering as jfil
from qampy_tpu import impairments as jimp
from qampy_tpu.core import analog_frontend as jcaf
from qampy_tpu.core import pilotbased_transmitter as jpbt
import qampy_tpu_torch as tq
from qampy_tpu_torch import analog_frontend as taf
from qampy_tpu_torch import equalisation as teqz
from qampy_tpu_torch import filtering as tfil
from qampy_tpu_torch import impairments as timp
from qampy_tpu_torch import signals as tsig
from qampy_tpu_torch.convert import signal_from_jax
from qampy_tpu_torch.core import analog_frontend as tcaf
from qampy_tpu_torch.core import pilotbased_transmitter as tpbt
from qampy_tpu_torch.workload import shared_decisions
from test_torch_signals import fields_of

CPU = "cpu"
TAPS_TOL = 1e-4
OUT_TOL = 1e-3
TOL = 1e-6


def _np(x):
    x = x.samples if hasattr(x, "samples") else x
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rms_close(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.sqrt(np.mean(np.abs(want) ** 2))


def _port(jsig):
    """A JAX signal (a synced pilot signal with its sync state) as the port's, on the CPU."""
    f = fields_of(jsig)
    if isinstance(jsig, qt.SignalWithPilots) and jsig.shiftfctrs is not None:
        f.update(shiftfctrs=np.asarray(jsig.shiftfctrs), synctaps=jsig.synctaps,
                 foe=np.asarray(jsig._foe))
    return signal_from_jax(f, CPU)


@pytest.fixture(scope="module")
def qam_capture():
    sig = qt.SignalQAMGrayCoded(16, 2 ** 12, nmodes=2, fb=20e9, seed=3)
    sig = sig.resample(2 * sig.fb, beta=0.2)
    sig = jimp.change_snr(sig, 25, key=jr.PRNGKey(1))
    return jimp.apply_PMD(sig, np.pi / 5.6, 10e-12)


@pytest.mark.parametrize("kw", [dict(method="mcma", backend="block", block_size=64, apply=True),
                                dict(method="cma", backend="seq", TrSyms=600, apply=True),
                                dict(method="sbd_data", backend="seq", TrSyms=500),
                                dict(method="mcma", backend="block", block_size=64, modes=[1])])
def test_equalise_signal_on_signals(qam_capture, kw):
    ref = jeqz.equalise_signal(qam_capture, 2e-3, Ntaps=11, **kw)
    got = teqz.equalise_signal(_port(qam_capture), 2e-3, Ntaps=11, **kw)
    assert len(got) == len(ref)
    assert np.abs(_np(got[-2]) - np.asarray(ref[-2])).max() <= TAPS_TOL
    if kw.get("apply"):
        out_g, out_r = got[0], ref[0]
        assert isinstance(out_g, tsig.SignalQAMGrayCoded)
        assert (out_g.fb, out_g.fs, out_g.os, out_g.M) == (out_r.fb, out_r.fs, 1, 16)
        assert np.abs(_np(out_g) - _np(out_r)).max() <= OUT_TOL
        assert torch.equal(out_g.symbols, torch.as_tensor(np.asarray(qam_capture.symbols)))


def test_dual_mode_equalisation_on_signals(qam_capture):
    kw = dict(methods=("mcma", "sbd"), backend="block", block_size=64)
    ref = jeqz.dual_mode_equalisation(qam_capture, (2e-3, 1e-3), 11, **kw)
    got = teqz.dual_mode_equalisation(_port(qam_capture), (2e-3, 1e-3), 11, **kw)
    assert np.abs(_np(got[1]) - np.asarray(ref[1])).max() <= TAPS_TOL
    assert np.abs(_np(got[0]) - _np(ref[0])).max() <= OUT_TOL
    assert got[0].cal_ser().tolist() == np.asarray(ref[0].cal_ser()).tolist()
    w, errs = teqz.dual_mode_equalisation(_port(qam_capture), (2e-3, 1e-3), 11, apply=False, **kw)
    assert torch.equal(w, got[1])


def test_apply_filter_on_a_plain_signal(qam_capture):
    rng = np.random.default_rng(2)
    w = ((rng.standard_normal((2, 2, 9)) + 1j * rng.standard_normal((2, 2, 9))) / 4
         ).astype(np.complex64)
    got = teqz.apply_filter(_port(qam_capture), w)
    _rms_close(got, jeqz.apply_filter(qam_capture, w))
    assert got.fs == got.fb == qam_capture.fb


@pytest.fixture(scope="module")
def frame_signal():
    sig = qt.SignalWithPilots(64, 2 ** 12, 256, 32, nframes=6, nmodes=2, fb=24e9, seed=3)
    return sig.resample(2 * sig.fb, beta=0.1)


@pytest.mark.parametrize("shifts, synctaps, frames", [
    ((40, 40), 17, (0, 1, 2)),          # contiguous frames, one shift: one segment
    ((40, 57), 17, (1, 2)),             # contiguous, the shifts differ: a segment a mode
    ((40, 57), 17, (0, 2, 3)),          # not contiguous: a mode and a frame each
    ((40, 40), 17, (1, 3)),             # not contiguous, one shift
    ((1, 6), 29, (0, 1))])              # more taps than the sync's: shifts wrap by a frame
def test_apply_to_pilotsignal_branches(frame_signal, shifts, synctaps, frames):
    """The reference's three branches of ``_apply_to_pilotsignal`` against the port's one
    frame filter call with (nout, nframes) window starts."""
    jsig = frame_signal.replace()
    jsig.shiftfctrs, jsig.synctaps = np.asarray(shifts), synctaps
    rng = np.random.default_rng(sum(shifts))
    w = ((rng.standard_normal((2, 2, 21)) + 1j * rng.standard_normal((2, 2, 21))) / 8
         ).astype(np.complex64)
    want = jeqz.apply_filter(jsig, w, frames=list(frames))
    got = teqz.apply_filter(_port(jsig), w, frames=list(frames))
    assert isinstance(got, tsig.SignalWithPilots) and got.os == 1
    _rms_close(got, want, 1e-4)


def test_apply_to_pilotsignal_refuses_a_short_signal(frame_signal):
    t = _port(frame_signal)
    t.shiftfctrs, t.synctaps = np.array([40, 40]), 17
    with pytest.raises(ValueError, match="not long enough"):
        teqz.apply_filter(t, np.ones((2, 2, 17), np.complex64), frames=[5])


@pytest.fixture(scope="module")
def synced():
    """A pilot capture synced by the JAX package, carried across with its sync state."""
    sig = qt.SignalWithPilots(64, 2 ** 12, 256, 32, nframes=3, nmodes=2, fb=24e9, seed=1)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    s3 = jimp.simulate_transmission(s2, snr=30, dgd=10e-12, freq_off=20e6, lwdth=20e3,
                                    roll_frame_sync=True, key=jr.PRNGKey(2))
    assert s3.sync2frame()
    return s3, _port(s3)


def test_synced_capture_crosses_with_its_state(synced):
    j, t = synced
    assert np.array_equal(t.shiftfctrs, np.asarray(j.shiftfctrs)) and t.synctaps == j.synctaps
    assert np.array_equal(t._foe, np.asarray(j._foe))
    jc, tc = j.replace(), t.replace()
    jc.corr_foe()
    tc.corr_foe()
    assert np.abs(_np(tc) - _np(jc)).max() <= 1e-4


@pytest.mark.parametrize("foe_comp, methods", [(False, ("cma", "cma")), (True, ("cma", "sbd"))])
def test_pilot_equaliser(synced, foe_comp, methods):
    j, t = synced
    kw = dict(foe_comp=foe_comp, methods=methods, Niter=3)
    taps_r, out_r, foe_r, nt_r = jeqz.pilot_equaliser(j, (1e-3, 1e-3), 21, verbose=True, **kw)
    taps_g, out_g, foe_g, nt_g = teqz.pilot_equaliser(t, (1e-3, 1e-3), 21, verbose=True, **kw)
    assert nt_g == nt_r and np.allclose(foe_g, np.asarray(foe_r), atol=1e-6)
    assert np.abs(taps_g - np.asarray(taps_r)).max() <= TAPS_TOL
    assert out_g.shape == (2, 2 ** 12) and np.abs(_np(out_g) - _np(out_r)).max() <= OUT_TOL
    coded = torch.as_tensor(np.asarray(j.coded_symbols))
    assert shared_decisions(out_g.samples[:, 300:], torch.as_tensor(_np(out_r)[:, 300:]),
                            coded) == 1.0
    taps_only = teqz.pilot_equaliser(t, (1e-3, 1e-3), 21, apply=False, **kw)
    assert np.array_equal(taps_only, taps_g)


def test_pilot_equaliser_nframes(synced):
    j, t = synced
    kw = dict(foe_comp=False, methods=("cma", "cma"), Niter=2, frames=[0, 1])
    taps_r, out_r, _ = jeqz.pilot_equaliser_nframes(j, (1e-3, 1e-3), 21, **kw)
    taps_g, out_g, rest = teqz.pilot_equaliser_nframes(t, (1e-3, 1e-3), 21, **kw)
    assert len(taps_g) == 2 and len(rest) == 2
    for a, b in zip(taps_g, taps_r):
        assert np.abs(a - np.asarray(b)).max() <= TAPS_TOL
    assert out_g.shape == (2, 2 * 2 ** 12)
    assert np.abs(_np(out_g) - _np(out_r)).max() <= OUT_TOL


def test_pilot_equalisers_need_a_synced_signal(frame_signal):
    t = _port(frame_signal)
    for fn in (teqz.pilot_equaliser, teqz.pilot_equaliser_nframes):
        with pytest.raises(ValueError, match="sync2frame"):
            fn(t, 1e-3, 21)


# ---------------------------------------------------------------------------
# impairments, filtering and the analog frontend on signal objects
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    j = qt.SignalQAMGrayCoded(16, 2048, nmodes=2, fb=20e9, seed=5).resample(40e9, beta=0.3)
    return j, _port(j)


@pytest.fixture(scope="module")
def short(pair):
    """The pair cut below the reference's IIR_ASSOC_MIN_SAMPLES, where its IIR filters run
    as a scan (its associative form compiles for ~10-20 s a call op by op)."""
    j, t = pair
    return j.replace(samples=j.samples[:, :4000]), t[:, :4000]


@pytest.mark.parametrize("name, args", [("apply_PMD", (0.4, 15e-12)),
                                        ("add_carrier_offset", (300e6,)),
                                        ("add_modal_delay", ((3, 11),)),
                                        ("sim_mod_response", ()),
                                        ("sim_mod_response", (0.9 + 1j, 0.95, 0.1))])
def test_deterministic_impairments(pair, name, args):
    """Within 1e-5 of the peak; the carrier offset within 1e-4, since the reference forms its
    phase in float32 (2 pi t fo / fs: 193 rad at the last sample here, ~3e-5 off), the port
    in float64 reduced to a turn (its check against the formula: tests/test_torch_pilots.py)."""
    j, t = pair
    want = _np(getattr(jimp, name)(j, *args))
    got = getattr(timp, name)(t, *args)
    assert type(got) is type(t) and (got.fs, got.fb) == (t.fs, t.fb)
    rel = 1e-4 if name == "add_carrier_offset" else 1e-5
    assert np.abs(_np(got) - want).max() <= rel * np.abs(want).max()


def test_add_dispersion_on_signals(pair):
    """Within 1e-3 of the rms of the reference, whose float32 phase rounds with omega^2."""
    j, t = pair
    _rms_close(timp.add_dispersion(t, 17e-6, 10e3), jimp.add_dispersion(j, 17e-6, 10e3), 1e-3)


def test_simulate_transmission_deterministic_parts():
    j = qt.SignalWithPilots(16, 2 ** 10, 64, 16, nframes=4, nmodes=2, fb=20e9, seed=2)
    t = _port(j)
    kw = dict(freq_off=100e6, dgd=12e-12, modal_delay=(5, 9), roll_frame_sync=True)
    want = _np(jimp.simulate_transmission(j, **kw))
    got = timp.simulate_transmission(t, **kw)
    # the carrier offset's float32 phase in the reference (see above)
    assert np.abs(_np(got) - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.warns(UserWarning, match="Only single frame"):
        timp.simulate_transmission(tsig.SignalWithPilots(16, 2 ** 10, 64, 16, seed=1,
                                                         device=CPU), roll_frame_sync=True)


def test_random_impairments(pair):
    """Noise power as set (within 3 % on 2 x 6000 samples), phase noise's variance per step
    (within 10 %), the same generator seed the same output, and None a fresh draw."""
    _, t = pair
    x = _np(t)
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    n = timp.change_snr(t, 20, generator=g(1))
    assert torch.equal(n.samples, timp.change_snr(t, 20, generator=g(1)).samples)
    assert not torch.equal(n.samples, timp.change_snr(t, 20).samples)
    p_n = np.mean(np.abs(_np(n) - x) ** 2)
    assert abs(p_n / (np.mean(np.abs(x) ** 2) * 10 ** (-2) * 2) - 1) < 0.03
    a = timp.add_awgn(t, 0.1, generator=g(2))
    assert abs(np.mean(np.abs(_np(a) - x) ** 2) / 0.01 - 1) < 0.03
    ph = np.angle(_np(timp.apply_phase_noise(t, 1e6, generator=g(3))) / x)
    var = np.var(np.diff(np.unwrap(ph, axis=-1), axis=-1))
    assert abs(var / (2 * np.pi * 1e6 / t.fs) - 1) < 0.1


def test_tx_and_dac_responses_on_signals(short):
    j, t = short
    kw = dict(enob=0, dac_params={"cutoff": 12e9, "fn": None, "ch": None})
    assert np.abs(_np(timp.sim_tx_response(t, **kw)) - _np(jimp.sim_tx_response(j, **kw))
                  ).max() <= 1e-5
    _rms_close(timp.sim_DAC_response(t, enob=0, cutoff=12e9),
               jimp.sim_DAC_response(j, enob=0, cutoff=12e9))


@pytest.mark.parametrize("name, args, kw", [("filter_signal", (12e9,), {}),
                                            ("filter_signal", (12e9,), dict(ftype="gauss")),
                                            ("filter_signal_analog", (12e9,), {}),
                                            ("pre_filter", (8.0,), {}),
                                            ("rrcos_pulseshaping", (0.3,), {})])
def test_filtering_on_signals(short, name, args, kw):
    j, t = short
    got = getattr(tfil, name)(t, *args, **kw)
    assert type(got) is type(t) and got.fs == t.fs
    _rms_close(got, getattr(jfil, name)(j, *args, **kw))


def test_moving_average_on_signals(pair):
    j, t = pair
    # the reference differences two float32 cumulative sums, whose rounding grows with the
    # row (4.3e-6 measured at 4,096 samples); the port sums each window
    np.testing.assert_allclose(_np(tfil.moving_average(t.real, 5)),
                               np.asarray(jfil.moving_average(np.asarray(j.samples).real, 5)),
                               rtol=1e-5, atol=1e-5)


def _imbalanced(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5000)) + 1j * rng.standard_normal((2, 5000))
    x = x.real + 1j * (0.8 * x.imag + 0.2 * x.real) + 0.1
    return x.astype(np.complex64)


@pytest.mark.parametrize("name, args", [("comp_IQ_inbalance", ()), ("comp_rf_delay", (3e-12,)),
                                        ("orthonormalize_signal", ()),
                                        ("orthonormalize_signal", (2,))])
def test_analog_frontend(name, args):
    x = _imbalanced(len(args))
    got = getattr(tcaf, name)(torch.as_tensor(x), *args)
    want = np.asarray(getattr(jcaf, name)(x, *args))
    assert np.abs(_np(got) - want).max() <= TOL * np.abs(want).max()
    one = getattr(tcaf, name)(torch.as_tensor(x[0]), *args)
    assert one.shape == (x.shape[-1],) or name == "orthonormalize_signal"


def test_analog_frontend_on_signals(pair):
    j, t = pair
    jx = j.replace(samples=np.asarray(_imbalanced(3)))
    tx = t.replace(samples=torch.as_tensor(_imbalanced(3)))
    for name, args in (("comp_IQ_inbalance", ()), ("comp_rf_delay", (3e-12,)),
                       ("orthonormalize_signal", ())):
        got = getattr(taf, name)(tx, *args)
        assert type(got) is type(t) and got.dtype == torch.complex64
        want = _np(getattr(jaf, name)(jx, *args))
        assert np.abs(_np(got) - want).max() <= TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# the pilot transmitter and the package's names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, args, kw", [
    ("gen_dataframe_with_phasepilots", (16, 2), dict(frame_len=2 ** 10, pilot_seq_len=64,
                                                     pilot_ins_ratio=16, seed=3)),
    ("gen_dataframe_without_phasepilots", (16, 2), dict(frame_len=2 ** 10, pilot_seq_len=64,
                                                        seed=4))])
def test_pilot_frames_equal_the_references(name, args, kw):
    want = getattr(jpbt, name)(*args, **kw)
    got = getattr(tpbt, name)(*args, device=CPU, **kw)
    assert isinstance(got, tsig.SignalWithPilots)
    assert np.array_equal(_np(got), _np(want))
    assert np.array_equal(_np(got.pilots), np.asarray(want.pilots))


def test_hybrid_pilot_frame():
    kw = dict(M=(16, 64), mod_ratio=(1, 1), npols=2, frame_len=2 ** 10, pilot_seq_len=64,
              pilot_ins_ratio=16, seed=2)
    want, wpay = jpbt.gen_dataframe_with_phasepilots_hybridmodulation(**kw)
    got, gpay = tpbt.gen_dataframe_with_phasepilots_hybridmodulation(device=CPU, **kw)
    assert isinstance(gpay, tsig.TDHQAMSymbols)
    # the larger order's points scaled by the power ratio in float32: within an ulp
    np.testing.assert_allclose(_np(gpay), _np(wpay), rtol=1e-6)
    # the pilots are drawn without a seed in both packages: the payload's places agree
    dat = got.idx_payload
    np.testing.assert_allclose(_np(got)[:, dat], _np(want)[:, dat], rtol=1e-6)
    with pytest.raises(ValueError, match="two modulation"):
        tpbt.gen_dataframe_with_phasepilots_hybridmodulation(M=(16,), device=CPU)


def test_sim_tx():
    j = jpbt.gen_dataframe_with_phasepilots(16, 2, frame_len=2 ** 10, pilot_seq_len=64,
                                            pilot_ins_ratio=16, seed=5, fb=20e9)
    t = tpbt.gen_dataframe_with_phasepilots(16, 2, frame_len=2 ** 10, pilot_seq_len=64,
                                            pilot_ins_ratio=16, seed=5, fb=20e9, device=CPU)
    kw = dict(modal_delay=(3, 7), freqoff=50e6, rot_angle=0.3, beta=0.2)
    want, got = jpbt.sim_tx(j, 2, **kw), tpbt.sim_tx(t, 2, **kw)
    assert got.os == 2 and isinstance(got, tsig.SignalWithPilots)
    _rms_close(got, want)
    noisy = tpbt.sim_tx(t, 2, snr=20, linewidth=1e5, generator=torch.Generator().manual_seed(1))
    assert noisy.shape == got.shape


def test_package_names():
    import qampy_tpu_torch.core as tcore
    assert tcore.ber_functions is tcore.sync and tcore.signal_quality is tcore.metrics
    assert tcore.special_fcts is tcore.special
    assert tcore.equalisation.__name__ == "qampy_tpu_torch.ops.equaliser"
    assert tcore.phaserecovery.__name__ == "qampy_tpu_torch.ops.phase"
    assert tcore.pilotbased_receiver.__name__ == "qampy_tpu_torch.ops.pilots"
    assert tcore.pilotbased_transmitter is tpbt and tcore.utils is tq.utils
    assert tcore.prbs is tq.prbs
    for name in ("equalisation", "phaserec", "impairments", "filtering", "analog_frontend", "io"):
        assert getattr(tq, name).__name__ == "qampy_tpu_torch." + name
    with pytest.raises(AttributeError):
        tcore.no_such_module


def test_the_port_imports_no_jax():
    """No module of the port imports JAX, the JAX package or triton at its top level (the
    modules imported at first use included): read from the sources, every import statement."""
    import ast
    import pathlib
    root = pathlib.Path(tq.__file__).parent
    bad = []
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += ["%s: %s" % (path.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "qampy_tpu", "triton")]
    assert not bad, bad
