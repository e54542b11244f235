"""BASELINE configs 1, 4 and 5 as wholes at a small size, the port beside the JAX examples' chains.

Config 1 (``examples/cma_equaliser.py``), config 4 (``examples/sim_pilot_txrx.py``)
and config 5 (the chain of ``examples/tx_impairment_simulation.py``), cut to
2^14 symbols (config 1) and to 3 frames of 2^12 symbols with a 256-symbol
pilot sequence (configs 4 and 5), everything else as in the examples
(but the frame search's passes, cut to 3 where the port searches too). The
port builds each capture with its own signal objects and impairments (its
generator's noise); the same samples go into a JAX signal, and both
packages' receivers run from there: the same frame sync, the taps within
1e-4, the payload's decisions shared (>= 99.9 %), BER and GMI alike. The
transmitter without its noise equals the JAX package's within 1e-4 of the
peak (the reference's carrier offset rounds its phase in float32).

At this size the pilot receiver fails on some captures in both packages
alike (ROADMAP queue C): the reference's receiver on the port's captures of
seeds 1-8 reads BER 0.18-0.33 on config 4's seeds 4 and 5 and on one mode
of config 5's seeds 3 and 7, 0.005-0.023 on the rest. The capture of seed 4
is held to the reference too (both fail); the gated ones are seeds 1 and 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu import equalisation as jeqz
from qampy_tpu import helpers as jhelp
from qampy_tpu import impairments as jimp
from qampy_tpu import phaserec as jph
from qampy_tpu.core import impairments as jcimp
from qampy_tpu_torch import equalisation as teqz
from qampy_tpu_torch import helpers as thelp
from qampy_tpu_torch import impairments as timp
from qampy_tpu_torch import phaserec as tph
from qampy_tpu_torch import signals as tsig
from qampy_tpu_torch.core import impairments as tcimp
from qampy_tpu_torch.core.metrics import decision_idx
from test_torch_adapters import _np

CPU = "cpu"
F, P, R = 2 ** 12, 256, 32
NPIL = P + (F - P) // R          # a frame's pilots: the sequence and the phase pilots
# where the port runs its own frame search (a per-symbol Python loop on the CPU), its passes
# over each window are cut from the examples' 10, in both packages alike
SYNC = dict(Niter=3)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_config1_cma_equaliser():
    """The port's capture (resampled as the reference resamples, then its own noise and PMD)
    through both packages' ``equalise_signal``: taps within 1e-4, the same symbol errors
    (after 100 symbols at each end, where the FIR window hangs off the capture)."""
    fb = 40e9
    j = qt.SignalQAMGrayCoded(4, 2 ** 14, nmodes=2, fb=fb, seed=1).resample(2 * fb, beta=0.1)
    t = tsig.SignalQAMGrayCoded(4, 2 ** 14, nmodes=2, fb=fb, seed=1, device=CPU)
    t = t.resample(2 * fb, beta=0.1)
    assert np.abs(_np(t) - _np(j)).max() <= 1e-5 * np.sqrt(np.mean(np.abs(_np(j)) ** 2))
    t = timp.apply_PMD(timp.change_snr(t, 14, generator=_gen(0)), np.pi / 5.65, 100e-12)
    j = j.replace(samples=jnp.asarray(_np(t)))
    kw = dict(Ntaps=17, method="cma", adaptive_stepsize=True, apply=True)
    Ej, wj, _ = jeqz.equalise_signal(j, 1e-3, **kw)
    Et, wt, _ = teqz.equalise_signal(t, 1e-3, **kw)
    assert np.abs(_np(wt) - np.asarray(wj)).max() <= 1e-4
    Ej = Ej.replace(samples=jhelp.normalise_and_center(Ej.samples)[:, 100:-100])
    Et = thelp.normalise_and_center(Et)[:, 100:-100]
    ser_j, ser_t = np.asarray(Ej.cal_ser()), Et.cal_ser().numpy()
    # 3 errors of 16,184 on mode 0 in both (the chip's path gates 2^20 symbols at 1e-4)
    assert np.array_equal(ser_t, ser_j) and ser_t.max() <= 5e-4
    assert np.allclose(Et.cal_evm().numpy(), np.asarray(Ej.cal_evm()), rtol=1e-3)


def _config4_capture(seed, nframes=3, noise=True):
    sig = tsig.SignalWithPilots(64, F, P, R, nmodes=2, Mpilots=4, nframes=nframes, fb=24e9,
                                seed=seed, device=CPU).resample(48e9, beta=0.01)
    kw = dict(snr=25, lwdth=100e3) if noise else {}
    return timp.simulate_transmission(sig, dgd=10e-12, freq_off=100e6,
                                      modal_delay=(2000, 2000), generator=_gen(seed), **kw)


def _config4_reference(seed, nframes=3):
    """The JAX package's config 4 transmitter without its noise."""
    sig = qt.SignalWithPilots(64, F, P, R, nmodes=2, Mpilots=4, nframes=nframes, fb=24e9,
                              seed=seed).resample(48e9, beta=0.01)
    return jimp.simulate_transmission(sig, dgd=10e-12, freq_off=100e6, modal_delay=(2000, 2000))


def _config5_capture(seed, nframes=3, noise=True):
    fb, npl = 40e9, (F - P) * (R - 1) // R
    pay = tsig.SignalQAMGrayCoded(64, npl, nmodes=2, fb=fb, seed=seed, device=CPU)
    pil = tsig.SignalQAMGrayCoded(4, NPIL, nmodes=2, fb=fb, seed=seed + 1, device=CPU)
    sig = tsig.SignalWithPilots.from_symbol_array(pay, F, P, R, pilots=pil, nframes=nframes)
    sig = sig.resample(2 * fb, beta=0.5, renormalise=True)
    x = torch.roll(sig.samples, 1000, dims=-1)
    x = tcimp.sim_DAC_response(x, sig.fs, enob=6 if noise else 0, generator=_gen(seed),
                               cutoff=16e9)
    x = tcimp.modulator_response(tcimp.ideal_amplifier_response(x, 1.0))
    sig = sig.replace(samples=x)
    if noise:
        sig = timp.change_snr(sig, 35, generator=_gen(seed + 1))
    return thelp.normalise_and_center(sig)


def _config5_reference(seed, nframes=3):
    """The JAX package's config 5 transmitter without its noise (ENOB 0, no SNR)."""
    fb, npl = 40e9, (F - P) * (R - 1) // R
    pay = qt.SignalQAMGrayCoded(64, npl, nmodes=2, fb=fb, seed=seed)
    pil = qt.SignalQAMGrayCoded(4, NPIL, nmodes=2, fb=fb, seed=seed + 1)
    sig = qt.SignalWithPilots.from_symbol_array(pay, F, P, R, pilots=pil, nframes=nframes)
    sig = sig.resample(2 * fb, beta=0.5, renormalise=True)
    x = jnp.roll(sig.samples, 1000, axis=-1)
    # under one jit: op by op the reference's associative IIR compiles for ~20 s
    x = jax.jit(lambda v: jcimp.sim_DAC_response(v, sig.fs, enob=0, cutoff=16e9))(x)
    x = jcimp.modulator_response(jcimp.ideal_amplifier_response(x, 1.0))
    return sig.replace(samples=jhelp.normalise_and_center(jnp.asarray(x)))


def _as_jax(t, ref):
    """The port's capture ``t`` as a JAX signal like ``ref`` (the JAX transmitter's output)."""
    return ref.replace(samples=jnp.asarray(_np(t)))


def _receive(pkg, sig, tx, state=None):
    """(sync2frame unless the signal is synced, or the sync ``state`` (mode order, shifts,
    coarse FOE) of another run is given), corr_foe, pilot_equaliser on frame 0, pilot_cpe:
    (taps, recovered signal, its payload)."""
    eqz, ph = (jeqz, jph) if pkg == "jax" else (teqz, tph)
    if state is not None:
        order, sig.shiftfctrs, sig._foe = state
        sig.samples = sig.samples[torch.as_tensor(order)]
        sig.synctaps = 17
    elif sig.shiftfctrs is None:
        assert sig.sync2frame()
    sig.corr_foe()
    taps, eq = eqz.pilot_equaliser(sig, (1e-3, 1e-3), 45, foe_comp=False, methods=("cma", "sbd"))
    cpe, _ = ph.pilot_cpe(eq, N=5, use_seq=False) if tx else ph.pilot_cpe(eq, N=5)
    return np.asarray(taps), cpe, cpe.get_data()


def _metrics(cpe, pay, tx):
    s = pay if tx else cpe
    return np.asarray(s.cal_ber()), np.asarray(s.cal_gmi()[0])


@pytest.mark.parametrize("config, seed, port_sync", [(4, 1, True), (4, 4, False),
                                                     (5, 2, False)])
def test_pilot_configs(config, seed, port_sync):
    """The port's capture through both packages' receivers. ``port_sync``: the port runs its
    own frame sync (held equal to the reference's); else it takes the reference's state
    (shift, FOE, mode order), which keeps this test's per-symbol search to one package."""
    tx = config == 5
    make, ref = (_config5_capture, _config5_reference) if tx else \
        (_config4_capture, _config4_reference)
    clean = make(seed, noise=False)
    r = np.asarray(ref(seed).samples)
    assert np.abs(_np(clean) - r).max() <= 1e-4 * np.abs(r).max()
    t_cap = make(seed)
    raw = _np(t_cap)
    j_cap = _as_jax(t_cap, ref(seed))
    assert j_cap.sync2frame(**(SYNC if port_sync else {}))
    order = [int(np.flatnonzero((raw == np.asarray(row)).all(-1))[0]) for row in j_cap.samples]
    shifts, foe = np.asarray(j_cap.shiftfctrs), np.asarray(j_cap._foe)
    j_taps, j_cpe, j_pay = _receive("jax", j_cap, tx)
    if port_sync:
        assert t_cap.sync2frame(**SYNC)
        assert np.array_equal(t_cap.shiftfctrs, shifts)
        assert np.array_equal(_np(t_cap), raw[order])
        state = None
    else:
        state = (order, shifts, foe)
    t_taps, t_cpe, t_pay = _receive("port", t_cap, tx, state)
    (ber_j, gmi_j), (ber_t, gmi_t) = _metrics(j_cpe, j_pay, tx), _metrics(t_cpe, t_pay, tx)
    if (config, seed) == (4, 4):
        # both receivers fail on mode 0 of this capture; a failing sbd stage parts on
        # rounding, so only the failure is compared
        assert ber_j[0] > 0.1 and ber_t[0] > 0.1
        return
    assert np.abs(t_taps - j_taps).max() <= 1e-4
    a, b = (t_pay, j_pay) if tx else (t_cpe.get_data(), j_cpe.get_data())
    coded = torch.as_tensor(np.asarray(j_pay.coded_symbols))
    agree = float((decision_idx(a.samples, coded)
                   == decision_idx(torch.as_tensor(_np(b)), coded)).double().mean())
    assert agree >= 0.999
    assert np.all(np.abs(ber_t - ber_j) <= 1e-3) and np.all(np.abs(gmi_t - gmi_j) <= 0.01)
    assert np.all(ber_t < 0.03) and np.all(gmi_t > 5.2)
