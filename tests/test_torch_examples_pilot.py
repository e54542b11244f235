"""``examples_torch``: the pilot receivers' examples and the multi-rank one on the CPU, reduced.

The pilot examples run with frames of 2^12 symbols, a 256-symbol pilot
sequence and 3 passes of the frame search over each window (their own:
2^14-2^16 and 10): the port's frame search and pilot equaliser are
per-symbol loops on the CPU. At that size the receiver is weaker in both
packages (tests/test_torch_baseline.py: the reference reads BER 0.005-0.023
on config 4's captures of 2^12-symbol frames), so the BER gates, which hold
at the examples' own sizes (the chip run's phase "examples"), are replaced
here by the JAX example's flow at the same size within a stated factor;
the sync and GMI gates hold as they are. The transmitter-model examples and
the multi-rank one are in tests/test_torch_examples_tx.py.
"""
import jax.random as jr
import numpy as np

import qampy_tpu as qt
from qampy_tpu import equalisation as jeqz
from qampy_tpu import impairments as jimp
from qampy_tpu import phaserec as jph
from torch_examples_util import one_thread, run, within_factor  # noqa: F401 (a fixture)

SMALL = dict(frame_len=2 ** 12, seq_len=256, sync_Niter=3)


def _jax_pilot_rx(sig, methods, sync_kw=None, tx=False, **eqkw):
    assert sig.sync2frame(**(sync_kw or dict(Niter=3)))
    sig.corr_foe()
    _, eq = jeqz.pilot_equaliser(sig, (1e-3, 1e-3), 45, foe_comp=False, methods=methods, **eqkw)
    cpe, _ = jph.pilot_cpe(eq, N=5, use_seq=False) if tx else jph.pilot_cpe(eq, N=5)
    return cpe


def test_sim_pilot_txrx():
    _, res = run("sim_pilot_txrx", skip={"ber"}, seed=4, **SMALL)
    sig = qt.SignalWithPilots(64, 2 ** 12, 256, 32, nmodes=2, Mpilots=4, nframes=3, fb=24e9,
                              seed=4).resample(48e9, beta=0.01)
    sig = jimp.simulate_transmission(sig, snr=25, dgd=10e-12, freq_off=100e6, lwdth=100e3,
                                     modal_delay=(2000, 2000), key=jr.PRNGKey(4))
    ber = np.asarray(_jax_pilot_rx(sig, ("cma", "sbd")).cal_ber())
    # at this size either package reads BER 0.005-0.03 over captures: a factor of 5 either way,
    # less 20 bits of the 8,928 payload symbols a mode
    within_factor(res["ber"], ber, 5, 20 / (6 * 8928))


def test_run_pilot():
    _, res = run("run_pilot", skip={"ber"}, **SMALL)
    sig = qt.SignalWithPilots(64, 2 ** 12, 256, 32, nframes=3, nmodes=2, fb=24e9, seed=22)
    sig = jimp.simulate_transmission(sig.resample(48e9, beta=0.01), snr=25, freq_off=100e6,
                                     lwdth=100e3, dgd=10e-12, modal_delay=(2000, 2000),
                                     roll_frame_sync=True, key=jr.PRNGKey(3))
    ber = np.asarray(_jax_pilot_rx(sig, ("cma", "sbd_data"), dict(Ntaps=17, Niter=3),
                                   tx=True).cal_ber())
    within_factor(res["ber"], ber, 5, 20 / (6 * 8928))
