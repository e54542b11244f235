"""BER and GMI that the JAX package's BASELINE pilot examples reach, over seeds.

Runs the receiver chains of ``examples/sim_pilot_txrx.py`` (config 4) and
``examples/tx_impairment_simulation.py`` (config 5) at their own settings
on the CPU, each with the seeds 1..N of the signal and of the impairments'
keys in place of the examples' single seed, and prints per seed the frame
sync's flag, the BER and the GMI of each mode, then their mean and
largest value. The port's chip run gates its baseline paths at twice the
mean BER (``chip_smoke.py`` phase 19). The random generators of the two
packages differ, so only such statistics carry over. Config 5's pilots are
drawn unseeded (``from_symbol_array``, as in the example), so each run of
this script gives new captures there.

Run: ``JAX_PLATFORMS=cpu python tools/baseline_reference_ber.py [N]``.
"""
import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import qampy_tpu as qt  # noqa: E402
from qampy_tpu import equalisation, helpers, impairments, phaserec  # noqa: E402
from qampy_tpu.core import impairments as impair  # noqa: E402


def config4(seed):
    """examples/sim_pilot_txrx.py with the signal's seed and the key ``seed``."""
    sig = qt.SignalWithPilots(64, 2 ** 16, 2 ** 10, 32, nmodes=2, Mpilots=4, nframes=3,
                              fb=24e9, seed=seed)
    sig2 = sig.resample(sig.fb * 2, beta=0.01)
    sig3 = impairments.simulate_transmission(sig2, snr=25, dgd=10e-12, freq_off=100e6,
                                             lwdth=100e3, modal_delay=(2000, 2000),
                                             key=jr.PRNGKey(seed))
    ok = sig3.sync2frame()
    sig3.corr_foe()
    _, eq_sig = equalisation.pilot_equaliser(sig3, (1e-3, 1e-3), 45, foe_comp=False,
                                             methods=("cma", "sbd"))
    cpe_sig, _ = phaserec.pilot_cpe(eq_sig, N=5)
    return bool(ok), np.asarray(cpe_sig.cal_ber()), np.asarray(cpe_sig.cal_gmi()[0])


def config5(seed):
    """The chain of examples/tx_impairment_simulation.py with the payload seed ``seed``."""
    M, N, P, R = 64, 2 ** 16, 1024, 32
    fb, roll_off = 40e9, 0.5
    N_pl = (N - P) * (R - 1) // R
    payload = qt.SignalQAMGrayCoded(M, N_pl, nmodes=2, fb=fb, seed=seed)
    pilot_sig = qt.SignalWithPilots.from_symbol_array(payload, N, P, R, nframes=2)
    sig = pilot_sig.resample(2 * fb, beta=roll_off, renormalise=True)
    sig = sig.replace(samples=jnp.roll(sig.samples, 10000, axis=-1))
    dac_out = impair.sim_DAC_response(sig.samples, sig.fs, enob=6, key=jr.PRNGKey(100 + seed),
                                      cutoff=16e9)
    amp_out = impair.ideal_amplifier_response(dac_out, out_volt=1.0)
    sig = sig.replace(samples=jnp.asarray(impair.modulator_response(amp_out)))
    sig = impairments.change_snr(sig, 35, key=jr.PRNGKey(200 + seed))
    rx = sig.resample(2 * fb, beta=roll_off, renormalise=True)
    rx = rx.replace(samples=helpers.normalise_and_center(rx.samples))
    ok = rx.sync2frame()
    rx.corr_foe()
    _, eq_sig = equalisation.pilot_equaliser(rx, (1e-3, 1e-3), 45, foe_comp=False,
                                             methods=("cma", "sbd"))
    cpe_sig, _ = phaserec.pilot_cpe(eq_sig, N=5, use_seq=False)
    pay = cpe_sig.get_data()
    return bool(ok), np.asarray(pay.cal_ber()), np.asarray(pay.cal_gmi()[0])


def main(n):
    for name, fn in (("config 4 (sim_pilot_txrx)", config4),
                     ("config 5 (tx_impairment_simulation)", config5)):
        bers, gmis = [], []
        for seed in range(1, n + 1):
            ok, ber, gmi = fn(seed)
            print("%s seed %d: sync %s, BER %s, GMI %s" % (name, seed, ok, ber.tolist(),
                                                          gmi.tolist()), flush=True)
            if ok:
                bers.append(ber)
                gmis.append(gmi)
        bers, gmis = np.array(bers), np.array(gmis)
        print("%s: %d of %d seeds synced; BER mean %.4e, max %.4e; GMI mean %.4f, min %.4f"
              % (name, len(bers), n, bers.mean(), bers.max(), gmis.mean(), gmis.min()),
              flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
