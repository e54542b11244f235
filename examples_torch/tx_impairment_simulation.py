"""Transmitter impairment simulation through the full pilot receiver, on the port.

The port of ``examples/tx_impairment_simulation.py`` (BASELINE config 5): a
64-QAM payload framed with pilots (``SignalWithPilots.from_symbol_array``),
resampled with a 0.5 roll-off and delayed, the DAC (6-bit ENOB, 16 GHz
Bessel response), the driver amplifier and the Mach-Zehnder modulator,
35 dB of loading noise, then the pilot receiver (``sync2frame``,
``corr_foe``, ``pilot_equaliser``, ``pilot_cpe``). The gates are the chip
run's: BER at most twice the JAX example's mean over seeds
(``tools/baseline_reference_ber.py``), GMI at least 5.4136.
Run: python examples_torch/tx_impairment_simulation.py [--device cpu]
"""
import _common
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments, phaserec
from qampy_tpu_torch.core import impairments as impair
from qampy_tpu_torch.utils import resolve_device

GATES = {"sync": ("==", True), "ber": ("<=", 3.236e-2), "gmi": (">=", 5.4136)}


def main(device=None, N=2 ** 16, P=1024, nframes=2, roll=10000, seed=2, sync_Niter=10):
    dev = resolve_device(device)
    M, R, nmodes, fb, roll_off = 64, 32, 2, 40e9, 0.5
    N_pl = (N - P) * (R - 1) // R
    # payload symbols first, then a pilot frame built from that payload
    payload = qt.SignalQAMGrayCoded(M, N_pl, nmodes=nmodes, fb=fb, seed=seed, device=dev)
    # the pilots drawn from a seed, so that a run repeats (the JAX example draws them unseeded)
    pilots = qt.SignalQAMGrayCoded(4, P + (N - P) // R, nmodes=nmodes, fb=fb, seed=seed + 1,
                                   device=dev)
    pilot_sig = qt.SignalWithPilots.from_symbol_array(payload, N, P, R, pilots=pilots,
                                                      nframes=nframes)
    sig = pilot_sig.resample(2 * fb, beta=roll_off, renormalise=True)
    # a bulk delay for the frame sync to find
    sig = sig.replace(samples=torch.roll(sig.samples, roll, dims=-1))
    # DAC (6-bit ENOB, 16 GHz) -> driver amplifier (1.0 V) -> modulator
    dac_out = impair.sim_DAC_response(sig.samples, sig.fs, enob=6,
                                      generator=_common.gen(7, dev), cutoff=16e9)
    amp_out = impair.ideal_amplifier_response(dac_out, out_volt=1.0)
    sig = sig.replace(samples=impair.modulator_response(amp_out))
    sig = impairments.change_snr(sig, 35, generator=_common.gen(8, dev))
    # the pilot receiver
    rx = sig.resample(2 * fb, beta=roll_off, renormalise=True)
    rx = helpers.normalise_and_center(rx)
    sync_ok = bool(rx.sync2frame(Niter=sync_Niter))
    print("sync ok:", sync_ok, "shift factors:", rx.shiftfctrs)
    rx.corr_foe()
    taps, eq_sig = equalisation.pilot_equaliser(rx, (1e-3, 1e-3), 45, foe_comp=False,
                                                methods=("cma", "sbd"))
    cpe_sig, ph = phaserec.pilot_cpe(eq_sig, N=5, use_seq=False)
    rx_payload = cpe_sig.get_data()
    ber, gmi = rx_payload.cal_ber().tolist(), rx_payload.cal_gmi()[0].tolist()
    print("payload BER:", ber)
    print("payload GMI:", gmi)
    return {"sync": sync_ok, "ber": ber, "gmi": gmi}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
