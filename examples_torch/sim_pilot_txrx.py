"""Full pilot-based TX->RX simulation on the port: frame sync, FOE, pilot equalisation, CPE.

The port of ``examples/sim_pilot_txrx.py`` (BASELINE config 4): a
``SignalWithPilots`` capture through ``simulate_transmission`` (25 dB,
10 ps DGD, 100 MHz offset, 100 kHz linewidth, modal delay), ``sync2frame``
(the per-symbol trainer kernel B9 a search window), ``corr_foe``,
``pilot_equaliser`` (B1, the filter's frame entry) and ``pilot_cpe``. The
gates are the chip run's: BER at most twice the JAX example's mean over
seeds (``tools/baseline_reference_ber.py``), GMI at least 5.5.
Run: python examples_torch/sim_pilot_txrx.py [--device cpu]
"""
import _common

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, impairments, phaserec
from qampy_tpu_torch.utils import resolve_device

GATES = {"sync": ("==", True), "ber": ("<=", 4.590e-3), "gmi": (">=", 5.5)}


def main(device=None, frame_len=2 ** 16, seq_len=2 ** 10, nframes=3, seed=4, sync_Niter=10):
    dev = resolve_device(device)
    sig = qt.SignalWithPilots(64, frame_len, seq_len, 32, nmodes=2, Mpilots=4,
                              nframes=nframes, fb=24e9, seed=seed, device=dev)
    sig2 = sig.resample(sig.fb * 2, beta=0.01)
    sig3 = impairments.simulate_transmission(sig2, snr=25, dgd=10e-12, freq_off=100e6,
                                             lwdth=100e3, modal_delay=(2000, 2000),
                                             generator=_common.gen(seed, dev))
    ok = bool(sig3.sync2frame(Niter=sync_Niter))
    print("frame sync:", ok, "shifts:", sig3.shiftfctrs)
    sig3.corr_foe()
    wxy, eq_sig = equalisation.pilot_equaliser(sig3, (1e-3, 1e-3), 45, foe_comp=False,
                                               methods=("cma", "sbd"))
    cpe_sig, ph = phaserec.pilot_cpe(eq_sig, N=5)
    ber, gmi = cpe_sig.cal_ber().tolist(), cpe_sig.cal_gmi()[0].tolist()
    print("BER:", ber)
    print("GMI:", gmi)
    return {"sync": ok, "ber": ber, "gmi": gmi}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
