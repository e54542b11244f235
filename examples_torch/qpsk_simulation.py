"""QPSK link simulation on the port: CMA and Viterbi-Viterbi carrier recovery.

The port of ``examples/qpsk_simulation.py``: root-raised-cosine QPSK at two
samples a symbol, laser phase noise, PMD and noise, the CMA equaliser
(kernels B1 and B2 on the card), the fourth-power phase recovery, and the
BER beside the theory, at 8, 10 and 12 dB.
Run: python examples_torch/qpsk_simulation.py [--device cpu]
"""
import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments, phaserec, theory
from qampy_tpu_torch.utils import resolve_device

# BER over theory: phase noise and equalisation cost a little
GATES = {"ber_over_theory": ("<=", 3.0)}


def main(device=None, N=2 ** 17, snrs=(8, 10, 12)):
    dev = resolve_device(device)
    fb = 25e9
    res = {"snr_db": list(snrs), "ber": [], "ber_theory": []}
    for snr_db in snrs:
        sig = qt.SignalQAMGrayCoded(4, N, nmodes=2, fb=fb, seed=1, device=dev)
        s2 = sig.resample(2 * fb, beta=0.1, renormalise=True)
        s2 = impairments.apply_phase_noise(s2, 50e3, generator=_common.gen(2, dev))
        s2 = impairments.apply_PMD(s2, np.pi / 4.7, 30e-12)
        s2 = impairments.change_snr(s2, snr_db, generator=_common.gen(snr_db, dev))
        E, wxy, err = equalisation.equalise_signal(s2, 2e-3, Ntaps=17, method="cma",
                                                   adaptive_stepsize=True, apply=True)
        rec, ph = phaserec.viterbiviterbi(E, 41)
        ber = float(helpers.dump_edges(rec, 30).cal_ber().mean())
        ber_t = float(theory.ber_vs_es_over_n0_qam(10 ** (snr_db / 10), 4))
        res["ber"].append(ber)
        res["ber_theory"].append(ber_t)
        print("QPSK @ %2d dB: BER=%.3e  theory=%.3e" % (snr_db, ber, ber_t))
    res["ber_over_theory"] = [b / t for b, t in zip(res["ber"], res["ber_theory"])]
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
