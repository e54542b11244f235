"""Modulation-format tour: simulated SER and BER of M-QAM against the theory, on the port.

The port of ``examples/modulation_formats.py``: Gray-coded 4-, 16-, 64- and
256-QAM with noise only, their counted SER and BER beside the closed-form
curves.
Run: python examples_torch/modulation_formats.py [--device cpu]
"""
import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import impairments, theory
from qampy_tpu_torch.utils import resolve_device

# |log2(simulated / theory)|: within a factor of two of the theory
GATES = {"ser_log2_ratio": ("<=", 1.0), "ber_log2_ratio": ("<=", 1.0)}
CASES = ((4, 11), (16, 18), (64, 24), (256, 30))


def main(device=None, N=2 ** 17):
    dev = resolve_device(device)
    res = {k: [] for k in ("ser", "ser_theory", "ber", "ber_theory")}
    print("%6s %6s %12s %12s %12s %12s" % ("M", "SNRdB", "SER sim", "SER theory",
                                           "BER sim", "BER theory"))
    for M, snr_db in CASES:
        sig = qt.SignalQAMGrayCoded(M, N, nmodes=1, fb=25e9, seed=M, device=dev)
        n = impairments.change_snr(sig, snr_db, generator=_common.gen(M, dev))
        snr = 10 ** (snr_db / 10)
        vals = (float(n.cal_ser().mean()), float(theory.ser_vs_es_over_n0_qam(snr, M)),
                float(n.cal_ber().mean()), float(theory.ber_vs_es_over_n0_qam(snr, M)))
        for k, v in zip(res, vals):
            res[k].append(v)
        print("%6d %6.1f %12.3e %12.3e %12.3e %12.3e" % ((M, snr_db) + vals))
    for k in ("ser", "ber"):
        res[k + "_log2_ratio"] = [abs(float(np.log2(max(a, 1e-12) / b)))
                                  for a, b in zip(res[k], res[k + "_theory"])]
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
