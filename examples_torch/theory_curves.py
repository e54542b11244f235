"""Analytic BER, SER and GMI curves against the SNR, on the port.

The port of ``examples/theory_curves.py``: ``theory.ser_vs_es_over_n0_qam``
and ``ber_vs_es_over_n0_qam`` for 4-, 16- and 64-QAM, and the Monte-Carlo
GMI of 16-QAM (``theory.cal_gmi``) on ``device``.
Run: python examples_torch/theory_curves.py [--device cpu]
"""
import _common
import numpy as np

from qampy_tpu_torch import theory
from qampy_tpu_torch.utils import resolve_device

GATES = {"monotone": ("==", True), "gmi16": ("<=", 4.0)}


def main(device=None, snr_db=tuple(range(5, 30, 2)), gmi_snr=(10.0, 15.0, 20.0), gmi_N=500):
    dev = resolve_device(device)
    snr_db = np.asarray(snr_db)
    snr = 10 ** (snr_db / 10)
    res = {"snr_db": snr_db.tolist(), "ser": {}, "ber": {}}
    for M in (4, 16, 64):
        ser = theory.ser_vs_es_over_n0_qam(snr, M).tolist()
        ber = theory.ber_vs_es_over_n0_qam(snr, M).tolist()
        res["ser"][M], res["ber"][M] = ser, ber
        print("M=%d" % M)
        for s, a, b in zip(snr_db, ser, ber):
            print("  %2d dB  SER %.3e  BER %.3e" % (s, a, b))
    gmi = theory.cal_gmi(16, np.array(gmi_snr), N=gmi_N, device=dev).tolist()
    print("16-QAM GMI @10/15/20 dB:", gmi)
    res["gmi16"] = gmi
    res["monotone"] = bool(all(np.all(np.diff(res[k][M]) <= 0) for k in ("ser", "ber")
                               for M in (4, 16, 64)) and np.all(np.diff(gmi) >= 0))
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
