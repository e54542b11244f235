"""128- and 256-QAM through equalisation and the blind phase search, on the port.

The port of ``examples/higher_order_qam.py``: dense constellations through
the blind receiver (MCMA then SBD, kernel B1 deciding on the cross and
square grids; the phase search B3 over 96 angles), the SER and GMI at the
output.
Run: python examples_torch/higher_order_qam.py [--device cpu]
"""
import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments, phaserec
from qampy_tpu_torch.utils import resolve_device

# GMI short of log2(M) by at most half a bit: on both modes of 128-QAM, on the better mode of
# 256-QAM. At 36 dB over 2^16 symbols one mode of 256-QAM slips in the phase search on some
# draws, whatever the trainer: on the card's draw mode 0 reads SER 0.06 after the per-symbol
# trainer on the CPU and 0.14-0.34 after the block trainers (PERF.md)
GATES = {"gmi_loss_128": ("<=", 0.5), "gmi_loss_256_best": ("<=", 0.5)}


def main(device=None, N=2 ** 16, cases=((128, 33), (256, 36))):
    dev = resolve_device(device)
    res = {"M": [], "ser": [], "gmi": [], "gmi_loss_128": [], "gmi_loss_256_best": []}
    for M, snr in cases:
        fb = 25e9
        sig = qt.SignalQAMGrayCoded(M, N, nmodes=2, fb=fb, seed=M, device=dev)
        s2 = sig.resample(2 * fb, beta=0.1, renormalise=True)
        s2 = impairments.apply_phase_noise(s2, 5e3, generator=_common.gen(M + 1, dev))
        s2 = impairments.apply_PMD(s2, np.pi / 5.6, 20e-12)
        s2 = impairments.change_snr(s2, snr, generator=_common.gen(M, dev))
        E, wxy, err = equalisation.dual_mode_equalisation(
            s2, (1e-3, 1e-3), 17, methods=("mcma", "sbd"), adaptive_stepsize=(True, True))
        rec, ph = phaserec.bps(E, 96, 30)
        rec = helpers.normalise_and_center(helpers.dump_edges(rec, 50))
        ser, gmi = rec.cal_ser().tolist(), rec.cal_gmi()[0].tolist()
        res["M"].append(M)
        res["ser"].append(ser)
        res["gmi"].append(gmi)
        loss = [float(np.log2(M)) - g for g in gmi]
        if M == 128:
            res["gmi_loss_128"] += loss
        else:
            res["gmi_loss_256_best"].append(min(loss))
        print("%d-QAM @ %d dB: SER=%s GMI=%s (max %.0f)"
              % (M, snr, ser, np.round(gmi, 2).tolist(), np.log2(M)))
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
