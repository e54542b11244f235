"""One-stage against two-stage blind phase search over laser linewidths (64-QAM), on the port.

The port of ``examples/phase_recovery_sweep.py``: for four linewidths, the
one-stage search (``phaserec.bps``, 64 angles) and the two-stage one
(``bps_twostage``, 28 coarse angles), each on the card's kernels (B3, B8,
B6).
Run: python examples_torch/phase_recovery_sweep.py [--device cpu]
"""
import _common
import numpy as np
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import helpers, impairments, phaserec
from qampy_tpu_torch.utils import resolve_device

GATES = {"twostage_ser": ("<=", 1e-3), "onestage_ser": ("<=", 1e-3)}


def main(device=None, N=3 * 10 ** 5, linewidths=tuple(np.linspace(10e1, 1000e1, 4))):
    dev = resolve_device(device)
    fb = 40e9
    rng = np.random.default_rng(4)
    res = {"linewidth": list(linewidths), "twostage_ser": [], "onestage_ser": []}
    for i, lw in enumerate(linewidths):
        s = qt.SignalQAMGrayCoded(64, N, fb=fb, seed=5, device=dev)
        s = s.resample(fb, beta=0.1, renormalise=True)
        s = impairments.change_snr(s, 30, generator=_common.gen(i, dev))
        s = s.replace(samples=torch.roll(s.samples, int(rng.integers(-N // 2, N // 2)), dims=1))
        pp = impairments.apply_phase_noise(s, lw, generator=_common.gen(100 + i, dev))
        rec2, ph2 = phaserec.bps_twostage(pp, 28, 14)
        rec1, ph1 = phaserec.bps(pp, 64, 14)
        ser2 = float(helpers.dump_edges(rec2, 20).cal_ser().mean())
        ser1 = float(helpers.dump_edges(rec1, 20).cal_ser().mean())
        res["twostage_ser"].append(ser2)
        res["onestage_ser"].append(ser1)
        print("lw=%6.0f Hz  two-stage ser=%g  one-stage ser=%g" % (lw, ser2, ser1))
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
