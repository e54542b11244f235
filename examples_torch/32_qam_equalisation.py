"""Dual-pol 32-QAM (cross constellation) two-stage equalisation, on the port.

The port of ``examples/32_qam_equalisation.py``: 25 dB, PMD pi/4.6 with
20 ps DGD, MCMA then SBD with 11 taps (kernel B1 deciding on the cross
grid, B2 filtering on the card).
Run: python examples_torch/32_qam_equalisation.py [--device cpu]
"""
import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments
from qampy_tpu_torch.utils import resolve_device

GATES = {"ser": ("<=", 1e-3), "gmi": (">=", 4.8)}


def main(device=None, N=2 ** 18):
    dev = resolve_device(device)
    fb = 40e9
    sig = qt.SignalQAMGrayCoded(32, N, nmodes=2, fb=fb, seed=11, device=dev)
    sig = sig.resample(2 * fb, beta=0.1, renormalise=True)
    sig = impairments.change_snr(sig, 25, generator=_common.gen(1, dev))
    sig = impairments.apply_PMD(sig, np.pi / 4.6, 20e-12)
    E, wxy, (err, err2) = equalisation.dual_mode_equalisation(
        sig, (1e-3, 1e-3), 11, methods=("mcma", "sbd"), adaptive_stepsize=(True, True))
    E = helpers.normalise_and_center(E)
    evm = (100 * E.cal_evm()).tolist()
    ser, gmi = E.cal_ser().tolist(), E.cal_gmi()[0].tolist()
    print("EVM (%):", evm)
    print("SER:", ser)
    print("GMI:", gmi)
    return {"evm_pct": evm, "ser": ser, "gmi": gmi}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
