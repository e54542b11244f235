"""Two-stage MCMA -> MRDE equalisation of dual-pol 64-QAM, on the port.

The port of ``examples/64_qam_equalisation.py`` (BASELINE config 2): 64-QAM
at 40 GBd, 30 dB, PMD, then ``dual_mode_equalisation(..., methods=("mcma",
"mrde"), backend="block")``: the block-LMS trainer in plain PyTorch, as the
example asks for the block trainer and MRDE has no kernel; the filter is
kernel B2 on the card.
Run: python examples_torch/64_qam_equalisation.py [--device cpu]
"""
import time

import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments
from qampy_tpu_torch.utils import resolve_device

GATES = {"ser": ("<=", 1e-3), "gmi": (">=", 5.8)}


def main(device=None, N=2 ** 18):
    dev = resolve_device(device)
    fb, M = 40e9, 64
    sig = qt.SignalQAMGrayCoded(M, N, nmodes=2, fb=fb, seed=2, device=dev)
    sig = sig.resample(2 * fb, beta=0.1)
    sig = impairments.change_snr(sig, 30, generator=_common.gen(1, dev))
    sig = impairments.apply_PMD(sig, np.pi / 5.6, 75e-12)
    t0 = time.time()
    E, wxy, (err1, err2) = equalisation.dual_mode_equalisation(
        sig, (1e-3, 1e-3), 33, methods=("mcma", "mrde"), adaptive_stepsize=(True, True),
        backend="block")
    print("equalisation took %.2fs" % (time.time() - t0))
    E = helpers.normalise_and_center(E)
    ser, gmi = E.cal_ser().tolist(), E.cal_gmi()[0].tolist()
    print("SER:", ser)
    print("GMI:", gmi)
    return {"ser": ser, "gmi": gmi}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
