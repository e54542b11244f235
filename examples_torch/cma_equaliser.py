"""Single-stage CMA equalisation of a rotated dual-pol QPSK signal, on the port.

The port of ``examples/cma_equaliser.py`` (BASELINE config 1): QPSK at 40 GBd
resampled to two samples a symbol, 14 dB of noise, PMD, then
``equalisation.equalise_signal(..., method="cma")`` over the whole capture
(on the card: the block trainer kernel B1 and the filter kernel B2).
Run: python examples_torch/cma_equaliser.py [--device cpu]
"""
import _common
import numpy as np
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments
from qampy_tpu_torch.utils import resolve_device

GATES = {"ser": ("<=", 1e-3)}


def main(device=None, N=2 ** 16):
    dev = resolve_device(device)
    fb = 40e9
    sig = qt.SignalQAMGrayCoded(4, N, nmodes=2, fb=fb, seed=1, device=dev)
    sig = sig.resample(2 * fb, beta=0.1)
    sig = impairments.change_snr(sig, 14, generator=_common.gen(0, dev))
    sig = impairments.apply_PMD(sig, np.pi / 5.65, 100e-12)
    E, wxy, err = equalisation.equalise_signal(sig, 1e-3, Ntaps=17, method="cma",
                                               adaptive_stepsize=True, apply=True)
    E = helpers.normalise_and_center(E)
    ser, evm = E.cal_ser().tolist(), (20 * torch.log10(E.cal_evm())).tolist()
    print("SER:", ser)
    print("EVM (dB):", evm)
    return {"ser": ser, "evm_db": evm}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
