"""Recover 64-QAM symbols loaded from a matlab file, on the port.

The port of ``examples/64qam_data_test.py``: the symbols of a matlab file
(key ``X_Symbs``; the reference's 20 GBd SRRC-0.05 64-QAM PRBS15 set,
``data/20GBaud_SRRC0P05_64QAM_PRBS15.mat`` in the repository where it is
present) as a fake-polmux dual-pol signal, resampled, 30 dB of noise, PMD,
and the MCMA -> SBD dual-mode equaliser (kernels B1 and B2 on the card).
Run: python examples_torch/64qam_data_test.py [--device cpu] [file.mat]
"""
import argparse
import os

import _common
import numpy as np

from qampy_tpu_torch import equalisation, helpers, impairments
from qampy_tpu_torch import io as qio
from qampy_tpu_torch.utils import resolve_device

MAT = os.path.join(_common.ROOT, "data", "20GBaud_SRRC0P05_64QAM_PRBS15.mat")
GATES = {"ser": ("<=", 1e-3)}


def main(device=None, mat=MAT):
    dev = resolve_device(device)
    if not os.path.exists(mat):
        raise FileNotFoundError("matlab data file not found: %s" % mat)
    symbs = qio.load_symbols_from_matlab_file(mat, 64, (("X_Symbs",),), fb=20e9, normalise=True,
                                              fake_polmux=True, device=dev)
    print("loaded symbols:", tuple(symbs.shape), "fb=%.0f GBd" % (symbs.fb / 1e9))
    sig = symbs.resample(2 * symbs.fb, beta=0.05)
    sig = impairments.change_snr(sig, 30, generator=_common.gen(0, dev))
    sig = impairments.apply_PMD(sig, np.pi / 5.6, 30e-12)
    E, wxy, err = equalisation.dual_mode_equalisation(
        sig, (6e-4, 6e-4), 17, methods=("mcma", "sbd"), adaptive_stepsize=(True, True))
    E = helpers.normalise_and_center(E)
    gmi, ser = E.cal_gmi()[0].tolist(), E.cal_ser().tolist()
    print("GMI:", gmi)
    print("SER:", ser)
    return {"gmi": gmi, "ser": ser}


def write_test_file(fn, N=2 ** 15, seed=0):
    """A matlab file shaped as the reference's: N random 64-QAM symbols under ``X_Symbs``."""
    import scipy.io
    from qampy_tpu_torch.theory import cal_symbols_qam
    const = cal_symbols_qam(64)
    syms = const[np.random.default_rng(seed).integers(0, 64, N)]
    scipy.io.savemat(fn, {"X_Symbs": syms.reshape(1, -1)})
    return fn


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default, 'cpu' for the CPU")
    ap.add_argument("mat", nargs="?", default=MAT)
    main(**vars(ap.parse_args()))
