"""Probabilistic constellation shaping with pilot-based centring, on the port.

The port of ``examples/probabilistic_shaping.py``: Maxwell-Boltzmann-shaped
64-QAM (each quadrature's PAM levels drawn with the shaped probabilities)
carried by a ``SymbolOnlySignal``, noise, centring and normalising by the
first 1024 symbols as known pilots, and the mutual information of the
uniform and the shaped constellations.
Run: python examples_torch/probabilistic_shaping.py [--device cpu]
"""
import _common
import numpy as np
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import helpers, impairments, theory
from qampy_tpu_torch.core.metrics import cal_mi
from qampy_tpu_torch.utils import resolve_device

GATES = {"mi": ("<=", 6.0), "shaping_gain": (">=", 0.0)}
CASES = ((0.0, "uniform 64-QAM"), (0.05, "MB-shaped nu=0.05"), (0.12, "MB-shaped nu=0.12"))


def main(device=None, N=2 ** 16, snr_db=18):
    dev = resolve_device(device)
    const = np.asarray(theory.cal_symbols_qam(64))
    const = const / np.sqrt(float(theory.cal_scaling_factor_qam(64)))
    # shaping acts per quadrature on the PAM levels
    levels = np.unique(np.round(const.real, 6))
    res = {"label": [], "mi": []}
    for nu, label in CASES:
        if nu == 0:
            px = np.full(levels.size, 1 / levels.size)
        else:
            levels, px = theory.cal_ps_probablts(levels, nu)
        syms = np.asarray(theory.generate_ps_symbols(N, levels, px, seed=1))
        sig = qt.SymbolOnlySignal(64, N, const, nmodes=1, fb=25e9, device=dev)
        s = torch.as_tensor(syms[None, :].astype(np.complex64), device=dev)
        sig = sig.replace(samples=s, _symbols=s)
        n = impairments.change_snr(sig, snr_db, generator=_common.gen(3, dev))
        # pilot-based centring: the first 1024 symbols as known pilots
        cent = helpers.normalise_and_center_pil(n.samples, np.arange(1024))
        mi = float(cal_mi(cent, sig.samples, sig.coded_symbols, 10 ** (-snr_db / 10)))
        res["label"].append(label)
        res["mi"].append(mi)
        print("%-20s MI = %.3f bits (max 6)" % (label, mi))
    res["shaping_gain"] = [m - res["mi"][0] for m in res["mi"][1:]]
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
