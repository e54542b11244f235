"""Two-stage MCMA -> MRDE equalisation of a PMD-impaired 16-QAM signal, on the port.

The port of ``examples/mrde_equaliser.py``: 40 GBd dual-pol 16-QAM made at
two samples a symbol (``ResampledQAM``), 24 dB, PMD pi/2.35 with 50 ps DGD,
a 30-tap two-stage equaliser (MRDE has no kernel: ``backend="auto"`` takes
the plain block trainer for it); the EVM before and after, the GMI and
SER.
Run: python examples_torch/mrde_equaliser.py [--device cpu]
"""
import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments
from qampy_tpu_torch.utils import resolve_device

GATES = {"ser": ("<=", 1e-3), "gmi": (">=", 3.9)}


def main(device=None, N=2 ** 18):
    dev = resolve_device(device)
    fb = 40e9
    sig = qt.ResampledQAM(16, N, nmodes=2, fb=fb, fs=2 * fb,
                          resamplekwargs={"beta": 0.01, "renormalise": True}, seed=1,
                          device=dev)
    sig = impairments.change_snr(sig, 24, generator=_common.gen(0, dev))
    SS = impairments.apply_PMD(sig, np.pi / 2.35, 50e-12)
    E_s, wxy_s, (err_s, err_rde_s) = equalisation.dual_mode_equalisation(
        SS, (1e-3, 0.5e-3), 30, methods=("mcma", "mrde"))
    E_s = helpers.normalise_and_center(E_s)
    evm_in = (100 * sig[:, ::2].cal_evm()).tolist()
    evm_out = (100 * E_s.cal_evm()).tolist()
    gmi, ser = E_s.cal_gmi()[0].tolist(), E_s.cal_ser().tolist()
    print("EVM in : %s %%" % np.round(evm_in, 1).tolist())
    print("EVM out: %s %%" % np.round(evm_out, 1).tolist())
    print("GMI    : %s (max 4)" % np.round(gmi, 3).tolist())
    print("SER    : %s" % ser)
    return {"evm_in_pct": evm_in, "evm_out_pct": evm_out, "gmi": gmi, "ser": ser}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
