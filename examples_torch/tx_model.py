"""The transmitter model with and without the modulator's pre-distortion, on the port.

The port of ``examples/tx_model.py``: root-raised-cosine 64-QAM through
the transmitter (``impairments.sim_tx_response``: a 7-bit-ENOB DAC with a
band-limiting response, the ideal amplifier, the Mach-Zehnder sine
transfer), with and without the arcsin pre-compensation
(``core.digital_pre_compensation.comp_mod_sin``), and the received SNR and
EVM after matched resampling.
Run: python examples_torch/tx_model.py [--device cpu]
"""
import _common
import numpy as np
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import helpers, impairments
from qampy_tpu_torch.core import digital_pre_compensation as dpc
from qampy_tpu_torch.utils import resolve_device

GATES = {"snr_db": (">=", 15.0)}


def main(device=None, N=2 ** 16):
    dev = resolve_device(device)
    fb, os_ = 24e9, 2
    sig = qt.SignalQAMGrayCoded(64, N, nmodes=2, fb=fb, seed=3, device=dev)
    s2 = sig.resample(os_ * fb, beta=0.1, renormalise=True)
    res = {"precomp": [], "snr_db": [], "evm_pct": []}
    for precomp in (False, True):
        tx = s2.samples
        if precomp:
            # into the arcsin domain, pre-distorted for the modulator's sine
            tx = tx / torch.max(torch.abs(torch.cat([tx.real, tx.imag])))
            tx = dpc.comp_mod_sin(tx, vpi=1.14)
        out = impairments.sim_tx_response(
            s2.replace(samples=tx), enob=7, tgt_v=0.9,
            dac_params={"cutoff": 0.45 * os_ * fb, "fn": None, "ch": None},
            generator=_common.gen(1, dev))
        rx = helpers.normalise_and_center(out.resample(fb, beta=0.1, renormalise=True))
        snr = (10 * torch.log10(torch.as_tensor(rx.est_snr()))).tolist()
        evm = (100 * rx.cal_evm()).tolist()
        res["precomp"].append(precomp)
        res["snr_db"] += snr
        res["evm_pct"] += evm
        print("precomp=%-5s rx SNR: %s dB  EVM: %s %%"
              % (precomp, np.round(snr, 2).tolist(), np.round(evm, 2).tolist()))
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
