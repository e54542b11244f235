"""BER counted against BER estimated from the EVM, across the SNR, on the port.

The port of ``examples/ber_vs_evm.py``: 16-QAM with noise only; the
counted BER, the BER that ``theory.ber_vs_evm_qam`` estimates from the
data-aided EVM, and the closed-form BER.
Run: python examples_torch/ber_vs_evm.py [--device cpu]
"""
import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import impairments, theory
from qampy_tpu_torch.utils import resolve_device

# |log2(counted / theory)| and |log2(from EVM / theory)|: within 30 %
GATES = {"counted_log2_ratio": ("<=", 0.38), "evm_log2_ratio": ("<=", 0.38)}


def main(device=None, N=2 ** 16, snrs_db=tuple(range(5, 18, 2))):
    dev = resolve_device(device)
    M = 16
    sig = qt.SignalQAMGrayCoded(M, N, nmodes=1, seed=7, device=dev)
    res = {"snr_db": list(snrs_db), "ber": [], "evm": [], "ber_evm": [], "ber_theory": []}
    print("SNR(dB)  BER(counted)  BER(from EVM)  BER(theory)")
    for snr in snrs_db:
        n = impairments.change_snr(sig, snr, generator=_common.gen(int(snr), dev))
        ber = float(n.cal_ber(synced=True)[0])
        evm = float(n.cal_evm(synced=True, blind=False)[0])
        # ber_vs_evm_qam takes the EVM as a power ratio in dB
        ber_evm = float(theory.ber_vs_evm_qam(20 * np.log10(evm), M))
        ber_th = float(theory.ber_vs_es_over_n0_qam(10 ** (snr / 10), M))
        for k, v in zip(("ber", "evm", "ber_evm", "ber_theory"), (ber, evm, ber_evm, ber_th)):
            res[k].append(v)
        print("  %4.1f    %.3e     %.3e     %.3e" % (snr, ber, ber_evm, ber_th))
    res["counted_log2_ratio"] = [abs(float(np.log2(b / t)))
                                 for b, t in zip(res["ber"], res["ber_theory"])]
    res["evm_log2_ratio"] = [abs(float(np.log2(b / t)))
                             for b, t in zip(res["ber_evm"], res["ber_theory"])]
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
