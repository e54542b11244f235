"""BER, SER and EVM against the SNR after blind equalisation, beside the theory, on the port.

The port of ``examples/ber_vs_evm_with_equalisation.py``: for 4- and 16-QAM
over eight SNRs, the signal at two samples a symbol, the adaptive MCMA
equaliser (13 taps; kernels B1 and B2 on the card), then the counted SER
and BER and the blind and data-aided EVM beside the closed-form BER.
Run: python examples_torch/ber_vs_evm_with_equalisation.py [--device cpu]
"""
import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments, theory
from qampy_tpu_torch.utils import resolve_device

# the counted BER over the theory where the theory reads at least 1e-3 (below, few errors):
# the blind MCMA's misadjustment costs most at the higher SNRs, 4.2-4.3x at 15.7 dB on 16-QAM
# with the per-symbol trainer on the CPU and the block trainer on the card alike (PERF.md)
GATES = {"ber_over_theory": ("<=", 6.0)}


def main(device=None, N=2 ** 16, snrs_db=tuple(np.linspace(5, 30, 8)), Ms=(4, 16)):
    dev = resolve_device(device)
    fb, os_, ntaps, beta = 10e9, 2, 13, 0.1
    res = {"M": [], "snr_db": [], "ser": [], "ber": [], "ber_theory": [], "evm_blind_db": [],
           "evm_known_db": [], "ber_over_theory": []}
    for M in Ms:
        print("%d-QAM   (theory BER in parentheses)" % M)
        print("SNR(dB)    SER        BER(counted)   EVM blind(dB)  EVM known(dB)")
        for sr in snrs_db:
            sig = qt.SignalQAMGrayCoded(M, N, nmodes=1, fb=fb, seed=int(sr) + M, device=dev)
            sig = sig.resample(os_ * fb, beta=beta, renormalise=True)
            sig_s = impairments.change_snr(sig, sr, generator=_common.gen(int(sr), dev))
            wx, er = equalisation.equalise_signal(sig_s, 3e-4, Ntaps=ntaps, method="mcma",
                                                  adaptive_stepsize=True)
            after = helpers.normalise_and_center(equalisation.apply_filter(sig_s, wx))
            evm_b = float(after.cal_evm()[0])
            evm_k = float(after.cal_evm(blind=False)[0])
            ser, ber = float(after.cal_ser()[0]), float(after.cal_ber()[0])
            ber_th = float(theory.ber_vs_es_over_n0_qam(10 ** (sr / 10), M))
            row = (M, float(sr), ser, ber, ber_th, float(helpers.lin2dB(evm_b ** 2)),
                   float(helpers.lin2dB(evm_k ** 2)))
            for k, v in zip(list(res)[:7], row):
                res[k].append(v)
            if ber_th >= 1e-3:
                res["ber_over_theory"].append(ber / ber_th)
            print("  %4.1f   %.3e   %.3e (%.1e)   %6.1f        %6.1f" % row[1:])
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
