"""The transmitter distortion test on the port: quantiser noise, ENOB as noise, DAC and modulator.

The port of ``examples/tx_distortion_test.py``: (1) the finite-ENOB
quantiser against the uniform quantisation noise delta^2/12 per dimension,
(2) the ENOB as an equivalent noise against the closed-form SNR, (3) 16-QAM
through a band-limited DAC and an overdriven Mach-Zehnder modulator (5.5 V
at Vpi = 3.5 V), still decoded after matched resampling.
Run: python examples_torch/tx_distortion_test.py [--device cpu]
"""
import _common
import numpy as np
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import helpers, impairments
from qampy_tpu_torch.core import impairments as cimpairments
from qampy_tpu_torch.utils import resolve_device

# the JAX example's own asserts: the quantiser within 10 % of delta^2/12, the estimated SNR
# within 4 dB of the closed form (the blind estimator saturates), SER < 1e-3
GATES = {"quantiser_ratio_dev": ("<=", 0.1), "snr_diff_db": ("<=", 4.0), "ser": ("<=", 1e-3)}


def main(device=None, N=2 ** 16):
    dev = resolve_device(device)
    M, fb, VPI = 16, 20e9, 3.5
    sig = qt.SignalQAMGrayCoded(M, N, nmodes=1, fb=fb, seed=1, device=dev)
    s2 = sig.resample(2 * fb, beta=0.2)
    x = s2.samples
    # 1. the quantiser against delta^2/12
    enob = 6
    x_max = float(torch.maximum(x.real.abs().max(), x.imag.abs().max()))
    delta = x_max / 2 ** (enob - 1)
    pn_analytic = delta ** 2 / 12          # per real dimension
    sq = cimpairments.quantize_signal_New(x, nbits=enob, rescale_in=True, rescale_out=True)
    pn_meas = float(torch.mean(torch.abs(sq - x) ** 2)) / 2
    print("quantiser noise/dim: measured %.3e analytic %.3e (ratio %.3f)"
          % (pn_meas, pn_analytic, pn_meas / pn_analytic))
    # 2. the ENOB as an equivalent noise
    pow_mean = float(torch.mean(x.real.abs() ** 2))
    noisy = impairments.add_awgn(s2, np.sqrt(2 * pn_analytic), generator=_common.gen(1, dev))
    rx1 = noisy.resample(fb, beta=0.2, renormalise=True)
    snr_est = float(10 * np.log10(float(torch.as_tensor(rx1.est_snr())[0])))
    snr_th = float(10 * np.log10(pow_mean * 2 / (2 * pn_analytic)))
    print("ENOB-as-AWGN: est_snr %.2f dB, analytic %.2f dB" % (snr_est, snr_th))
    # 3. a band-limited DAC, an overdriven modulator and the channel's noise
    dac = impairments.sim_DAC_response(s2, enob=6, cutoff=5e9, fn=None, ch=None,
                                       generator=_common.gen(2, dev))
    print("DAC(5 GHz bessel) residual: %.3e" % float(torch.mean(torch.abs(dac.samples - x) ** 2)))
    amp = cimpairments.ideal_amplifier_response(x, 5.5 / (2 * VPI))
    mzm = cimpairments.modulator_response(amp)
    out = impairments.change_snr(s2.replace(samples=mzm), 20, generator=_common.gen(3, dev))
    rx = helpers.normalise_and_center(out.resample(fb, beta=0.2, renormalise=True))
    ser = float(rx.cal_ser()[0])
    print("overdriven MZM @20 dB: SER %.2e est_snr %.2f dB"
          % (ser, 10 * np.log10(float(torch.as_tensor(rx.est_snr())[0]))))
    return {"quantiser_ratio": pn_meas / pn_analytic,
            "quantiser_ratio_dev": abs(pn_meas / pn_analytic - 1),
            "snr_est_db": snr_est, "snr_theory_db": snr_th,
            "snr_diff_db": abs(snr_est - snr_th), "ser": ser}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
