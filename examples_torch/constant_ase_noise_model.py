"""A constant-ASE noise transmitter model with a dual-pol pilot receiver, on the port.

The port of ``examples/constant_ase_noise_model.py``: a QAM payload framed
with pilots (``SignalWithPilots.from_symbol_array``), a clipping DAC (clip
ratio 0.6, 6-bit ENOB, 16 GHz), the amplifier and the Mach-Zehnder
modulator, then noise of a fixed absolute power (-13.6 dBm scaled by the
target OSNR and fs/fb), so that the drive moves the effective SNR; the
receiver: resampling, ``sync2frame``, ``corr_foe``, mcma/mddma pilot
equalisation, pilot CPE and the BER gate.
Run: python examples_torch/constant_ase_noise_model.py [--device cpu]
"""
import _common
import numpy as np
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments, phaserec
from qampy_tpu_torch.core import impairments as cimpairments
from qampy_tpu_torch.utils import resolve_device

GATES = {"sync": ("==", True), "ber": ("<=", 2e-2)}


def main(device=None, frame_len=2 ** 14, seq_len=1024, sync_Niter=10):
    dev = resolve_device(device)
    M, ins_rat, fb = 64, 32, 24e9
    VPI, roll, snr = 3.5, 0.1, 28
    # the payload as a QAM signal, framed with pilots
    n_payload = (frame_len - seq_len) * (ins_rat - 1) // ins_rat
    payload = qt.SignalQAMGrayCoded(M, n_payload, nmodes=2, fb=fb, seed=11, device=dev)
    # the pilots drawn from a seed, so that a run repeats (the JAX example draws them unseeded)
    pilots = qt.SignalQAMGrayCoded(4, seq_len + (frame_len - seq_len) // ins_rat, nmodes=2, fb=fb,
                                   seed=12, device=dev)
    psig = qt.SignalWithPilots.from_symbol_array(payload, frame_len, seq_len, ins_rat,
                                                 pilots=pilots, nframes=2)
    s2 = psig.resample(2 * fb, beta=roll, renormalise=True)
    s2 = s2.replace(samples=torch.roll(s2.samples, 5000, dims=-1))
    # the transmitter: clipping DAC -> amplifier -> modulator
    dac = impairments.sim_DAC_response(s2, enob=6, clip_rat=0.6, cutoff=16e9, fn=None, ch=None,
                                       generator=_common.gen(1, dev))
    amp = cimpairments.ideal_amplifier_response(dac.samples, 2.0 / VPI)
    sig_mod = s2.replace(samples=cimpairments.modulator_response(amp))
    # constant ASE: an absolute noise power, scaled by the oversampling
    noise_var = 10 ** (-13.6 / 10) / 10 ** (snr / 10) * (s2.fs / s2.fb)
    sig_h = impairments.add_awgn(sig_mod, np.sqrt(noise_var), generator=_common.gen(2, dev))
    # the receiver
    r = helpers.normalise_and_center(sig_h.resample(2 * fb, beta=roll, renormalise=True))
    ok = bool(r.sync2frame(Niter=sync_Niter))
    print("shift factors:", r.shiftfctrs)
    r.corr_foe()
    # blocks of 32: at a step of 1e-2 the block trainer's default blocks of 128 on the card
    # (the reference's accelerator default) diverge, BER 0.5 (PERF.md); the CPU's
    # per-symbol trainer takes no block
    taps, eq = equalisation.pilot_equaliser(r, (1e-2, 1e-2), 31, foe_comp=False,
                                            methods=("mcma", "mddma"), block_size=32)
    out, _ = phaserec.pilot_cpe(eq, N=5, use_seq=False)
    ber, ser, gmi = out.cal_ber().tolist(), out.cal_ser().tolist(), out.cal_gmi()[0].tolist()
    print("constant-ASE model @%d dB (clip 0.6): BER %s SER %s GMI %s"
          % (snr, np.round(ber, 5).tolist(), np.round(ser, 5).tolist(),
             np.round(gmi, 3).tolist()))
    return {"sync": ok, "ber": ber, "ser": ser, "gmi": gmi}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
