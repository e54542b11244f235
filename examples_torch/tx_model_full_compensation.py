"""The transmitter model with full digital pre-compensation against the plain drive, on the port.

The port of ``examples/tx_model_full_compensation.py``: a pilot-framed
64-QAM transmitter through the analog front end (8-bit quantiser, a 5-bit
ENOB band-limited DAC, the amplifier, the Mach-Zehnder sine transfer,
constant-power noise), received by the pilot receiver (``sync2frame``,
mcma/mddma pilot equaliser, pilot CPE), with the plain drive against the
fully pre-compensated one (arcsin inverse of the modulator, headroom
rescale, clipper) at a quasi-linear and at full drive. At full drive the
pre-distortion wins by about an order of magnitude in SER.
Run: python examples_torch/tx_model_full_compensation.py [--device cpu]
"""
import _common
import numpy as np
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, helpers, impairments, phaserec
from qampy_tpu_torch.core import digital_pre_compensation as dpc
from qampy_tpu_torch.core import impairments as cimpairments
from qampy_tpu_torch.utils import resolve_device

# the JAX example's asserts: every SER below 5e-2, and at full drive the compensated
# transmitter's SER below half the plain one's (comp_over_plain <= 0.5)
GATES = {"sync": ("==", True), "ser": ("<=", 5e-2), "comp_over_plain": ("<=", 0.5)}


def main(device=None, frame_len=2 ** 14, seq_len=1024, sync_Niter=10, drives=(2.8, 7.0)):
    dev = resolve_device(device)
    M, ins_rat, fb, roll = 64, 32, 40e9, 0.1
    VPI, SNR_ASE = 3.5, 28
    psig = qt.SignalWithPilots(M, frame_len, seq_len, ins_rat, nmodes=1, Mpilots=4, nframes=2,
                               fb=fb, seed=7, device=dev)
    s2 = psig.resample(2 * fb, beta=roll)
    # a delay for the frame sync to find
    s2 = s2.replace(samples=torch.roll(s2.samples, 5000, dims=-1))
    noise_var = 10 ** (-13.6 / 10) / 10 ** (SNR_ASE / 10)
    syncs = []

    def pilot_rx(sig_h):
        r = helpers.normalise_and_center(sig_h.resample(2 * fb, beta=roll, renormalise=True))
        syncs.append(bool(r.sync2frame(Niter=sync_Niter)))
        # blocks of 32: at a step of 1e-2 the block trainer's default blocks of 128 on the
        # card diverge (constant_ase_noise_model.py); the CPU's per-symbol trainer takes none
        taps, eq = equalisation.pilot_equaliser(r, (1e-2, 1e-2), 31, foe_comp=False,
                                                methods=("mcma", "mddma"),
                                                adaptive_stepsize=True, block_size=32)
        out, _ = phaserec.pilot_cpe(eq, N=5, use_seq=False)
        return float(out.cal_ser()[0]), float(out.cal_ber()[0])

    def tx_and_rx(drive_samples, vpp, seed):
        dac = impairments.sim_DAC_response(s2.replace(samples=drive_samples), enob=5,
                                           quant_bits=8, cutoff=16e9, fn=None, ch=None,
                                           generator=_common.gen(1, dev))
        # the modulator in units of Vpi: vpp volts drive (vpp/2)/Vpi
        amp = cimpairments.ideal_amplifier_response(dac.samples, (vpp / 2) / VPI)
        mzm = cimpairments.modulator_response(amp)
        rx_in = impairments.add_awgn(s2.replace(samples=mzm), np.sqrt(noise_var * 2),
                                     generator=_common.gen(seed, dev))
        return pilot_rx(rx_in)

    res = {"drive": [], "ser": [], "ber": [], "comp_over_plain": None}
    for vpp in drives:      # Vpp/(2 Vpi) = 0.4 (linear) and 1.0 (full drive)
        plain = helpers.rescale_signal(s2, 1.0).samples
        ser_u, ber_u = tx_and_rx(plain, vpp, 2)
        # full compensation: arcsin inverse of sin(pi V / 2), headroom rescale, clip
        arc = dpc.comp_mod_sin(helpers.rescale_signal(s2, 1.0).samples, vpi=1 / np.pi)
        comp = dpc.clipper(helpers.rescale_signal(arc, 1.4), 1.0)
        ser_c, ber_c = tx_and_rx(comp, vpp, 2)
        res["drive"].append(vpp)
        res["ser"] += [ser_u, ser_c]
        res["ber"] += [ber_u, ber_c]
        res["comp_over_plain"] = ser_c / max(ser_u, 1e-12)
        print("Vpp/(2*Vpi)=%.2f  plain SER %.2e BER %.2e | full-comp SER %.2e BER %.2e"
              % (vpp / (2 * VPI), ser_u, ber_u, ser_c, ber_c))
    res["sync"] = syncs
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
