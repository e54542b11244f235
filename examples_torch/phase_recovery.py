"""Blind phase search carrier recovery under laser phase noise, on the port.

The port of ``examples/phase_recovery.py`` (BASELINE config 3): 64-QAM at
30 dB with a 100 kHz linewidth through ``phaserec.bps_twostage(sig, 32, 14,
B=8)`` (on the card: the search kernel B3, the fine search B8 and the
rotation B6).
Run: python examples_torch/phase_recovery.py [--device cpu]
"""
import _common

import qampy_tpu_torch as qt
from qampy_tpu_torch import helpers, impairments, phaserec
from qampy_tpu_torch.utils import resolve_device

GATES = {"ser": ("<=", 1e-4)}


def main(device=None, N=2 ** 17):
    dev = resolve_device(device)
    sig = qt.SignalQAMGrayCoded(64, N, fb=40e9, seed=3, device=dev)
    sig = impairments.change_snr(sig, 30, generator=_common.gen(2, dev))
    sig = impairments.apply_phase_noise(sig, 100e3, generator=_common.gen(3, dev))
    rec, phase = phaserec.bps_twostage(sig, 32, 14, B=8)
    rec = rec.replace(samples=helpers.dump_edges(rec.samples, 20))
    ser = rec.cal_ser().tolist()
    print("SER after two-stage BPS:", ser)
    return {"ser": ser}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
