"""A multi-frame pilot receiver over an impaired link, on the port.

The port of ``examples/run_pilot.py``: a ``SignalWithPilots`` capture with
a 100 MHz offset, 100 kHz linewidth, DGD and modal delay, the frame rolled;
``sync2frame(Ntaps=17)``, ``corr_foe``, ``pilot_equaliser`` with ("cma",
"sbd_data"), ``pilot_cpe``; BER, GMI and the estimated SNR.
Run: python examples_torch/run_pilot.py [--device cpu]
"""
import _common
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, impairments, phaserec
from qampy_tpu_torch.utils import resolve_device

# config 4's channel (sim_pilot_txrx.py): the same BER gate; GMI as there
GATES = {"sync": ("==", True), "ber": ("<=", 4.590e-3), "gmi": (">=", 5.5)}


def main(device=None, frame_len=2 ** 16, seq_len=1024, nframes=3, sync_Niter=10):
    dev = resolve_device(device)
    fb = 24e9
    sig = qt.SignalWithPilots(64, frame_len, seq_len, 32, nframes=nframes, nmodes=2, fb=fb,
                              seed=22, device=dev)
    sig = sig.resample(2 * fb, beta=0.01)
    sig = impairments.simulate_transmission(sig, snr=25, freq_off=100e6, lwdth=100e3,
                                            dgd=10e-12, modal_delay=(2000, 2000),
                                            roll_frame_sync=True, generator=_common.gen(3, dev))
    found = bool(sig.sync2frame(Ntaps=17, Niter=sync_Niter))
    print("frame sync:", found, "shifts:", sig.shiftfctrs)
    sig.corr_foe()
    taps, eq_sig = equalisation.pilot_equaliser(sig, (1e-3, 1e-3), 45, foe_comp=False,
                                                methods=("cma", "sbd_data"))
    cpe_sig, phase = phaserec.pilot_cpe(eq_sig, N=5, use_seq=False)
    ber, gmi = cpe_sig.cal_ber().tolist(), cpe_sig.cal_gmi()[0].tolist()
    snr = (10 * torch.log10(torch.as_tensor(cpe_sig.est_snr()))).tolist()
    print("BER:", ber)
    print("GMI:", gmi)
    print("SNR (dB):", snr)
    return {"sync": found, "ber": ber, "gmi": gmi, "snr_db": snr}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
