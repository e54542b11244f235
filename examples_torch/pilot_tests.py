"""The pilot receiver with modal delay and a data-aided second stage, on the port.

The port of ``examples/pilot_tests.py``: a ``SignalWithPilots`` capture
through ``simulate_transmission`` (20 dB, 10 ps DGD, modal delays of 2000
and 3000 samples, the frame rolled), ``sync2frame``, ``corr_foe``,
``pilot_equaliser`` with ("cma", "sbd_data") and ``pilot_cpe``; the GMI.
Run: python examples_torch/pilot_tests.py [--device cpu]
"""
import _common

import qampy_tpu_torch as qt
from qampy_tpu_torch import equalisation, impairments, phaserec
from qampy_tpu_torch.utils import resolve_device

GATES = {"sync": ("==", True), "gmi": (">=", 4.5)}


def main(device=None, frame_len=2 ** 16, seq_len=2 ** 10, nframes=3, sync_Niter=10):
    dev = resolve_device(device)
    mysig = qt.SignalWithPilots(64, frame_len, seq_len, 32, nmodes=2, nframes=nframes,
                                fb=24e9, seed=6, device=dev)
    mysig2 = mysig.resample(mysig.fb * 2, beta=0.01)
    mysig3 = impairments.simulate_transmission(mysig2, snr=20, dgd=10e-12, roll_frame_sync=True,
                                               modal_delay=[2000, 3000],
                                               generator=_common.gen(2, dev))
    ok = bool(mysig3.sync2frame(Niter=sync_Niter))
    print("shift factors:", mysig3.shiftfctrs)
    mysig3.corr_foe()
    wxy, eq_sig = equalisation.pilot_equaliser(mysig3, (1e-3, 1e-3), 45, foe_comp=False,
                                               methods=("cma", "sbd_data"))
    cpe_sig, ph = phaserec.pilot_cpe(eq_sig, N=5, use_seq=False)
    gmi = cpe_sig.cal_gmi()[0].tolist()
    print("GMI:", gmi)
    return {"sync": ok, "gmi": gmi}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
