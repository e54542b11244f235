"""The serving entries of the port: the blind chain and the pilot chain, each one module.

The port of ``examples/fused_rx_serving.py``: ``ops.chain.make_rx_chain``
runs the whole blind receiver (two-stage MIMO equalisation on kernel B1,
the filter B2, the blind phase search B3, the derotation B7, or B4 in the
decimated mode) and ``ops.pilot_chain.make_pilot_rx_chain`` the whole pilot
receiver (frame sync, pilot training, the frames filtered by B2's frame
entry, the pilot CPE by B5 and B4). Both take float32 planes in and give
planes out (``planes``, ``tracking_planes``), and the pilot chain's
tracking entries skip the sync and the training with the state of an
earlier dispatch, bit for bit.
Run: python examples_torch/fused_rx_serving.py [--device cpu]
"""
import _common
import numpy as np
import torch

import qampy_tpu_torch as qt
from qampy_tpu_torch import impairments
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu_torch.utils import resolve_device

GATES = {"blind_ser": ("<=", 1e-3), "decimated_ser": ("<=", 1e-3),
         "pilot_sync_corr": (">=", 120.0), "pilot_ber": ("<=", 1e-3),
         "tracking_identical": ("==", True), "planes_tracking_identical": ("==", True),
         "pilot_ls_ber": ("<=", 1e-3)}


def host(x):
    return x.cpu().numpy()


def main(device=None, N=2 ** 15, TrSyms=2 ** 13, frame_len=2 ** 14, seq_len=512, nframes=5,
         frames=(0, 1, 2)):
    dev = resolve_device(device)
    res = {}
    # ---- blind chain: dual-pol 64-QAM MCMA -> MDDMA -> BPS ----------------
    sig = qt.SignalQAMGrayCoded(64, N, nmodes=2, fb=25e9, seed=5, device=dev)
    s2 = sig.resample(50e9, beta=0.1, renormalise=True)
    s2 = impairments.simulate_transmission(s2, snr=33, lwdth=20e3, dgd=20e-12,
                                           theta=np.pi / 5.6, generator=_common.gen(1, dev))
    fwd = make_rx_chain(M=64, Ntaps=17, os=2, bps_angles=32, bps_N=10, block_size=128,
                        TrSyms=TrSyms, device=dev)
    print("blind chain backend:", fwd.backend_info)
    out = fwd(s2.samples)
    res["blind_ser"] = sig.replace(samples=out[:, 200:-200]).cal_ser().tolist()
    print("blind chain SER:", res["blind_ser"])
    # the phase search on the filter's stride-8 side output, derotated by interpolation
    fwd_dec = make_rx_chain(M=64, Ntaps=17, os=2, bps_angles=64, bps_N=10, block_size=128,
                            TrSyms=TrSyms, bps_mode="decimated", device=dev)
    out_dec = fwd_dec(s2.samples)
    res["decimated_ser"] = sig.replace(samples=out_dec[:, 200:-200]).cal_ser().tolist()
    print("decimated-BPS chain SER:", res["decimated_ser"])

    # ---- pilot chain: the whole SignalWithPilots receiver -----------------
    psig = qt.SignalWithPilots(64, frame_len, seq_len, 32, nframes=nframes, nmodes=2, fb=24e9,
                               seed=7, device=dev)
    p2 = psig.resample(2 * psig.fb, beta=0.1, renormalise=True)
    p2 = impairments.simulate_transmission(p2, snr=30, lwdth=20e3, dgd=20e-12,
                                           theta=np.pi / 4.3, roll_frame_sync=True,
                                           generator=_common.gen(2, dev))
    kw = dict(os=2, M=64, nmodes=2, Ntaps=17, Niter=30, cpe_avg=3, frames=tuple(frames),
              return_phase=False, device=dev)
    pfwd = make_pilot_rx_chain(host(psig.pilot_seq), host(psig.ph_pilots), psig.frame_len,
                               psig.pilot_ins_rat, **kw)
    data, info = pfwd(p2.samples)
    pout = psig.get_data(frames=list(frames)).replace(samples=data)
    res["pilot_sync_corr"] = float(info["sync_corr"])
    res["pilot_ber"] = pout.cal_ber(synced=True).tolist()
    print("pilot sync corr: %.0f (threshold 120)" % res["pilot_sync_corr"])
    print("pilot chain BER:", res["pilot_ber"])
    # steady-state tracking: the found taps and shift, no sync and no training
    data2, _ = pfwd.tracking(p2.samples, info["taps"], info["shift"], info["mode_order"])
    res["tracking_identical"] = bool(torch.equal(data2, data))
    print("tracking output identical:", res["tracking_identical"])
    # planes in, planes out: bit-identical to the complex entries
    E = p2.samples
    (dr, di), _ = pfwd.tracking_planes(E.real.contiguous(), E.imag.contiguous(), info["taps"],
                                       info["shift"], info["mode_order"])
    res["planes_tracking_identical"] = bool(torch.equal(torch.complex(dr, di), data))
    print("planes tracking identical:", res["planes_tracking_identical"])
    # the closed-form pilot trainer: one Gram matrix and solve a mode
    pfwd_ls = make_pilot_rx_chain(host(psig.pilot_seq), host(psig.ph_pilots), psig.frame_len,
                                  psig.pilot_ins_rat, eq_trainer="ls", **kw)
    data_ls, _ = pfwd_ls(p2.samples)
    res["pilot_ls_ber"] = psig.get_data(frames=list(frames)).replace(
        samples=data_ls).cal_ber(synced=True).tolist()
    print("pilot chain (LS trainer) BER:", res["pilot_ls_ber"])
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
