"""Serving a long capture as chunked dispatches, on the port.

The port of ``examples/long_capture_serving.py``:

* the blind chain: the capture split into dispatch-sized chunks with a
  halo on each side; each dispatch trains on its own 2^14-symbol prefix and
  the halo takes the filter's ramp and the phase search's edge window. Each
  dispatch keeps the blind receiver's own pi/2 ambiguity per mode, so each
  chunk is checked under one fixed alignment (delay, pairing) with its own
  quarter turns, as tests/test_long_capture.py checks it;
* the pilot chain: the full chain (frame sync and training) once, then
  ``tracking`` with ``info["taps"]``, ``info["shift"]`` and
  ``info["mode_order"]`` for every further dispatch, each at
  ``_frame_base = d * n_per * frame_len * os``: no prefix, no rebuild of
  the chain, frame-aligned.
Run: python examples_torch/long_capture_serving.py [--device cpu]
"""
import _common
import numpy as np
import torch
import torch.nn.functional as F

import qampy_tpu_torch as qt
from qampy_tpu_torch import impairments
from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu_torch.utils import resolve_device

GATES = {"blind_chunk_ser": ("<=", 5e-3), "blind_one_alignment": ("==", True),
         "pilot_ser": ("<=", 1e-2)}
HALO_SYM = 96


def dec_idx(z, const):
    return np.argmin(np.abs(np.asarray(z)[:, None] - const[None, :]), axis=1)


def find_alignment(out, ref, const, probe=2 ** 15, max_off=8):
    """(perm, offsets, quarter turns) of a recovered stream against the sent symbols, from
    a probe window (tests/test_long_capture.py:29-63)."""
    best = (1.0, None)
    probe = min(probe, out.shape[-1] - 2 * max_off)
    for perm in ([0, 1], [1, 0]):
        offs, rots, sers = [], [], []
        for m in range(2):
            ridx = dec_idx(ref[m][max_off:max_off + probe], const)
            cand = []
            for off in range(-max_off, max_off + 1):
                o = out[perm[m]][max_off + off:max_off + off + probe]
                for k in range(4):
                    cand.append((np.mean(dec_idx(o * 1j ** k, const) != ridx), off, k))
            s, off, k = min(cand)
            offs.append(off)
            rots.append(k)
            sers.append(s)
        if float(np.mean(sers)) < best[0]:
            best = (float(np.mean(sers)), (perm, offs, rots))
    return best[1]


def ser_aligned(out, ref, const, align, lo, hi):
    """The mean SER of both modes over ``[lo, hi)`` of ``ref`` under a fixed alignment."""
    perm, offs, rots = align
    return float(np.mean([np.mean(dec_idx(out[perm[m]][lo + offs[m]:hi + offs[m]] * 1j ** rots[m],
                                          const) != dec_idx(ref[m][lo:hi], const))
                          for m in range(2)]))


def blind_capture(dev, Nsym, M=16, os_=2):
    """The blind capture (the symbol-rate signal, (2n, L) planes padded by the halo)."""
    sig = qt.SignalQAMGrayCoded(M, Nsym, nmodes=2, fb=25e9, seed=21, device=dev)
    s2 = impairments.apply_PMD(sig.resample(os_ * sig.fb, beta=0.1), np.pi / 5.6, 25e-12)
    s2 = impairments.change_snr(s2, 25, generator=_common.gen(2, dev))
    halo = HALO_SYM * os_
    return sig, F.pad(eqops.planes(s2.samples), (halo, halo + 16))


def blind_chain(dev, M=16, os_=2, block_size=256):
    return make_rx_chain(M=M, Ntaps=11, os=os_, methods=("cma", "sbd"), mu=1e-3, bps_angles=32,
                         bps_N=8, TrSyms=2 ** 14, block_size=block_size, device=dev)


def blind_segment(Pp, c, chunk_sym, os_=2):
    """Planes of dispatch ``c``: its chunk and the halo on each side."""
    lo = c * chunk_sym * os_
    return Pp[:, lo:lo + chunk_sym * os_ + 2 * HALO_SYM * os_ + 16]


def blind_check(sig, outs, chunk_sym):
    """Per-chunk SER under each chunk's alignment, and whether delay and pairing agree."""
    out = np.concatenate([o.cpu().numpy() for o in outs], axis=-1)
    ref = sig.symbols.cpu().numpy()
    const = np.unique(sig.coded_symbols_host)
    Nsym = out.shape[-1]
    aligns, sers = [], []
    for c in range(len(outs)):
        lo, hi = max(c * chunk_sym, 64), min((c + 1) * chunk_sym, Nsym - 64)
        a = find_alignment(out[:, lo:hi], ref[:, lo:hi], const)
        aligns.append(a)
        sers.append(ser_aligned(out[:, lo:hi], ref[:, lo:hi], const, a, 16, hi - lo - 16))
    same = len({tuple(a[0]) for a in aligns}) == 1 and len({tuple(a[1]) for a in aligns}) == 1
    return sers, same


def blind_chunked(dev, Nsym=2 ** 20, chunk_sym=2 ** 18, M=16, os_=2):
    sig, Pp = blind_capture(dev, Nsym, M, os_)
    chain = blind_chain(dev, M, os_)
    outs = []
    for c in range(Nsym // chunk_sym):
        outr, outi = chain.planes(blind_segment(Pp, c, chunk_sym, os_))
        outs.append(torch.complex(outr, outi)[:, HALO_SYM:HALO_SYM + chunk_sym])
    sers, same = blind_check(sig, outs, chunk_sym)
    print("blind chunked: %d symbols in %d dispatches, SER per chunk %s, one delay and pairing: %s"
          % (Nsym, len(outs), sers, same))
    return sers, same


def pilot_capture(dev, nframes, M=64, F_=2 ** 16, P=1024, R=32):
    sig = qt.SignalWithPilots(M, F_, P, R, nframes=nframes, nmodes=2, fb=24e9, seed=7,
                              device=dev)
    s2 = impairments.simulate_transmission(
        sig.resample(2 * sig.fb, beta=0.1, renormalise=True), snr=28, lwdth=10e3, dgd=15e-12,
        theta=np.pi / 4.7, roll_frame_sync=True, generator=_common.gen(9, dev))
    return sig, s2.samples


def pilot_chain(sig, n_per, dev, Ntaps=45, block_size=128, first=0):
    """The LMS pilot chain over frames ``first .. first + n_per - 1``."""
    return make_pilot_rx_chain(sig.pilot_seq.cpu().numpy(), sig.ph_pilots.cpu().numpy(),
                               sig.frame_len, sig.pilot_ins_rat, os=2, M=sig.M, nmodes=2,
                               Ntaps=Ntaps, mu=(1e-3, 1e-3), Niter=30, cpe_avg=3,
                               frames=tuple(range(first, first + n_per)), return_phase=False,
                               block_size=block_size, device=dev)


def frame_ser(sig, dat, fr, k):
    """The SER of frame ``fr`` of the capture, the ``k``-th frame of a dispatch's payload."""
    n_data = sig.get_data(frames=[fr]).samples.shape[-1]
    rec = sig.get_data(frames=[fr]).replace(samples=dat[:, k * n_data:(k + 1) * n_data])
    return float(rec.cal_ser(synced=True).mean())


def pilot_tracking(dev, n_per=5, ndisp=3, F_=2 ** 16, Ntaps=45):
    sig, E = pilot_capture(dev, n_per * ndisp + 1, F_=F_)
    chain = pilot_chain(sig, n_per, dev, Ntaps)
    data0, info = chain(E)                             # the full chain once
    datas = [data0]
    for d in range(1, ndisp):                          # dispatches with no prefix
        dat, _ = chain.tracking(E, info["taps"], info["shift"], mode_order=info["mode_order"],
                                _frame_base=d * n_per * F_ * 2)
        datas.append(dat)
    sers = []
    for d, dat in enumerate(datas):
        sers.append(frame_ser(sig, dat, d * n_per, 0))
        print("pilot dispatch %d (frames %d-%d): SER %s" % (d, d * n_per, d * n_per + n_per - 1,
                                                           sers[-1]))
    return sers


def main(device=None, Nsym=2 ** 20, chunk_sym=2 ** 18, n_per=5, ndisp=3, frame_len=2 ** 16,
         Ntaps=45):
    dev = resolve_device(device)
    sers, same = blind_chunked(dev, Nsym, chunk_sym)
    psers = pilot_tracking(dev, n_per, ndisp, frame_len, Ntaps)
    return {"blind_chunk_ser": sers, "blind_one_alignment": same, "pilot_ser": psers}


if __name__ == "__main__":
    main(**_common.cli(__doc__))
