"""Serving alphabets that are not a grid, and shaped ones, on the port.

The port of ``examples/general_alphabet_serving.py``. The blind chain takes
any alphabet as ``symbols=`` (up to 256 points): the decisions, the blind
constants and the phase searches read its points where no uniform grid
fits (kernels B1, B3 and B8 on the points, or the fitted grid where the
host probes accept it: ``backend_info``):

* a radially warped 64-point alphabet through the blind chain, with modulus
  criteria in both stages and the two-stage phase search;
* Maxwell-Boltzmann shaped 64-QAM: the support is still a grid;
* a warped 256-point payload through the pilot chain, whose data-aided
  training and payload path take any alphabet.
Run: python examples_torch/general_alphabet_serving.py [--device cpu]
"""
import itertools

import _common
import numpy as np

import qampy_tpu_torch as qt
from qampy_tpu_torch import theory
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.utils import resolve_device

GATES = {"warped64_ser": ("<=", 1e-2), "mbps64_ser": ("<=", 1e-2), "warped256_ser": ("<=", 1e-2)}


def warped_qam(M, k=0.18):
    c = cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))
    w = c * (1 + k * (np.abs(c) ** 2 - 1))
    return (w / np.sqrt(np.mean(np.abs(w) ** 2))).astype(np.complex64)


def ser_vs(out, ref, const, trim=300):
    """Nearest-point SER: per mode the least over pi/2 rotations and delays 3-5, the
    polarisations paired by a permutation (tools/genbench.py's gate)."""
    o = out.cpu().numpy()[:, trim:-trim]
    nm = o.shape[0]
    ser_mr = np.ones((nm, nm))
    for m in range(nm):
        for rm in range(nm):
            for rot in range(4):
                for off in (3, 4, 5):
                    r = ref[rm][trim + off:trim + off + o.shape[1]]
                    dec = np.argmin(np.abs((o[m] * 1j ** rot)[:, None] - const[None, :]), -1)
                    rdec = np.argmin(np.abs(r[:, None] - const[None, :]), -1)
                    ser_mr[m, rm] = min(ser_mr[m, rm], float(np.mean(dec != rdec)))
    return float(min(np.mean([ser_mr[m, p[m]] for m in range(nm)])
                     for p in itertools.permutations(range(nm))))


def tx(const, L, seed, dev, probs=None, snr=35):
    """Dual-pol symbols of ``const`` through the reference's impairment order (phase noise,
    noise, PMD) at two samples a symbol: (capture, sent symbols as host numpy)."""
    rng = np.random.default_rng(seed)
    M = const.shape[0]
    idx = (rng.choice(M, size=(2, L), p=probs) if probs is not None
           else rng.integers(0, M, size=(2, L)))
    syms = const[idx]
    sig = qt.SymbolOnlySignal.from_symbol_array(syms, coded_symbols=const, fb=25e9, device=dev)
    s2 = sig.resample(50e9, beta=0.1, renormalise=True)
    s2 = qt.impairments.simulate_transmission(s2, snr=snr, lwdth=20e3, dgd=20e-12,
                                              theta=np.pi / 5.6, generator=_common.gen(seed, dev))
    return s2.samples, syms


def main(device=None, N=2 ** 16, TrSyms=2 ** 15, frame_len=2 ** 14, seq_len=512, nframes=4):
    dev = resolve_device(device)
    res = {}
    # ---- 1. a warped (not a grid) 64-point alphabet, the blind chain -------
    const = warped_qam(64)
    E, syms = tx(const, N, 3, dev)
    fwd = make_rx_chain(Ntaps=17, os=2, methods=("mcma", "mcma"), mu=1.9e-3, bps_angles=64,
                        bps_N=14, block_size=128, symbols=const, bps_mode="twostage",
                        TrSyms=TrSyms, device=dev)
    print("warped-64 backend:", fwd.backend_info)
    res["warped64_ser"] = ser_vs(fwd(E), syms, const)
    print("warped-64 blind chain SER: %.2e" % res["warped64_ser"])

    # ---- 2. MB-shaped 64-QAM (its support a grid) ---------------------------
    base = (cal_symbols_qam(64) / np.sqrt(cal_scaling_factor_qam(64))).astype(np.complex64)
    lv, pl = theory.cal_ps_probablts(base, 0.5)
    probs = pl[np.searchsorted(lv, base.real)] * pl[np.searchsorted(lv, base.imag)]
    probs = probs / probs.sum()
    coded = (base / np.sqrt(np.sum(probs * np.abs(base) ** 2))).astype(np.complex64)
    H = float(-np.sum(probs * np.log2(probs)))
    E, syms = tx(coded, N, 5, dev, probs=probs)
    fwd = make_rx_chain(Ntaps=17, os=2, methods=("mcma", "sbd"), mu=1.9e-3, bps_angles=64,
                        bps_N=14, block_size=128, symbols=coded, bps_mode="twostage",
                        TrSyms=TrSyms, device=dev)
    res["mbps64_ser"] = ser_vs(fwd(E), syms, coded)
    print("MB-PS 64-QAM (H=%.2f bits) blind chain SER: %.2e" % (H, res["mbps64_ser"]))

    # ---- 3. a warped 256-point payload through the pilot chain --------------
    c256 = warped_qam(256)
    rng = np.random.default_rng(6)
    npl = (frame_len - seq_len) * (32 - 1) // 32
    pay = c256[rng.integers(0, 256, size=(2, npl))]
    pays = qt.SymbolOnlySignal.from_symbol_array(pay, coded_symbols=c256, fb=24e9, device=dev)
    # the pilots drawn from a seed, so that a run repeats (the JAX example draws them unseeded)
    pilots = qt.SignalQAMGrayCoded(4, seq_len + (frame_len - seq_len) // 32, nmodes=2, fb=24e9,
                                   seed=6, device=dev)
    sig = qt.SignalWithPilots.from_symbol_array(pays, frame_len, seq_len, 32, pilots=pilots,
                                                nframes=nframes)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    s2 = qt.impairments.simulate_transmission(s2, snr=40, dgd=20e-12, theta=np.pi / 4.3,
                                              lwdth=20e3, roll_frame_sync=True,
                                              generator=_common.gen(9, dev))
    pfwd = make_pilot_rx_chain(sig.pilot_seq.cpu().numpy(), sig.ph_pilots.cpu().numpy(),
                               sig.frame_len, sig.pilot_ins_rat, os=2, M=256, nmodes=2,
                               Ntaps=17, Niter=30, cpe_avg=3, frames=(0, 1), device=dev)
    d, info = pfwd(s2.samples)
    ref = sig.get_data(frames=[0, 1]).samples.cpu().numpy()
    dec = np.argmin(np.abs(d.cpu().numpy()[..., None] - c256[None, None, :]), -1)
    rdec = np.argmin(np.abs(ref[..., None] - c256[None, None, :]), -1)
    res["warped256_ser"] = np.mean(dec != rdec, axis=-1).tolist()
    print("warped-256 payload via pilot chain SER: %s" % res["warped256_ser"])
    return res


if __name__ == "__main__":
    main(**_common.cli(__doc__))
