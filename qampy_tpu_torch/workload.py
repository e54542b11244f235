"""The benchmark workloads without JAX (counterpart of four pieces of ``bench.py``).

Blind receiver: ``make_tx`` synthesises the dual-pol capture host-side in
numpy (bench.py:24-87), on M-QAM or on any alphabet (``warped_qam`` and
``apsk_const`` are the reference's two, tools/genbench.py:27-54);
``ser_gate`` is the correctness gate in torch: the bench's per-axis gate on
a square grid (bench.py:127-154), the nearest-point gate on any other
alphabet (tools/qam32_bench.py:54-98). Pilot receiver: ``make_pilot_tx`` states the
pilot capture of ``bench.pilot_maketx`` (bench.py:318-397) in torch on any
device; ``ber_gate`` is the bench's BER gate (bench.py:459-497).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from qampy_tpu_torch.core import impairments
from qampy_tpu_torch.core.metrics import decision_idx
from qampy_tpu_torch.ops.phase import detect_square_grid
from qampy_tpu_torch.signals import cal_pilot_idx, generate_mapping
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.utils import resolve_device

#: the gate's edge trim: dec*N of the decimated search must stay inside it
GATE_TRIM = 200
#: the pilot bench's gates: BER (reference tolerance, test_pilot_signal.py:103-118)
#: and the weakest pilot correlation peak a frame sync is trusted at (bench.py:497)
BER_LIMIT = 1e-5
SYNC_CORR_MIN = 120


def rrc_response(L, os, fb, beta=0.1):
    """Root-raised-cosine amplitude response on the FFT grid of L samples at os*fb, peak 1."""
    f = np.fft.fftfreq(L) * (os * fb)
    T = 1 / fb
    af = np.abs(f)
    rc = np.zeros(L)
    rc[af <= (1 - beta) / (2 * T)] = T
    mask = (af > (1 - beta) / (2 * T)) & (af <= (1 + beta) / (2 * T))
    rc[mask] = T / 2 * (1 + np.cos(np.pi * T / beta * (af[mask] - (1 - beta) / (2 * T))))
    h = np.sqrt(rc)
    return h / h.max()


def warped_qam(M, k=0.18):
    """Radially warped M-QAM, a grid-breaking geometric shaping (tools/genbench.py:27-37).

    c' = c (1 + k (|c|^2 - 1)), normalised to unit power: the outer points
    pushed out, the inner pulled in, so that no uniform per-axis spacing
    survives and ``detect_grid`` classifies it "gen".
    """
    c = cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))
    w = c * (1 + k * (np.abs(c) ** 2 - 1))
    return (w / np.sqrt(np.mean(np.abs(w) ** 2))).astype(np.complex64)


def apsk_const(M=32):
    """DVB-S2-style 32-APSK (tools/genbench.py:40-54): rings of 4, 12 and 16 points.

    Radius ratios 1 : 2.84 : 5.27, normalised to unit power. A ring
    alphabet fails the fitted-grid probe of the coarse search
    (``ops.phase.coarse_grid_for_alphabet`` returns None), so both stages of
    the two-stage search run on the alphabet itself.
    """
    if M != 32:
        raise ValueError("apsk_const builds the 32-point alphabet, got M=%r" % (M,))
    pts = [rad * np.exp(1j * (2 * np.pi * np.arange(n) / n + off))
           for n, rad, off in ((4, 1.0, np.pi / 4), (12, 2.84, np.pi / 12), (16, 5.27, 0.0))]
    c = np.concatenate(pts)
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


def make_tx(Nsym=2 ** 20, M=64, fb=25e9, seed=1, const=None, probs=None, snr=35):
    """Host-side TX synthesis: dual-pol QAM, RRC 2x oversampling, phase noise, AWGN, PMD.

    Same array as ``bench.make_tx`` for the same arguments: M-QAM, or a
    caller's alphabet ``const``, drawn uniformly or with the probabilities
    ``probs`` (the alphabet is then rescaled to unit mean symbol power).
    Returns (capture (2, 2*Nsym) complex64, transmitted symbols (2, Nsym)
    complex64, constellation).
    """
    rng = np.random.default_rng(seed)
    if const is not None:
        const = np.asarray(const).astype(np.complex64).reshape(-1)
        M = const.shape[0]
    else:
        const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
    coded = const
    if probs is not None:
        probs = np.asarray(probs, dtype=np.float64)
        probs = probs / probs.sum()
        sym_idx = rng.choice(M, size=(2, Nsym), p=probs)
        coded = (const / np.sqrt(np.sum(probs * np.abs(const) ** 2))).astype(np.complex64)
    else:
        sym_idx = rng.integers(0, M, size=(2, Nsym))
    syms = coded[sym_idx]
    # zero-insertion upsample + RRC shaping (frequency domain)
    os = 2
    L = Nsym * os
    up = np.zeros((2, L), dtype=np.complex64)
    up[:, ::os] = syms
    h = rrc_response(L, os, fb)
    sig = np.fft.ifft(np.fft.fft(up, axis=-1) * h, axis=-1).astype(np.complex64)
    sig /= np.sqrt(np.mean(np.abs(sig) ** 2, axis=-1, keepdims=True))
    # phase noise (Wiener, 20 kHz combined linewidth)
    var = 2 * np.pi * 20e3 / (os * fb)
    ph = np.cumsum(rng.normal(scale=np.sqrt(var), size=(2, L)), axis=-1)
    sig = sig * np.exp(1j * ph).astype(np.complex64)
    # AWGN (os-aware; default 35 dB)
    n_amp = 10 ** (-snr / 20) * np.sqrt(os)
    sig = sig + (n_amp / np.sqrt(2) * (rng.standard_normal((2, L)) +
                 1j * rng.standard_normal((2, L)))).astype(np.complex64)
    # PMD: rotation + DGD in the frequency domain
    theta = np.pi / 5.6
    t_dgd = 50e-12
    omega = 2 * np.pi * np.linspace(-os * fb / 2, os * fb / 2, L, endpoint=False)
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    Sf = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(sig, axes=-1), axis=-1), axes=-1)
    Sf = R @ Sf
    Sf *= np.exp(np.array([-1, 1])[:, None] * 1j * omega * t_dgd / 2)
    Sf = R.T @ Sf
    sig = np.fft.fftshift(np.fft.ifft(np.fft.ifftshift(Sf, axes=-1), axis=-1), axes=-1)
    return sig.astype(np.complex64), syms.astype(np.complex64), coded


def nearest_idx(z, const, chunk=2 ** 18):
    """Index of the nearest point of ``const`` for every element of the 1-D complex ``z``.

    argmax_k 2<z, s_k> - |s_k|^2, which is argmin_k |z - s_k|^2, in chunks
    of ``chunk`` samples. The gate of an alphabet without per-axis levels
    (tools/qam32_bench.py:64-70).
    """
    c = torch.as_tensor(np.asarray(const).astype(np.complex64), device=z.device)
    cr, ci, c2 = c.real, c.imag, c.real ** 2 + c.imag ** 2
    return torch.cat([torch.argmax(2 * (zc.real[:, None] * cr + zc.imag[:, None] * ci) - c2, dim=-1)
                      for zc in z.split(chunk)])


def decide(z, const):
    """The decided constellation point of every element of ``z``, as complex.

    On a square grid the nearest level per axis (round half to even,
    clamped), as the bench decides; on any other alphabet the nearest point.
    """
    if detect_square_grid(np.asarray(const)) is None:
        c = torch.as_tensor(np.asarray(const).astype(np.complex64), device=z.device)
        return c[nearest_idx(z.reshape(-1), const)].reshape(z.shape)
    levels = np.unique(np.asarray(const).real)
    d0, lo, n = float(levels[1] - levels[0]), float(levels[0]), int(levels.size)

    def q(x):
        return lo + d0 * torch.clamp(torch.round((x - lo) / d0), 0, n - 1)
    return torch.complex(q(z.real), q(z.imag))


def shared_decisions(a, b, const):
    """Share of the decisions of ``a`` and ``b`` (nmodes, L) that agree, per mode at its best turn.

    Mode m of ``b`` is turned by the multiple of pi/2 that agrees best with
    mode m of ``a``; the shares are averaged over the modes. A blind
    receiver has no absolute phase: in the per-sample modes the phase step
    from the search's zero-filled edge into its first estimate can land on
    exactly pi/4, where the unwrap's count depends on the last ulp, and two
    correct receivers then differ by a quarter turn for the rest of the row.
    The gate minimises over quarter turns; so does this.
    """
    da = decide(a, const)
    best = []
    for m in range(a.shape[0]):
        best.append(max(float((da[m] == decide(b[m] * (1j ** r), const)).double().mean())
                        for r in range(4)))
    return float(np.mean(best))


def ser_gate(out, ref, const):
    """Symbol error rate of the recovered symbols, as the reference's benches gate it.

    out: (nmodes, Lout) complex recovered symbols; ref: (nref, Nsym) complex
    transmitted symbols on the same device; const: the host constellation.
    After a 200-sample trim at both ends, each output mode is compared
    against every transmitted mode at delays 3-5 (the taps-centre offset)
    under each pi/2 rotation.

    On a square grid (bench.py:127-154) the output is decided on the
    constellation's levels, a symbol is wrong when the decision lies more
    than d0/4 from the reference, each mode keeps its best pairing, and the
    result is the mean over modes. On any other alphabet there are no
    per-axis levels (tools/qam32_bench.py:54-98, tools/genbench.py:132-165):
    output and reference are both decided to the nearest point, a symbol is
    wrong when the indices differ, and the pairing of outputs with
    transmitted modes is restricted to permutations, so that a chain that
    emits one polarisation twice cannot pass.
    """
    o = out[:, GATE_TRIM:-GATE_TRIM]
    L = o.shape[1]
    if detect_square_grid(np.asarray(const)) is None:
        ridx = {(rm, off): nearest_idx(ref[rm, GATE_TRIM + off: GATE_TRIM + off + L], const)
                for rm in range(ref.shape[0]) for off in (3, 4, 5)}
        ser_mr = []
        for m in range(o.shape[0]):
            decs = [nearest_idx(o[m] * (1j ** rot), const) for rot in range(4)]
            ser_mr.append([min(float((dec != ridx[rm, off]).double().mean())
                               for off in (3, 4, 5) for dec in decs)
                           for rm in range(ref.shape[0])])
        return min(float(np.mean([ser_mr[m][perm[m]] for m in range(o.shape[0])]))
                   for perm in itertools.permutations(range(ref.shape[0]), o.shape[0]))
    levels = np.unique(np.asarray(const).real)
    d0 = float(levels[1] - levels[0])
    sers = []
    for m in range(o.shape[0]):
        decs = [decide(o[m] * (1j ** rot), const) for rot in range(4)]
        cand = [torch.mean((torch.abs(dec - ref[rm, GATE_TRIM + off: GATE_TRIM + off + L])
                            > d0 / 4).to(torch.float32))
                for rm in range(ref.shape[0]) for off in (3, 4, 5) for dec in decs]
        sers.append(torch.min(torch.stack(cand)))
    return float(torch.mean(torch.stack(sers)))


class PilotTx(NamedTuple):
    """A pilot capture and what the receiver and the gate need to know of it."""
    planes: torch.Tensor      # (2*nmodes, L) float32 [Re; Im] capture at 2 samples/symbol
    pilot_seq: np.ndarray     # (nmodes, seq_len) complex64 pilot sequence
    ph_pilots: np.ndarray     # (nmodes, nblk) complex64 phase pilots
    idx_tx: torch.Tensor      # (nmodes, payload symbols per frame) int64 coded indices
    bits: np.ndarray          # (M, log2 M) bool bits of each coded index
    coded: np.ndarray         # (M,) complex64 constellation by coded index


def make_pilot_tx(nframes, M=64, frame_len=2 ** 16, seq_len=1024, ins_rat=32, snr=35,
                  lwdth=20e3, dgd=20e-12, theta=np.pi / 4.3, seed=3, fb=24e9, freq_off=None,
                  device=None):
    """The pilot capture of ``bench.pilot_maketx`` (its 'qam' branch), made in torch on ``device``.

    Per mode one frame of ``SignalWithPilots(M, frame_len, seq_len,
    ins_rat)``: a QPSK Gray-coded pilot sequence and phase pilots, M-QAM
    Gray-coded payload, tiled ``nframes`` times; then 2x root-raised-cosine
    shaping at beta 0.1 as in :func:`make_tx`, a roll by the frame's pilot
    count (``roll_frame_sync``), Wiener phase noise of linewidth ``lwdth``,
    a carrier frequency offset of ``freq_off`` Hz (None: none; the
    reference's ``simulate_transmission(freq_off=)``, whose pilot chain
    takes it out with ``foe_comp=True``), the SNR and first-order PMD, in
    the reference's order. All draws come
    from one ``torch.Generator`` seeded with ``seed`` on ``device`` (None:
    the card; ``"cpu"`` for the CPU); the capture is not the JAX package's
    array but one of the same statistics.
    """
    nmodes, os = 2, 2
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    _, idx_dat, idx_pil = cal_pilot_idx(frame_len, seq_len, ins_rat)
    npil, ndat = int(idx_pil.sum()), int(idx_dat.sum())
    coded_p, _, _ = generate_mapping(4, np.sqrt(cal_scaling_factor_qam(4)))
    coded, _, bits = generate_mapping(M, np.sqrt(cal_scaling_factor_qam(M)))
    pil = torch.as_tensor(coded_p, device=dev)[
        torch.randint(0, 4, (nmodes, npil), generator=g, device=dev)]
    idx_tx = torch.randint(0, M, (nmodes, ndat), generator=g, device=dev)
    frame = torch.empty((nmodes, frame_len), dtype=torch.complex64, device=dev)
    frame[:, torch.as_tensor(np.nonzero(idx_pil)[0], device=dev)] = pil
    frame[:, torch.as_tensor(np.nonzero(idx_dat)[0], device=dev)] = \
        torch.as_tensor(coded, device=dev)[idx_tx]
    N = frame_len * int(nframes)
    up = torch.zeros((nmodes, N * os), dtype=torch.complex64, device=dev)
    up[:, ::os] = frame.repeat(1, int(nframes))
    del frame
    h = torch.as_tensor(rrc_response(N * os, os, fb).astype(np.float32), device=dev)
    sig = torch.fft.ifft(torch.fft.fft(up, dim=-1) * h, dim=-1)
    del up, h
    sig = sig / torch.sqrt(torch.mean(sig.abs() ** 2, dim=-1, keepdim=True))
    sig = impairments.roll_frame_sync(sig, npil)
    sig = impairments.simulate_transmission(sig, fb, os * fb, g, snr=snr, freq_off=freq_off,
                                            lwdth=lwdth, dgd=dgd, theta=theta)
    planes = torch.cat([sig.real, sig.imag]).contiguous()
    pil_h = pil.cpu().numpy()
    return PilotTx(planes, pil_h[:, :seq_len], pil_h[:, seq_len:], idx_tx, bits, coded)


def ber_gate(dr, di, tx, sync_corr, chunk=2 ** 22):
    """The pilot bench's gate (bench.py:459-497) on a dispatch's payload planes.

    dr/di: (nmodes, nframes * payload symbols) float32 from the pilot
    chain; tx: the :class:`PilotTx` of the capture. Each symbol is decided
    to the nearest coded symbol (:func:`decision_idx`) and compared with
    the transmitted index of its frame position; bit errors come from the
    (M, M) Hamming-distance table of the coded indices' bits. Decides in
    chunks of about ``chunk`` symbols. Returns a dict of ``ber``, ``ser``,
    ``sync_corr`` and ``ok`` (BER <= 1e-5 and sync_corr >= 120).
    """
    dev = dr.device
    coded = torch.as_tensor(tx.coded, device=dev)
    ham = torch.as_tensor((tx.bits[:, None, :] != tx.bits[None, :, :]).sum(-1), device=dev)
    nmodes, nd = tx.idx_tx.shape
    nf = dr.shape[-1] // nd
    step = max(1, chunk // nd)
    bit_err = sym_err = 0
    for m in range(nmodes):
        for f0 in range(0, nf, step):
            sl = slice(f0 * nd, min(nf, f0 + step) * nd)
            rx = decision_idx(torch.complex(dr[m, sl], di[m, sl]), coded).reshape(-1, nd).long()
            it = tx.idx_tx[m].expand_as(rx)
            bit_err += int(ham[rx, it].sum())
            sym_err += int((rx != it).sum())
    nsym = nmodes * nf * nd
    ber = bit_err / (nsym * tx.bits.shape[1])
    corr = float(sync_corr)
    return {"ber": ber, "ser": sym_err / nsym, "sync_corr": corr,
            "ok": ber <= BER_LIMIT and corr >= SYNC_CORR_MIN}
