"""The benchmark workloads without JAX (counterpart of four pieces of ``bench.py``).

Blind receiver: ``make_tx`` synthesises the dual-pol capture host-side in
numpy (bench.py:24-87); ``ser_gate`` is the bench's correctness gate in
torch (bench.py:127-154). Pilot receiver: ``make_pilot_tx`` states the
pilot capture of ``bench.pilot_maketx`` (bench.py:318-397) in torch on any
device; ``ber_gate`` is the bench's BER gate (bench.py:459-497).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qampy_tpu_torch.core import impairments
from qampy_tpu_torch.core.metrics import decision_idx
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


def make_tx(Nsym=2 ** 20, M=64, fb=25e9, seed=1, snr=35):
    """Host-side TX synthesis: dual-pol M-QAM, RRC 2x oversampling, phase noise, AWGN, PMD.

    Same array as ``bench.make_tx`` for the same arguments (its shaped and
    custom-alphabet options are not ported). Returns (capture (2, 2*Nsym)
    complex64, transmitted symbols (2, Nsym) complex64, constellation).
    """
    rng = np.random.default_rng(seed)
    const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
    coded = const
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


def decide(z, const):
    """Nearest constellation level per axis (round half to even, clamped), as complex."""
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
    """Symbol error rate of the recovered symbols, as the bench gates it.

    out: (nmodes, Lout) complex recovered symbols; ref: (nref, Nsym) complex
    transmitted symbols on the same device; const: the host constellation.
    After a 200-sample trim at both ends, each output mode is decided on the
    constellation's levels and compared against every transmitted mode at
    delays 3-5 (the taps-centre offset) under each pi/2 rotation; a symbol
    is wrong when the decision lies more than d0/4 from the reference. Each
    mode keeps its best pairing; the result is the mean over modes.
    """
    levels = np.unique(np.asarray(const).real)
    d0 = float(levels[1] - levels[0])
    o = out[:, GATE_TRIM:-GATE_TRIM]
    L = o.shape[1]
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
                  lwdth=20e3, dgd=20e-12, theta=np.pi / 4.3, seed=3, fb=24e9, device=None):
    """The pilot capture of ``bench.pilot_maketx`` (its 'qam' branch), made in torch on ``device``.

    Per mode one frame of ``SignalWithPilots(M, frame_len, seq_len,
    ins_rat)``: a QPSK Gray-coded pilot sequence and phase pilots, M-QAM
    Gray-coded payload, tiled ``nframes`` times; then 2x root-raised-cosine
    shaping at beta 0.1 as in :func:`make_tx`, a roll by the frame's pilot
    count (``roll_frame_sync``), Wiener phase noise of linewidth ``lwdth``,
    the SNR and first-order PMD, in the reference's order. All draws come
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
    sig = impairments.simulate_transmission(sig, fb, os * fb, g, snr=snr, lwdth=lwdth,
                                            dgd=dgd, theta=theta)
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
