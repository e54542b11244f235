"""Plain reference of the pilot-aided receiver, in float32 torch with TF32 off.

The same semantics as the program's ``PilotRxChain`` with the LS trainer, the
blocked pilot layout and no phase trace, written from QAMpy's pilot receiver
and imported from nowhere in the program:

- frame sync: each of the W candidate windows (two pilot-sequence lengths,
  stepped by half of one) takes a short blind CMA training; per output mode the
  window of the least error variance wins; its taps filter a two-window segment,
  whose fourth power gives a coarse frequency offset; the cross-correlation of
  the segment, raw and derotated by that offset, with every pilot sequence
  gives each output mode's delay and, by a greedy assignment of the strongest
  peaks, the mode order and the frame shift;
- training: per output mode the Tikhonov-regularised least-squares taps that map
  the pilot segment onto the pilot sequence;
- frame body: each frame of each output mode filtered from its shifted window;
  the phase pilots' angles against the known pilots, unwrapped, averaged over
  ``cpe_avg`` pilots and interpolated linearly between pilots (held at both
  ends); the frame derotated by that phase; the pilots dropped.

``body`` takes a ``dtype``: float32 is the reference; bfloat16 computes every
product and sum of the frame body in bfloat16, the control that a lower
precision must fail.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.gen.pilot_tx import pilot_layout
from benchmark.reference.blind import cma_error, train

TWO_PI = float(np.float32(2 * np.pi))
INV_TWO_PI = float(np.float32(1 / (2 * np.pi)))
FOE_FFT = 2 ** 16


def geometry(chain, frame_len, seq_len, ins_rat):
    """The receiver's sizes, as QAMpy's pilot receiver derives them."""
    os, n = chain["os"], chain["nmodes"]
    sw = seq_len * os
    step = sw // 2
    sync_ntaps, ntaps = chain["sync_Ntaps"], chain["Ntaps"]
    ls = (2 * sw - sync_ntaps) // os + 1
    seg_len = seq_len * os + ntaps - 1
    _, pil = pilot_layout(frame_len, seq_len, ins_rat)
    nph = int(pil.sum()) - seq_len
    avg = chain["cpe_avg"] + (1 - chain["cpe_avg"] % 2)
    x0 = seq_len + ins_rat * ((avg - 1) // 2)
    return dict(
        os=os, n=n, F=frame_len, seq_len=seq_len, R=ins_rat, sw=sw, step=step,
        starts=np.arange(2, frame_len * os // step + 1) * step,
        sync_ntaps=sync_ntaps, trs_sync=int(sw // os // sync_ntaps - 1) * sync_ntaps,
        ls=ls, nxc=seq_len + ls - 1, nfft=int(2 ** np.ceil(np.log2(seq_len + ls - 1))),
        ntaps=ntaps, seg_len=seg_len, trs_eq=int(seg_len // os // ntaps - 1) * ntaps,
        tap_corr=(ntaps - sync_ntaps) // 2, nph=nph, avg=avg, npts=nph - (avg - 1),
        x0=x0, fr_len=frame_len * os + ntaps - 1)


def fir(P, w, os, L):
    """out[j, l] = sum_{m,t} E[m, l*os + t] w[j, m, t] for l < L, on (..., 2n, S) planes."""
    nout, nm, ntaps = w.shape
    wr, wi = w.real, w.imag
    outr = torch.zeros((*P.shape[:-2], nout, L), dtype=P.dtype, device=P.device)
    outi = torch.zeros_like(outr)
    for t in range(ntaps):
        xr = P[..., :nm, t: t + (L - 1) * os + 1: os]
        xi = P[..., nm:, t: t + (L - 1) * os + 1: os]
        for j in range(nout):
            for m in range(nm):
                outr[..., j, :] += xr[..., m, :] * wr[j, m, t] - xi[..., m, :] * wi[j, m, t]
                outi[..., j, :] += xr[..., m, :] * wi[j, m, t] + xi[..., m, :] * wr[j, m, t]
    return outr, outi


def frame_sync(P, chain, pilot_seq, g):
    """(mode_order (n,), shift (n,) in samples, sync_corr): QAMpy's frame search."""
    n, step, sw, os, W = g["n"], g["step"], g["sw"], g["os"], len(g["starts"])
    dev = P.device
    blk = P[:, 2 * step:(W + 3) * step].reshape(2 * n, W + 1, step)
    win = torch.cat([blk[:, :W], blk[:, 1:]], dim=-1).transpose(0, 1)          # (W, 2n, sw)
    w0 = torch.zeros((n, n, g["sync_ntaps"]), dtype=torch.complex64, device=dev)
    for i in range(n):
        w0[i, i, g["sync_ntaps"] // 2] = 1
    taps, err = train(win, w0, cma_error(1.0), g["trs_sync"], os, chain["sync_mu"],
                      chain["block_size"], niter=chain["sync_Niter"])
    evar = (err - err.mean(dim=-1, keepdim=True)).abs().pow(2).mean(dim=-1)       # (W, n)
    best = torch.argmin(evar, dim=0).tolist()
    seq = torch.as_tensor(np.asarray(pilot_seq, dtype=np.complex64), device=dev)
    seq_f = torch.fft.fft(seq, g["nfft"], dim=-1)
    fvec = torch.as_tensor((np.fft.fftfreq(FOE_FFT) / 4).astype(np.float32), device=dev)
    t = torch.arange(1, g["ls"] + 1, dtype=torch.float32, device=dev)
    rows = []
    for l in range(n):
        s0 = int(np.clip(g["starts"][best[l]] - sw, 0, P.shape[-1] - 2 * sw))
        yr, yi = fir(P[:, s0:s0 + 2 * sw], taps[best[l]], os, g["ls"])
        sy = torch.complex(yr, yi)
        f4 = torch.fft.fft((sy * sy) ** 2, FOE_FFT, dim=-1).abs().pow(2)
        foe = fvec[torch.argmax(f4, dim=-1)].mean()
        ang = (2 * np.pi * foe) * t
        sy2 = torch.stack([sy[l], sy[l] * torch.complex(torch.cos(ang), -torch.sin(ang))])
        Y = torch.fft.fft(torch.conj(sy2).flip(-1), g["nfft"], dim=-1)
        ac = torch.fft.ifft(seq_f[None] * Y[:, None], dim=-1)[..., :g["nxc"]]      # (2, n, nxc)
        peak = torch.maximum(ac.real.abs(), ac.imag.abs()).amax(dim=-1)
        delay = (g["ls"] - 1) - torch.argmax(ac.abs(), dim=-1)
        rows.append((peak.cpu(), delay.cpu()))
    found, order, shifts, peaks = set(), [], [], []
    for l, (peak, delay) in enumerate(rows):
        best_p = peak.amax(dim=0)
        p = max((q for q in range(n) if q not in found), key=lambda q: (float(best_p[q]), -q))
        found.add(p)
        h = int(torch.argmax(peak[:, p]))
        order.append(p)
        peaks.append(float(best_p[p]))
        shifts.append(int(g["starts"][best[l]]) - sw + os * int(delay[h, p]))
    shift = [shifts[k] for k in order]
    shift = [s + g["F"] * os if s < 0 else s for s in shift]
    return order, shift, min(peaks)


def ls_taps(P, shift, order, pilot_seq, g):
    """Per output mode the regularised least-squares taps on its pilot segment: (n, n, Ntaps)."""
    n, nt, K, os = g["n"], g["ntaps"], g["trs_eq"], g["os"]
    Pn, dev = n * nt, P.device
    taps = []
    for i in range(n):
        eqsh = shift[i] - g["tap_corr"]
        eqsh = eqsh + g["F"] * os if eqsh < 0 else eqsh
        st = int(np.clip(eqsh, 0, P.shape[-1] - g["seg_len"]))
        seg = P[:, st:st + g["seg_len"]]
        seg = seg[[*order, *(o + n for o in order)]]                            # mode-ordered rows
        U = seg.unfold(-1, nt, os)[:, :K]                                       # (2n, K, nt)
        Xr = U[:n].permute(1, 0, 2).reshape(K, Pn)
        Xi = U[n:].permute(1, 0, 2).reshape(K, Pn)
        S = Xr.T @ Xr + Xi.T @ Xi
        T = Xr.T @ Xi - Xi.T @ Xr
        S = S + (1e-4 * S.diagonal().sum() / Pn) * torch.eye(Pn, device=dev)
        A = torch.cat([torch.cat([S, -T], dim=-1), torch.cat([T, S], dim=-1)], dim=-2)
        dr = torch.as_tensor(np.asarray(pilot_seq[i, :K].real, np.float32), device=dev)[:, None]
        di = torch.as_tensor(np.asarray(pilot_seq[i, :K].imag, np.float32), device=dev)[:, None]
        b = torch.cat([Xr.T @ dr + Xi.T @ di, Xr.T @ di - Xi.T @ dr], dim=-2)
        s = torch.linalg.solve(A, b)[:, 0]
        taps.append(torch.complex(s[:Pn], s[Pn:]).reshape(n, nt))
    return torch.stack(taps)


def prefix(P, chain, pilot_seq, g):
    """(taps over the mode-ordered inputs, shift, mode order, sync_corr) of a capture."""
    order, shift, corr = frame_sync(P, chain, pilot_seq, g)
    return ls_taps(P, shift, order, pilot_seq, g), shift, order, corr


def body(P, taps, shift, order, ph_pilots, frames, g, dtype=torch.float32, chunk=16):
    """The payload (n, frames * payload symbols) complex64 of a capture with the given state."""
    n, F, os, R, seq_len = g["n"], g["F"], g["os"], g["R"], g["seq_len"]
    dev = P.device
    inv = np.argsort(order)
    ph = torch.as_tensor(np.asarray(ph_pilots)[:, :g["nph"]], device=dev)
    pr, pi = ph.real.to(dtype), ph.imag.to(dtype)
    dx, avg, npts, x0 = R, g["avg"], g["npts"], g["x0"]
    k = torch.arange(F, device=dev)
    cut = torch.clamp((k - x0) // dx, -1, npts - 1)          # pilot interval of each symbol
    frac = ((k - x0) % dx).to(dtype) / dx
    keep = torch.as_tensor(np.nonzero(pilot_layout(F, seq_len, R)[0])[0], device=dev)
    out = []
    for i in range(n):
        eqsh = shift[i] - g["tap_corr"]
        eqsh = eqsh + F * os if eqsh < 0 else eqsh
        rows = []
        for c0 in range(0, len(frames), chunk):
            fs = frames[c0:c0 + chunk]
            offs = [int(np.clip(eqsh + f * F * os, 0, P.shape[-1] - g["fr_len"])) for f in fs]
            seg = torch.stack([P[:, o:o + g["fr_len"]] for o in offs]).to(dtype)   # (nf, 2n, fr)
            yr, yi = fir(seg, _Taps(taps[i:i + 1, inv], dtype), os, F)
            yr, yi = yr[:, 0], yi[:, 0]                                          # (nf, F)
            zr, zi = yr[:, seq_len::R][:, :g["nph"]], yi[:, seq_len::R][:, :g["nph"]]
            a = torch.atan2(pr[i] * zi - pi[i] * zr, pr[i] * zr + pi[i] * zi)
            jumps = torch.floor((a[:, 1:] - a[:, :-1]) * INV_TWO_PI + 0.5)
            u = a - TWO_PI * torch.nn.functional.pad(torch.cumsum(jumps.float(), -1), (1, 0)).to(dtype)
            pav = u[:, avg - 1: avg - 1 + npts]
            for q in range(1, avg):
                pav = pav + u[:, avg - 1 - q: avg - 1 - q + npts]
            pav = pav / avg
            lo = pav[:, cut.clamp(0, npts - 1)]
            hi = pav[:, (cut + 1).clamp(0, npts - 1)]
            inner = (cut >= 0) & (cut < npts - 1)
            phs = torch.where(inner, lo + (hi - lo) * frac, torch.where(cut < 0, pav[:, :1],
                                                                       pav[:, -1:]))
            c, s = torch.cos(phs), torch.sin(phs)
            dr, di = yr * c + yi * s, yi * c - yr * s
            rows.append(torch.complex(dr.float(), di.float())[:, keep])
            del seg, yr, yi
        out.append(torch.cat(rows).reshape(-1))
    return torch.stack(out)


class _Taps:
    """Complex taps as (real, imag) in ``dtype``: bfloat16 has no complex type."""

    def __init__(self, w, dtype):
        self.real, self.imag, self.shape = w.real.to(dtype), w.imag.to(dtype), w.shape
