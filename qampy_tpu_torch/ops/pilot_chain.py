"""The pilot-aided serving chain (counterpart of ``qampy_tpu/ops/pilot_chain.py``).

``make_pilot_rx_chain`` returns a :class:`PilotRxChain` module that runs the
reference's pilot receiver on float32 planes in one dispatch:

1. frame sync: the W candidate windows of the search each take a short
   blind CMA training, all as one batch of the plain block trainer (the
   reference vmaps its XLA trainer); the window with the least error
   variance wins for each output mode;
2. alignment: that window's taps filter a two-window segment, a 2^16-point
   fourth-power FOE derotates a second copy, and one batched FFT
   cross-correlation of both against every pilot sequence feeds the greedy
   mode assignment, which gives the frame shifts and the mode order;
3. pilot equalisation in closed form (``eq_trainer="ls"``): one Gram
   product and one 180 x 180 real block solve per output mode;
4. the frame body, batched over all frames: the frame filter (kernel B2,
   frame entry, which also gathers the CPE pilots into contiguous rows),
   the pilot phase coefficients (kernel B5, from those rows) and the
   piecewise-linear derotation (kernel B4); with ``return_phase=True`` the
   phase trace is built in plain torch and kernel B6 derotates;
5. the payload: pilots dropped, frames concatenated per mode.

The reference scans its frame body over the frames; here each kernel
launches once per dispatch with (mode, frame) rows, and no value reaches
the host between the capture and the payload: shifts, window offsets and
the mode order stay on the device. Steps 1-3 are plain PyTorch, as the
reference leaves them to XLA. On CPU tensors the kernels run their plain
versions; on CUDA tensors the kernels run, with no fallback.

Only the reference's serving configuration is ported: the LS trainer, the
fast frame body and the blocked pilot layout. The LMS trainer, FOE
compensation, the non-blocked CPE layout and the XLA frame body raise
``NotImplementedError`` (ROADMAP A6b), as does the mesh-sharded prefix
(A10); frame modes other than the batched one and frame packing are not to
be ported and raise ``ValueError``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops.equaliser_cuda import apply_filter_frames
from qampy_tpu_torch.ops.phase_cuda import (check_cpe_plan, cpe_coeffs, interp_rotate,
                                            moving_average, rotate)
from qampy_tpu_torch.signals import cal_pilot_idx
from qampy_tpu_torch.utils import resolve_device

__all__ = ["PilotRxChain", "make_pilot_rx_chain", "unwrap"]

FOE_FFT = 2 ** 16
_PERIOD = float(np.float32(2 * np.pi))   # jnp.unwrap promotes its period to float32
_INTERVAL = _PERIOD / 2                  # exact: halving a float32


def unwrap(p, dim=-1):
    """``jnp.unwrap(p, axis=dim)`` for float32 phases (period 2*pi).

    A step d is corrected by ((d + pi) mod 2*pi) - pi - d unless |d| < pi,
    with the mod taken with the divisor's sign as ``jnp.remainder`` does. A
    step of exactly +pi keeps +pi and one of exactly -pi keeps -pi (the
    reference's tie rule), so neither is corrected.
    """
    dd = torch.diff(p, dim=dim)
    r = torch.fmod(dd + _INTERVAL, _PERIOD)
    ddmod = torch.where(r < 0, r + _PERIOD, r) - _INTERVAL
    ddmod = torch.where((ddmod == -_INTERVAL) & (dd > 0), _INTERVAL, ddmod)
    corr = torch.where(dd.abs() < _INTERVAL, 0.0, ddmod - dd)
    n = p.shape[dim]
    return torch.cat([p.narrow(dim, 0, 1),
                      p.narrow(dim, 1, n - 1) + torch.cumsum(corr, dim=dim)], dim=dim)


def _take(x, i, dim=0):
    """x.select(dim, i) for a 0-dim index tensor on the device, without a host sync."""
    return x.index_select(dim, i.reshape(1)).squeeze(dim)


class PilotRxChain(nn.Module):
    """Pilot-aided dual-pol receiver over a dispatch of frames.

    Build it with :func:`make_pilot_rx_chain`. Entries, as in the
    reference: ``forward(E)`` (complex capture in, complex payload out),
    ``planes(pr, pi)`` (float32 planes in, a (dr, di) payload pair out),
    and the warm-start ``tracking``/``tracking_planes``, which demodulate
    with the taps, shifts and mode order of an earlier dispatch and skip
    frame sync and training. Every entry also returns ``info``: ``shift``,
    ``sync_corr``, ``foe``, ``foe_pil``, ``taps``, ``mode_order`` and, with
    ``return_phase``, ``phase``.
    """

    def __init__(self, pilot_seq, ph_pilots, frame_len, pilot_ins_rat, os=2, nmodes=2,
                 M_pilot=4, sync_Ntaps=17, sync_mu=1e-3, sync_Niter=10, Ntaps=45,
                 foe_comp=False, cpe_avg=3, cpe_pilot_rat=1, frames=(0,), block_size=128,
                 pallas=None, frames_mode="scan", return_phase=True, eq_trainer="lms",
                 frames_pack=1):
        super().__init__()
        if eq_trainer not in ("lms", "ls"):
            raise ValueError("eq_trainer must be 'lms' or 'ls', got %r" % (eq_trainer,))
        if eq_trainer == "lms":
            raise NotImplementedError("the LMS pilot trainer (eq_trainer='lms') is ROADMAP "
                                      "item A6b; the port runs eq_trainer='ls'")
        if foe_comp:
            raise NotImplementedError("foe_comp=True (pilot frequency-offset compensation) "
                                      "is ROADMAP item A6b")
        if pallas is False:
            raise NotImplementedError("the XLA frame body (pallas=False, the reference's "
                                      "do_frame) is ROADMAP item A6b")
        if frames_mode != "scan":
            raise ValueError("frames_mode=%r is not ported (ROADMAP: not to port); the port "
                             "batches the frames of the default 'scan'" % (frames_mode,))
        if int(frames_pack) != 1:
            raise ValueError("frames_pack=%r is not ported (ROADMAP: not to port)"
                             % (frames_pack,))
        dtype = np.complex64
        pilot_seq = np.asarray(pilot_seq).astype(dtype)
        ph_pilots = np.asarray(ph_pilots).astype(dtype)
        self.nmodes = n = int(nmodes)
        if pilot_seq.shape[0] != n or ph_pilots.shape[0] != n:
            raise ValueError("pilots for %d modes, the chain has %d"
                             % (pilot_seq.shape[0], n))
        self.seq_len = seq_len = pilot_seq.shape[-1]
        self.frame_len = F = int(frame_len)
        self.os = os = int(os)
        self.ins_rat = R = int(pilot_ins_rat)
        self.Ntaps, self.return_phase = int(Ntaps), bool(return_phase)

        # frame search geometry (reference :112-127)
        self.sw = sw = seq_len * os
        self.step = sw // 2
        starts = np.arange(2, F * os // self.step + 1) * self.step
        self.W = starts.shape[0]
        self.sync_mu, self.sync_Niter = float(sync_mu), int(sync_Niter)
        self.block_size = int(block_size)
        self.TrS_sync = eqops._cal_training_symbol_len(os, sync_Ntaps, sw)
        self.spec_sync = eqops.err_spec(
            "cma", eqops._reshape_symbols(None, "cma", M_pilot, dtype, n))
        self.Ls = (2 * sw - sync_Ntaps) // os + 1
        self.nxc = seq_len + self.Ls - 1
        self.nfft = int(2 ** np.ceil(np.log2(self.nxc)))

        # pilot equaliser geometry (reference :129-137)
        self.seg_len = seq_len * os + Ntaps - 1
        self.TrS_eq = eqops._cal_training_symbol_len(os, Ntaps, self.seg_len)
        if (Ntaps - sync_Ntaps) % os != 0:
            raise ValueError("Taps for search and convergence improperly configured")
        self.tap_corr = (Ntaps - sync_Ntaps) // 2

        # CPE geometry (reference :139-167)
        _, idx_dat, idx_pil = cal_pilot_idx(F, seq_len, R)
        ph_idx = np.nonzero(idx_pil)[0][seq_len:][::cpe_pilot_rat]
        pil_cpe = ph_pilots[:, ::cpe_pilot_rat][:, :ph_idx.shape[0]]
        if cpe_avg % 2 == 0:
            cpe_avg += 1
        self.cpe_avg = cpe_avg
        i_adj = (cpe_avg - 1) // 2
        idx_avg = ph_idx[i_adj:ph_idx.shape[0] - i_adj]
        self.cpe_dx = dx = R * int(cpe_pilot_rat)
        if not np.all(np.diff(idx_avg) == dx):
            raise ValueError("non-uniform pilot spacing")
        self.cpe_x0 = int(idx_avg[0])
        self.nblk = nblk = (F - seq_len) // R
        blocked = (cpe_pilot_rat == 1 and (F - seq_len) % R == 0 and np.array_equal(
            np.nonzero(idx_dat)[0],
            (seq_len + np.arange(nblk)[:, None] * R + np.arange(1, R)[None, :]).reshape(-1)))
        if not blocked:
            raise NotImplementedError("the non-blocked pilot CPE layout (cpe_pilot_rat != 1 or "
                                      "payload not in whole pilot blocks) is ROADMAP item A6b")
        # return_phase=False: the interpolation fuses into the derotation as
        # per-block (a, b) coefficients (kernels B5 and B4)
        self.kernel_interp = (not self.return_phase and self.cpe_x0 % dx == 0
                              and F % dx == 0)
        self.n_head = self.cpe_x0 // dx
        self.npts = nblk - (cpe_avg - 1)
        self.nbt = F // dx
        self.fr_len = F * os + Ntaps - 1

        seq_f = np.fft.fft(pilot_seq, self.nfft, axis=-1).astype(dtype)
        self.register_buffer("starts", torch.as_tensor(starts, dtype=torch.int64))
        self.register_buffer("w0_sync", torch.as_tensor(
            eqops._init_taps(sync_Ntaps, n, n, dtype)))
        self.register_buffer("seq_f", torch.as_tensor(seq_f))
        self.register_buffer("seq_r", torch.as_tensor(pilot_seq.real.copy()))
        self.register_buffer("seq_i", torch.as_tensor(pilot_seq.imag.copy()))
        self.register_buffer("pil_r", torch.as_tensor(np.ascontiguousarray(pil_cpe.real)))
        self.register_buffer("pil_i", torch.as_tensor(np.ascontiguousarray(pil_cpe.imag)))
        self.register_buffer("fvec", torch.as_tensor(
            (np.fft.fftfreq(FOE_FFT) / 4).astype(np.float32)))
        self.register_buffer("t_foe", torch.arange(1, self.Ls + 1, dtype=torch.float32))
        self.register_buffer("wgt", torch.arange(dx, dtype=torch.float32) / dx)
        self.register_buffer("bases", torch.as_tensor([int(f) * F * os for f in frames],
                                                      dtype=torch.int64))

    # -- cold-start prefix ----------------------------------------------------

    def sync_search(self, P):
        """Frame search (reference :240-262, 341-344): (taps (W, n, n, t), best window (n,)).

        Window w covers [(2+w)*step, (4+w)*step): two shifted views of one
        contiguous slice, trained as one batch of the plain block trainer.
        """
        n, W, step = self.nmodes, self.W, self.step
        blk = P[:, 2 * step:(W + 3) * step].reshape(2 * n, W + 1, step)
        win = torch.cat([blk[:, :W], blk[:, 1:]], dim=-1).transpose(0, 1)   # (W, 2n, sw)
        err, wxs, _ = eqops.train_block_planes(
            win, self.TrS_sync, self.sync_Niter, self.os, self.sync_mu, self.w0_sync,
            self.spec_sync, adaptive=True, block_size=self.block_size)
        evars = (err - err.mean(dim=-1, keepdim=True)).abs().pow(2).mean(dim=-1)   # (W, n)
        return wxs, torch.argmin(evars, dim=0)

    def _align_heavy(self, P, wxs, iw, l):
        """Alignment inputs of output mode ``l`` from window ``iw`` (reference :264-288).

        Returns (acm2 (2, n) correlation peaks, delays2 (2, n), foe_l) for the
        raw and the FOE-derotated hypothesis.
        """
        n, sw = self.nmodes, self.sw
        seg0 = (_take(self.starts, iw) - sw).clamp(0, P.shape[-1] - 2 * sw)
        seg = P[:, seg0 + torch.arange(2 * sw, device=P.device)]
        syp = eqops.apply_filter_planes(seg, self.os, _take(wxs, iw))   # (2n, Ls)
        sy = torch.complex(syp[:n], syp[n:])
        s2 = sy * sy
        f4 = torch.fft.fft(s2 * s2, FOE_FFT, dim=-1).abs().pow(2)
        foe_l = self.fvec[torch.argmax(f4, dim=-1)].mean()
        ang = (2 * np.pi * foe_l) * self.t_foe
        sy_l = sy[l]
        sy2 = torch.stack([sy_l, sy_l * torch.complex(torch.cos(ang), -torch.sin(ang))])
        Y = torch.fft.fft(torch.conj(sy2).flip(-1), self.nfft, dim=-1)
        ac = torch.fft.ifft(self.seq_f[None] * Y[:, None], dim=-1)[..., :self.nxc]
        acm2 = torch.maximum(ac.real.abs(), ac.imag.abs()).amax(dim=-1)   # (2, n)
        delays2 = (self.Ls - 1) - torch.argmax(ac.abs(), dim=-1)
        return acm2, delays2, foe_l

    def align(self, P, wxs, best_w):
        """Per-mode alignment and greedy mode assignment (reference :290-314, 358-371).

        Returns (mode_order (n,), shift (n,) in capture samples, wrapped into
        [0, frame_len*os) and ordered by mode_order, sync_corr, foe_coarse).
        """
        n = self.nmodes
        rows = [self._align_heavy(P, wxs, best_w[l], l) for l in range(n)]
        found = torch.zeros(n, dtype=torch.bool, device=P.device)
        lanes = torch.arange(n, device=P.device)
        foe_coarse = torch.zeros((), dtype=torch.float32, device=P.device)
        mode_order, shifts, peaks = [], [], []
        for l, (acm2, delays2, foe_l) in enumerate(rows):
            hyp = torch.argmax(acm2, dim=0)
            masked = torch.where(found, -np.inf, acm2.amax(dim=0))
            p = torch.argmax(masked).reshape(1)
            found = found | (lanes == p)
            hp = hyp.index_select(0, p)
            delay = delays2[hp, p]
            if l == 0:
                foe_coarse = torch.where(hp[0] == 1, foe_l, foe_coarse)
            mode_order.append(p)
            peaks.append(masked.index_select(0, p))
            shifts.append(self.starts.index_select(0, best_w[l].reshape(1)) - self.sw
                          + self.os * delay)
        mode_order = torch.cat(mode_order)
        shift = torch.cat(shifts).index_select(0, mode_order)
        shift = torch.where(shift < 0, shift + self.frame_len * self.os, shift)
        return mode_order, shift, torch.cat(peaks).min(), foe_coarse

    def _eq_shift(self, shift):
        eqsh = shift - self.tap_corr
        return torch.where(eqsh < 0, eqsh + self.frame_len * self.os, eqsh)

    def ls_taps(self, P, eqsh, mode_order):
        """Closed-form data-aided taps, all output modes at once (reference :201-238).

        Output mode i fits w_i = argmin ||X_i w - pilot_seq_i||^2 with
        X_i[k, (p, t)] = E[mode_order[p], eqsh[i] + k*os + t], by the
        Tikhonov-regularised (1e-4 of the mean diagonal) normal equations in
        real block form. Returns (n, n, Ntaps) complex64 taps over the
        mode-ordered inputs.
        """
        n, Nt, K = self.nmodes, self.Ntaps, self.TrS_eq
        Pn = n * Nt
        st = eqsh.clamp(0, P.shape[-1] - self.seg_len)
        seg = P[:, st[:, None] + torch.arange(self.seg_len, device=P.device)]  # (2n, n, seg)

        def windows(x):   # (n_in, n_out, seg) -> (n_out, K, n_in*Ntaps)
            U = x.index_select(0, mode_order).transpose(0, 1).unfold(-1, Nt, self.os)[:, :, :K]
            return U.permute(0, 2, 1, 3).reshape(n, K, Pn)

        Xr, Xi = windows(seg[:n]), windows(seg[n:])
        XrT, XiT = Xr.transpose(-1, -2), Xi.transpose(-1, -2)
        S = XrT @ Xr + XiT @ Xi                       # Re(X^H X)
        T = XrT @ Xi - XiT @ Xr                       # Im(X^H X)
        lam = 1e-4 * S.diagonal(dim1=-2, dim2=-1).sum(-1) / Pn
        S = S + lam[:, None, None] * torch.eye(Pn, device=P.device)
        A = torch.cat([torch.cat([S, -T], dim=-1), torch.cat([T, S], dim=-1)], dim=-2)
        dr, di = self.seq_r[:, :K, None], self.seq_i[:, :K, None]
        b = torch.cat([XrT @ dr + XiT @ di, XrT @ di - XiT @ dr], dim=-2)
        s = torch.linalg.solve_ex(A, b).result[..., 0]
        return torch.complex(s[:, :Pn], s[:, Pn:]).reshape(n, n, Nt)

    # -- frame body -------------------------------------------------------------

    def frame_offsets(self, P, eqsh):
        """(n, nframes) window starts of every output mode's frames in the capture ``P``.

        Clamped into the capture, as the reference's dynamic slices are.
        """
        return (eqsh[:, None] + self.bases[None, :]).clamp(0, P.shape[-1] - self.fr_len)

    def frame_filter(self, P, eqsh, taps):
        """All frames through kernel B2's frame entry: (out, side).

        ``out``: (2, n, nframes, frame_len) planes; ``taps`` act on the
        capture's own mode order. In the serving form (``kernel_interp``)
        ``side`` is the entry's side output, the CPE pilots as (2, n,
        nframes, nblk) planes, which B5 reads; else None.
        """
        offs = self.frame_offsets(P, eqsh)
        if not self.kernel_interp:
            return apply_filter_frames(P, self.os, taps, offs, self.frame_len), None
        return apply_filter_frames(P, self.os, taps, offs, self.frame_len,
                                   (self.seq_len, self.ins_rat, self.nblk))

    def cpe_trace(self, symr, symi):
        """The per-symbol CPE phase of each (mode, frame) row (reference :742-751, 607-620).

        Pilot phases, ``unwrap``, moving average and the uniform-grid linear
        interpolation, clamped at both ends, in plain torch. The average is
        summed directly, as kernel B5 sums it (see ``moving_average``).
        """
        n, dx, npts = self.nmodes, self.cpe_dx, self.npts
        R, seq_len = self.ins_rat, self.seq_len
        zr = symr[:, seq_len::R].reshape(n, -1, self.nblk)
        zi = symi[:, seq_len::R].reshape(n, -1, self.nblk)
        pr, pi = self.pil_r[:, None], self.pil_i[:, None]
        res_ph = unwrap(torch.atan2(pr * zi - pi * zr, pr * zr + pi * zi))
        ph_avg = moving_average(res_ph, self.cpe_avg, npts)           # (n, nf, npts)
        lead = ph_avg.shape[:-1]
        lo, hi = ph_avg[..., :-1, None], ph_avg[..., 1:, None]
        mid = (lo + (hi - lo) * self.wgt).reshape(*lead, (npts - 1) * dx)
        tail = self.frame_len - self.cpe_x0 - (npts - 1) * dx
        trace = torch.cat([ph_avg[..., :1].expand(*lead, self.cpe_x0), mid,
                           ph_avg[..., -1:].expand(*lead, tail)], dim=-1)
        return trace.reshape(symr.shape)

    def cpe_derotate(self, symr, symi, pilots=None):
        """Pilot CPE of (rows, frame_len) planes: ((outr, outi), trace or None).

        Serving form: kernel B5 builds per-block (a, b) coefficients from
        ``pilots``, the (rows, nblk) pilot planes of the frame filter's side
        output, and kernel B4 derotates. With ``return_phase``: the plain
        trace and kernel B6.
        """
        if self.kernel_interp:
            a, b = cpe_coeffs(*pilots, self.pil_r, self.pil_i, 0, 1, self.n_head, self.npts,
                              self.cpe_dx, self.cpe_avg, self.nbt)
            return interp_rotate(symr, symi, a, b, self.cpe_dx, sign=-1), None
        trace = self.cpe_trace(symr, symi)
        return rotate(symr, symi, trace, sign=-1), trace

    def payload(self, outr, outi):
        """Drop the pilots: (dr, di), each (n, nframes * payload symbols per frame)."""
        n, R = self.nmodes, self.ins_rat

        def take(x):
            x = x[:, self.seq_len:].reshape(n, -1, self.nblk, R)[..., 1:]
            return x.reshape(n, -1)
        return take(outr), take(outi)

    def demod(self, P, eqsh, taps):
        """Frame body over every frame of the dispatch: ((dr, di), trace or None)."""
        out, side = self.frame_filter(P, eqsh, taps)
        pil = None if side is None else side.reshape(2, -1, self.nblk).unbind(0)
        rows = out.shape[1] * out.shape[2]
        (outr, outi), trace = self.cpe_derotate(out[0].reshape(rows, self.frame_len),
                                                out[1].reshape(rows, self.frame_len), pil)
        return self.payload(outr, outi), trace

    # -- entries ----------------------------------------------------------------

    def _planes(self, pr, pi):
        if pr.is_complex() or pr.dim() != 2 or pr.shape != pi.shape:
            raise ValueError("expected two float (nmodes, L) planes, got %s %s and %s"
                             % (pr.dtype, tuple(pr.shape), tuple(pi.shape)))
        if pr.shape[0] != self.nmodes:
            raise ValueError("capture of %d modes, the chain has %d"
                             % (pr.shape[0], self.nmodes))
        if pr.shape[-1] < (self.frame_len + 2 * self.seq_len) * self.os:
            raise ValueError("Signal must be at least as long as frame")
        return torch.cat([pr, pi]).to(torch.float32).contiguous()

    def _info(self, shift, sync_corr, foe_coarse, taps, mode_order, trace):
        zero = torch.zeros((), dtype=torch.float32, device=shift.device)
        info = {"shift": shift, "sync_corr": sync_corr, "foe": foe_coarse + zero,
                "foe_pil": zero, "taps": taps, "mode_order": mode_order}
        if self.return_phase:
            info["phase"] = trace.reshape(self.nmodes, -1)
        return info

    def _fwd(self, P):
        wxs, best_w = self.sync_search(P)
        mode_order, shift, sync_corr, foe_coarse = self.align(P, wxs, best_w)
        eqsh = self._eq_shift(shift)
        taps = self.ls_taps(P, eqsh, mode_order)
        # the mode order folds into the taps' input axis (reference :1063-1069)
        data, trace = self.demod(P, eqsh, taps.index_select(1, torch.argsort(mode_order)))
        return data, self._info(shift, sync_corr, foe_coarse, taps, mode_order, trace)

    def planes(self, pr, pi):
        """Full chain on float32 planes pr/pi (n, L): ((dr, di), info)."""
        return self._fwd(self._planes(pr, pi))

    def forward(self, E):
        """Full chain on a complex (n, L) capture: (complex payload, info)."""
        (dr, di), info = self._fwd(self._planes(E.real, E.imag))
        return torch.complex(dr, di), info

    def tracking_planes(self, pr, pi, wxy, shift, mode_order=None, foe=None):
        """Warm-start entry (reference :1021-1074): demodulate with an earlier dispatch's state.

        ``wxy``, ``shift`` and ``mode_order`` are ``info["taps"]``,
        ``info["shift"]`` and ``info["mode_order"]`` of an earlier call;
        frame sync and training are skipped. The mode order folds into the
        taps' input axis: out_i = sum_j taps[i, j] E[mo[j]] = sum_p
        taps[i, inv[p]] E[p], inv = argsort(mo). ``info["sync_corr"]`` is
        +inf to mark that sync did not run. Returns ((dr, di), info).
        """
        if foe is not None:
            raise ValueError("foe= supplied but the chain was built with foe_comp=False "
                             "(it would not be applied)")
        P = self._planes(pr, pi)
        dev = P.device
        shift = torch.as_tensor(shift, device=dev).to(torch.int64)
        wxy = torch.as_tensor(wxy, device=dev)
        if mode_order is None:
            mo, w_eff = torch.arange(self.nmodes, device=dev), wxy
        else:
            mo = torch.as_tensor(mode_order, device=dev).to(torch.int64)
            w_eff = wxy.index_select(1, torch.argsort(mo))
        data, trace = self.demod(P, self._eq_shift(shift), w_eff)
        inf = torch.full((), np.inf, dtype=torch.float32, device=dev)
        return data, self._info(shift, inf, torch.zeros_like(inf), wxy, mo, trace)

    def tracking(self, E, wxy, shift, mode_order=None, foe=None):
        """Complex twin of :meth:`tracking_planes`: (complex payload, info)."""
        (dr, di), info = self.tracking_planes(E.real, E.imag, wxy, shift, mode_order, foe)
        return torch.complex(dr, di), info

    def prefix_sharded(self, *args, **kwargs):
        """The mesh-sharded cold-start prefix of the reference (:513-578)."""
        raise NotImplementedError("the mesh-sharded prefix is ROADMAP item A10")


def make_pilot_rx_chain(pilot_seq, ph_pilots, frame_len, pilot_ins_rat, os=2, nmodes=2,
                        M_pilot=4, sync_Ntaps=17, sync_mu=1e-3, sync_Niter=10, Ntaps=45,
                        foe_comp=False, cpe_avg=3, cpe_pilot_rat=1, frames=(0,), block_size=128,
                        pallas=None, frames_mode="scan", return_phase=True, eq_trainer="lms",
                        frames_pack=1, device=None):
    """Build the pilot chain on ``device`` (see :class:`PilotRxChain`).

    ``device=None`` is the card, and raises on a machine without one; pass
    ``device="cpu"`` for the CPU.

    Parameters and defaults follow the reference's ``make_pilot_rx_chain``;
    ``pilot_seq`` (n, seq_len) and ``ph_pilots`` (n, nph) are host arrays of
    the known pilots. The reference's LMS-trainer settings (``M``, ``mu``,
    ``Niter``, ``methods``) come with that trainer (ROADMAP A6b): the LS
    chain has no use for them and does not take them. ``pallas=False`` asks
    for the reference's XLA frame body and raises; the XLA unroll knob
    ``frames_unroll`` has no counterpart here.
    """
    dev = resolve_device(device)
    chain = PilotRxChain(pilot_seq, ph_pilots, frame_len, pilot_ins_rat, os=os, nmodes=nmodes,
                         M_pilot=M_pilot, sync_Ntaps=sync_Ntaps, sync_mu=sync_mu,
                         sync_Niter=sync_Niter, Ntaps=Ntaps, foe_comp=foe_comp, cpe_avg=cpe_avg,
                         cpe_pilot_rat=cpe_pilot_rat, frames=frames, block_size=block_size,
                         pallas=pallas, frames_mode=frames_mode, return_phase=return_phase,
                         eq_trainer=eq_trainer, frames_pack=frames_pack)
    if dev.type == "cuda" and chain.kernel_interp:
        # B5's limit (an average of tens of thousands of pilots), here rather than at a launch
        check_cpe_plan(chain.nmodes * len(frames), chain.nblk, chain.cpe_avg, chain.npts)
    return chain.to(dev)
