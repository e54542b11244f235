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
3. pilot equalisation on each output mode's pilot segment, either by
   block LMS (``eq_trainer="lms"``, the default): a blind warm-up on the
   pilot alphabet and two more passes, each stage one batch over the
   output modes (kernel B1, one launch a stage, with a batch row per
   mode), or in closed form (``eq_trainer="ls"``): one Gram product and
   one real block solve per output mode. With ``foe_comp`` the warm taps
   give the pilot frequency offset, and the segments and then the whole
   capture are derotated by it;
4. the frame body, batched over all frames. The serving form (blocked
   pilot layout, no phase trace): the frame filter (kernel B2, frame entry,
   which also gathers the CPE pilots into contiguous rows), the pilot phase
   coefficients (kernel B5, from those rows) and the piecewise-linear
   derotation (kernel B4). The general form (``return_phase=True``, or a
   pilot layout not in whole blocks such as ``cpe_pilot_rat=2``): the same
   filter launch, the pilots gathered, their phase trace in plain torch,
   and kernel B6 derotates;
5. the payload: pilots dropped, frames concatenated per mode.

The reference scans its frame body over the frames; here each kernel
launches once per dispatch with (mode, frame) rows, and no value reaches
the host between the capture and the payload: shifts, window offsets and
the mode order stay on the device. Steps 1-2 and the LS solve are plain
PyTorch, as the reference leaves them to XLA. On CPU tensors the kernels
run their plain versions; on CUDA tensors the kernels run, with no
fallback.

The reference's ``pallas`` switch picks between two frame filters that
compute one function (its Pallas filter contracts in bf16, its XLA filter
in float32); the port's filter sums in float32 either way, so the port
takes ``pallas`` and ignores it. The mesh-sharded prefix raises
``NotImplementedError`` (ROADMAP A10); frame modes other than the batched
one and frame packing are not to be ported and raise ``ValueError``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter_frames, check_block_launch,
                                                check_filter_plan, train_block)
from qampy_tpu_torch.ops.phase import TWO_PI, time_axis, unwrap
from qampy_tpu_torch.ops.phase_cuda import (check_cpe_plan, cpe_coeffs, interp_rotate,
                                            moving_average, rotate)
from qampy_tpu_torch.signals import cal_pilot_idx
from qampy_tpu_torch.utils import resolve_device

__all__ = ["PilotRxChain", "make_pilot_rx_chain", "unwrap", "derotate_planes", "phase_slopes"]

FOE_FFT = 2 ** 16


def derotate_planes(P, foe, os):
    """Remove a frequency offset from (..., 2n, L) planes: (Pr c + Pi s, Pi c - Pr s).

    th = (2 pi foe / os) t over :func:`time_axis`, c = cos th, s = sin th,
    as the reference pilot chain derotates its planes (pilot_chain.py:590-601).
    """
    n = P.shape[-2] // 2
    th = (TWO_PI * foe / os) * time_axis(P.shape[-1], P.device)
    c, s = torch.cos(th), torch.sin(th)
    Pr, Pi = P[..., :n, :], P[..., n:, :]
    return torch.cat([Pr * c + Pi * s, Pi * c - Pr * s], dim=-2)


def phase_slopes(rr, ri, pr, pi):
    """Per-row (slope, intercept) of the unwrapped angle of conj(pilot) * received.

    rr/ri: received symbols and pr/pi the pilots, (..., N) float32 planes.
    The first-order least-squares fit over x = 0..N-1 of the reference's
    ``pilot_based_foe`` (ops/pilots.py:26-43), in radians per symbol.
    """
    pe = unwrap(torch.atan2(pr * ri - pi * rr, pr * rr + pi * ri))
    x = torch.arange(pe.shape[-1], dtype=torch.float32, device=pe.device)
    xm = x - x.mean()
    slope = (xm * (pe - pe.mean(dim=-1, keepdim=True))).sum(dim=-1) / (xm * xm).sum()
    return slope, pe.mean(dim=-1) - slope * x.mean()


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

    def __init__(self, pilot_seq, ph_pilots, frame_len, pilot_ins_rat, os=2, M=64, nmodes=2,
                 M_pilot=4, sync_Ntaps=17, sync_mu=1e-3, sync_Niter=10, Ntaps=45,
                 mu=(1e-3, 1e-3), Niter=30, methods=("cma", "cma"), foe_comp=False, cpe_avg=3,
                 cpe_pilot_rat=1, frames=(0,), block_size=128, pallas=None, frames_mode="scan",
                 return_phase=True, eq_trainer="lms", frames_pack=1):
        super().__init__()
        if eq_trainer not in ("lms", "ls"):
            raise ValueError("eq_trainer must be 'lms' or 'ls', got %r" % (eq_trainer,))
        if eq_trainer == "ls" and foe_comp:
            raise ValueError("eq_trainer='ls' supports foe_comp=False chains (the pilot FOE "
                             "comes from the LMS trainer's warm taps)")
        if frames_mode != "scan":
            raise ValueError("frames_mode=%r is not ported (ROADMAP: not to port); the port "
                             "batches the frames of the default 'scan'" % (frames_mode,))
        if int(frames_pack) != 1:
            raise ValueError("frames_pack=%r is not ported (ROADMAP: not to port)"
                             % (frames_pack,))
        methods = tuple(str(m).lower() for m in methods)
        if len(methods) != 2:
            raise ValueError("methods takes two methods, got %r" % (methods,))
        for m in methods:
            if m not in eqops.TRAINING_FCTS + eqops.EXTENDED_METHODS:
                raise ValueError("unknown equaliser method %r" % (m,))
            if m in eqops.REAL_VALUED:
                # the reference asserts it for a data-aided stage (pilot_chain.py:108-110)
                raise ValueError("the pilot chain trains complex-valued methods, got %r" % (m,))
        self.eq_trainer, self.foe_comp = eq_trainer, bool(foe_comp)
        self.mu, self.Niter = (float(mu[0]), float(mu[1])), int(Niter)
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
        # the LMS trainer's three stages (reference :403-445): (step, method, symbols rows)
        stages = [(self.mu[0], methods[0]), (self.mu[0], methods[0]), (self.mu[1], methods[1])]
        self.stage_specs = []
        for k, (_, m) in enumerate(stages):
            if k and m in eqops.DATA_AIDED:
                syms = pilot_seq[:, None, :]          # output mode i trains on its own pilots
            else:
                syms = eqops._reshape_symbols(None, m, M_pilot, dtype, 1)
            # kernel B1 for every method it computes; its launch limits raise on the card
            self.stage_specs.append(eqops.err_spec(m, syms) if m in eqops.BLOCK_METHODS
                                    else None)
            self.register_buffer("stage_syms%d" % k, torch.as_tensor(syms))
        self.stages = stages

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
        dat_idx = np.nonzero(idx_dat)[0]
        # blocked: a pilot at the head of every R-symbol block of the payload, each used
        self.blocked = (cpe_pilot_rat == 1 and (F - seq_len) % R == 0 and np.array_equal(
            dat_idx, (seq_len + np.arange(nblk)[:, None] * R + np.arange(1, R)[None, :]
                      ).reshape(-1)))
        # the serving form: the interpolation fuses into the derotation as per-block
        # (a, b) coefficients (kernels B5 and B4); anything else takes the general body
        self.kernel_interp = (self.blocked and not self.return_phase
                              and self.cpe_x0 % dx == 0 and F % dx == 0)
        self.n_head = self.cpe_x0 // dx
        self.npts = ph_idx.shape[0] - (cpe_avg - 1)
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
        self.register_buffer("ph_idx", torch.as_tensor(ph_idx, dtype=torch.int64))
        self.register_buffer("dat_idx", torch.as_tensor(dat_idx, dtype=torch.int64))
        self.register_buffer("w0_eq", torch.as_tensor(
            eqops._init_taps(Ntaps, n, n, dtype)[:, None]))

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

    def segments(self, P, eqsh, mode_order):
        """The pilot segments (n, 2n, seg_len): output mode i's at ``eqsh[i]``, rows in mode order.

        Clamped into the capture, as the reference's dynamic slices are
        (reference :377-381); gathered before the rows are reordered, so
        the capture itself is never copied.
        """
        n = self.nmodes
        st = eqsh.clamp(0, P.shape[-1] - self.seg_len)
        seg = P[:, st[:, None] + torch.arange(self.seg_len, device=P.device)]  # (2n, n, seg)
        rows = torch.cat([mode_order, mode_order + n])
        return seg.index_select(0, rows).transpose(0, 1).contiguous()

    def ls_taps(self, segs):
        """Closed-form data-aided taps, all output modes at once (reference :201-238).

        Output mode i fits w_i = argmin ||X_i w - pilot_seq_i||^2 with
        X_i[k, (p, t)] = segs[i, p, k*os + t], by the Tikhonov-regularised
        (1e-4 of the mean diagonal) normal equations in real block form.
        Returns (n, n, Ntaps) complex64 taps over the mode-ordered inputs.
        """
        n, Nt, K = self.nmodes, self.Ntaps, self.TrS_eq
        Pn = n * Nt

        def windows(x):   # (n_out, n_in, seg) -> (n_out, K, n_in*Ntaps)
            U = x.unfold(-1, Nt, self.os)[:, :, :K]
            return U.permute(0, 2, 1, 3).reshape(n, K, Pn)

        Xr, Xi = windows(segs[:, :n]), windows(segs[:, n:])
        XrT, XiT = Xr.transpose(-1, -2), Xi.transpose(-1, -2)
        S = XrT @ Xr + XiT @ Xi                       # Re(X^H X)
        T = XrT @ Xi - XiT @ Xr                       # Im(X^H X)
        lam = 1e-4 * S.diagonal(dim1=-2, dim2=-1).sum(-1) / Pn
        S = S + lam[:, None, None] * torch.eye(Pn, device=segs.device)
        A = torch.cat([torch.cat([S, -T], dim=-1), torch.cat([T, S], dim=-1)], dim=-2)
        dr, di = self.seq_r[:, :K, None], self.seq_i[:, :K, None]
        b = torch.cat([XrT @ dr + XiT @ di, XrT @ di - XiT @ dr], dim=-2)
        s = torch.linalg.solve_ex(A, b).result[..., 0]
        return torch.complex(s[:, :Pn], s[:, Pn:]).reshape(n, n, Nt)

    def train_stage(self, segs, w, k):
        """LMS stage ``k`` (0: the blind warm-up) on all output modes: taps (n, 1, n, Ntaps).

        One batch row per output mode, its own segment and taps (the
        reference vmaps over the modes): kernel B1 in one launch for every
        method it computes (its plain version on CPU tensors), the plain
        block trainer for the others (``sbd_data`` reads each mode's own
        pilot sequence). What B1's launch does not take raises
        ``KernelLimit`` when the chain is built for the card.
        """
        mu, method = self.stages[k]
        args = (self.TrS_eq, self.Niter, self.os, mu, w)
        spec = self.stage_specs[k]
        if spec is not None:
            return train_block(segs, *args, spec, True, self.block_size)[1]
        errfn = eqops.planes_errfn(method, getattr(self, "stage_syms%d" % k))
        return eqops.train_block_planes(segs, *args, errfn, adaptive=True,
                                        block_size=self.block_size)[1]

    def pilot_foe(self, segs, w):
        """Pilot FOE from the warm taps (reference :413-424), in cycles per symbol.

        Each mode's segment through its taps (the plain filter, which the
        reference leaves to XLA), the phase slope of conj(pilot) * output
        over the pilot sequence, averaged over the modes.
        """
        L = self.seq_len
        y = torch.stack([eqops.apply_filter_planes(segs[i], self.os, w[i])
                         for i in range(self.nmodes)])                 # (n, 2, seq_len)
        slope, _ = phase_slopes(y[:, 0, :L], y[:, 1, :L], self.seq_r, self.seq_i)
        return (slope / TWO_PI).mean()

    def lms_taps(self, segs):
        """Three-stage LMS pilot equalisation (reference :403-445): (taps (n, n, Ntaps), foe_pil).

        Stage 1 trains from centre-tap taps on the pilot alphabet; with
        ``foe_comp`` its taps give the pilot FOE and the segments are
        derotated by it; stages 2 and 3 train on from the warm taps.
        """
        w = self.train_stage(segs, self.w0_eq, 0)
        foe_pil = torch.zeros((), dtype=torch.float32, device=segs.device)
        if self.foe_comp:
            foe_pil = self.pilot_foe(segs, w)
            segs = derotate_planes(segs, foe_pil, self.os)
        w = self.train_stage(segs, w, 1)
        return self.train_stage(segs, w, 2)[:, 0], foe_pil

    # -- frame body -------------------------------------------------------------

    def frame_offsets(self, P, eqsh):
        """(n, nframes) window starts of every output mode's frames in the capture ``P``.

        Clamped into the capture, as the reference's dynamic slices are.
        """
        return (eqsh[:, None] + self.bases[None, :]).clamp(0, P.shape[-1] - self.fr_len)

    def cpe_trace(self, symr, symi):
        """The per-symbol CPE phase of (n, nframes, frame_len) planes (reference :799-820).

        Pilots gathered at the CPE pilot positions, ``unwrap``, moving
        average and the uniform-grid linear interpolation, clamped at both
        ends, in plain torch. The average is summed directly, as kernel B5
        sums it (see ``moving_average``).
        """
        dx, npts = self.cpe_dx, self.npts
        zr, zi = symr.index_select(-1, self.ph_idx), symi.index_select(-1, self.ph_idx)
        pr, pi = self.pil_r[:, None], self.pil_i[:, None]
        res_ph = unwrap(torch.atan2(pr * zi - pi * zr, pr * zr + pi * zi))
        ph_avg = moving_average(res_ph, self.cpe_avg, npts)           # (n, nf, npts)
        lead = ph_avg.shape[:-1]
        lo, hi = ph_avg[..., :-1, None], ph_avg[..., 1:, None]
        mid = (lo + (hi - lo) * self.wgt).reshape(*lead, (npts - 1) * dx)
        tail = self.frame_len - self.cpe_x0 - (npts - 1) * dx
        return torch.cat([ph_avg[..., :1].expand(*lead, self.cpe_x0), mid,
                          ph_avg[..., -1:].expand(*lead, tail)], dim=-1)

    def payload(self, outr, outi):
        """Drop the pilots: (dr, di), each (n, nframes * payload symbols per frame)."""
        n, R, F = self.nmodes, self.ins_rat, self.frame_len

        def take(x):
            x = x.reshape(n, -1, F)
            # blocked: a strided reshape, 10-17 % faster than the gather at 240 frames (PERF.md)
            if self.blocked:
                x = x[..., self.seq_len:].reshape(n, -1, self.nblk, R)[..., 1:]
            else:
                x = x.index_select(-1, self.dat_idx)
            return x.reshape(n, -1)
        return take(outr), take(outi)

    def demod(self, P, eqsh, taps):
        """Frame body over every frame of the dispatch: ((dr, di), trace or None).

        ``taps`` act on the capture's own mode order. Both forms filter all
        frames in one launch of kernel B2's frame entry. Serving form
        (``kernel_interp``): the entry's side output gathers the CPE pilots
        as (rows, nblk) planes, kernel B5 builds per-block (a, b)
        coefficients from them and kernel B4 derotates. General form: the
        plain phase trace (:meth:`cpe_trace`) and kernel B6.
        """
        F = self.frame_len
        offs = self.frame_offsets(P, eqsh)
        if self.kernel_interp:
            out, side = apply_filter_frames(P, self.os, taps, offs, F,
                                            (self.seq_len, self.ins_rat, self.nblk))
            rows = out.shape[1] * out.shape[2]
            pr, pi = side.reshape(2, rows, self.nblk).unbind(0)
            a, b = cpe_coeffs(pr, pi, self.pil_r, self.pil_i, 0, 1, self.n_head, self.npts,
                              self.cpe_dx, self.cpe_avg, self.nbt)
            outr, outi = interp_rotate(out[0].reshape(rows, F), out[1].reshape(rows, F), a, b,
                                       self.cpe_dx, sign=-1)
            return self.payload(outr, outi), None
        out = apply_filter_frames(P, self.os, taps, offs, F)
        rows = out.shape[1] * out.shape[2]
        trace = self.cpe_trace(out[0], out[1])
        outr, outi = rotate(out[0].reshape(rows, F), out[1].reshape(rows, F),
                            trace.reshape(rows, F), sign=-1)
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

    def _info(self, shift, sync_corr, foe_coarse, foe_pil, taps, mode_order, trace):
        info = {"shift": shift, "sync_corr": sync_corr, "foe": foe_coarse + foe_pil,
                "foe_pil": foe_pil, "taps": taps, "mode_order": mode_order}
        if self.return_phase:
            info["phase"] = trace.reshape(self.nmodes, -1)
        return info

    def _fwd(self, P):
        wxs, best_w = self.sync_search(P)
        mode_order, shift, sync_corr, foe_coarse = self.align(P, wxs, best_w)
        eqsh = self._eq_shift(shift)
        segs = self.segments(P, eqsh, mode_order)
        if self.eq_trainer == "ls":
            taps, foe_pil = self.ls_taps(segs), torch.zeros_like(foe_coarse)
        else:
            taps, foe_pil = self.lms_taps(segs)
        if self.foe_comp:
            P = derotate_planes(P, foe_pil, self.os)
        # the mode order folds into the taps' input axis (reference :1063-1069)
        data, trace = self.demod(P, eqsh, taps.index_select(1, torch.argsort(mode_order)))
        return data, self._info(shift, sync_corr, foe_coarse, foe_pil, taps, mode_order, trace)

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
        taps[i, inv[p]] E[p], inv = argsort(mo). On a ``foe_comp`` chain
        ``foe`` is the offset the capture is derotated by before the frame
        body: the full chain derotates by ``info["foe_pil"]``, so that value
        demodulates as it did (the reference's docstring names
        ``info["foe"]``, which also holds the frame search's coarse
        estimate, not applied to the capture). Without ``foe`` such a chain
        warns and demodulates uncompensated, as the reference does; a chain
        without ``foe_comp`` refuses ``foe``. ``info["sync_corr"]`` is +inf
        to mark that sync did not run. Returns ((dr, di), info).
        """
        if foe is not None and not self.foe_comp:
            raise ValueError("foe= supplied but the chain was built with foe_comp=False "
                             "(it would not be applied)")
        if self.foe_comp and foe is None:
            warnings.warn("chain built with foe_comp=True but the tracking entry got no foe=: "
                          "the frozen taps were trained on FOE-compensated segments while "
                          "this capture is demodulated uncompensated; pass the previous "
                          "dispatch's info['foe_pil']", stacklevel=2)
        P = self._planes(pr, pi)
        dev = P.device
        shift = torch.as_tensor(shift, device=dev).to(torch.int64)
        wxy = torch.as_tensor(wxy, device=dev)
        if mode_order is None:
            mo, w_eff = torch.arange(self.nmodes, device=dev), wxy
        else:
            mo = torch.as_tensor(mode_order, device=dev).to(torch.int64)
            w_eff = wxy.index_select(1, torch.argsort(mo))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        foe_t = zero if foe is None else torch.as_tensor(foe, device=dev).to(torch.float32)
        if foe is not None:
            P = derotate_planes(P, foe_t, self.os)
        data, trace = self.demod(P, self._eq_shift(shift), w_eff)
        inf = torch.full((), np.inf, dtype=torch.float32, device=dev)
        return data, self._info(shift, inf, zero, foe_t, wxy, mo, trace)

    def tracking(self, E, wxy, shift, mode_order=None, foe=None):
        """Complex twin of :meth:`tracking_planes`: (complex payload, info)."""
        (dr, di), info = self.tracking_planes(E.real, E.imag, wxy, shift, mode_order, foe)
        return torch.complex(dr, di), info

    def prefix_sharded(self, *args, **kwargs):
        """The mesh-sharded cold-start prefix of the reference (:513-578)."""
        raise NotImplementedError("the mesh-sharded prefix is ROADMAP item A10")


def make_pilot_rx_chain(pilot_seq, ph_pilots, frame_len, pilot_ins_rat, os=2, M=64, nmodes=2,
                        M_pilot=4, sync_Ntaps=17, sync_mu=1e-3, sync_Niter=10, Ntaps=45,
                        mu=(1e-3, 1e-3), Niter=30, methods=("cma", "cma"), foe_comp=False,
                        cpe_avg=3, cpe_pilot_rat=1, frames=(0,), block_size=128, pallas=None,
                        frames_mode="scan", return_phase=True, eq_trainer="lms", frames_pack=1,
                        device=None):
    """Build the pilot chain on ``device`` (see :class:`PilotRxChain`).

    ``device=None`` is the card, and raises on a machine without one; pass
    ``device="cpu"`` for the CPU.

    Parameters and defaults follow the reference's ``make_pilot_rx_chain``;
    ``pilot_seq`` (n, seq_len) and ``ph_pilots`` (n, nph) are host arrays of
    the known pilots. ``mu``, ``Niter`` and ``methods`` set the LMS
    trainer's stages (the warm-up and the second pass take ``methods[0]``
    at ``mu[0]``, the third ``methods[1]`` at ``mu[1]``, each ``Niter``
    passes over the pilot segment in blocks of ``block_size``); the LS
    trainer ignores them. ``M`` is taken for the reference's signature:
    the trainers work on the pilot alphabet (``M_pilot``). ``pallas`` is
    taken and ignored too: the reference's two frame filters compute one
    function, which the port's filter sums in float32; the XLA unroll knob
    ``frames_unroll`` has no counterpart here. On the card the launch
    limits of the kernels the chain runs are checked here and raise
    ``KernelLimit``: B1's for each LMS stage of a method it computes
    (``equaliser_cuda.check_block_launch``), the frame filter's plan
    (``equaliser_cuda.check_filter_plan``) and, in the serving form, B5's.
    """
    dev = resolve_device(device)
    chain = PilotRxChain(pilot_seq, ph_pilots, frame_len, pilot_ins_rat, os=os, M=M,
                         nmodes=nmodes, M_pilot=M_pilot, sync_Ntaps=sync_Ntaps, sync_mu=sync_mu,
                         sync_Niter=sync_Niter, Ntaps=Ntaps, mu=mu, Niter=Niter, methods=methods,
                         foe_comp=foe_comp, cpe_avg=cpe_avg, cpe_pilot_rat=cpe_pilot_rat,
                         frames=frames, block_size=block_size, pallas=pallas,
                         frames_mode=frames_mode, return_phase=return_phase,
                         eq_trainer=eq_trainer, frames_pack=frames_pack)
    if dev.type == "cuda":
        # the kernels' limits, here rather than at a launch
        n = chain.nmodes
        if chain.eq_trainer == "lms":
            like_P = torch.empty((n, 2 * n, chain.seg_len), device="meta")
            like_w = torch.empty((n, 1, n, chain.Ntaps), dtype=torch.complex64, device="meta")
            for spec in filter(None, chain.stage_specs):
                check_block_launch(like_P, chain.TrS_eq, chain.os, like_w, chain.block_size,
                                   spec)
        check_filter_plan(n, n, chain.Ntaps, chain.os, chain.frame_len, len(frames))
        if chain.kernel_interp:
            check_cpe_plan(n * len(frames), chain.nblk, chain.cpe_avg, chain.npts)
    return chain.to(dev)
