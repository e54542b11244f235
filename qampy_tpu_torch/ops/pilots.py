"""The granular pilot receiver (counterpart of ``qampy_tpu/ops/pilots.py``).

Frame sync, pilot equalisation, pilot FOE and pilot CPE as separate steps
on tensors, the reference's step-by-step orchestration for interactive use;
:mod:`qampy_tpu_torch.ops.pilot_chain` is the serving path. Each function
takes its signal (a tensor or a host array) to ``device``: None means the
card, and without one that raises; pass ``device="cpu"`` for the CPU. The
pilot references follow the signal. The frame search trains its W candidate
windows with the per-symbol LMS trainer, kernel B9 on the card, one launch
a window (the reference vmaps its XLA trainer over them); the window
metrics then come to the host for the greedy mode assignment, and the
search returns numpy values, as the reference's does.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from qampy_tpu_torch.core.filter import moving_average
from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops.equaliser_cuda import seq_launch_shape, train_seq
from qampy_tpu_torch.ops.phase import TWO_PI, comp_freq_offset, derotate, find_freq_offset
from qampy_tpu_torch.ops.pilot_chain import phase_slopes, unwrap
from qampy_tpu_torch.utils import resolve_device

__all__ = ["FRAME_SYNC_THRS", "pilot_based_foe", "frame_sync", "correct_shifts", "shift_signal",
           "equalize_pilot_sequence", "pilot_based_cpe", "pilot_based_cpe_new",
           "pilot_based_cpe_legacy"]

#: frame sync declares failure below this autocorrelation (reference :22)
FRAME_SYNC_THRS = 120


def _complex_rows(x, device=None):
    """A complex64 (nmodes, L) tensor of ``x`` on ``device`` (None: where ``x`` lies)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.complex64))
    return torch.atleast_2d(x.to(device)).to(torch.complex64)


def _conj_angle(rec, pil):
    """angle(conj(pil) * rec), products on the real and imaginary parts."""
    return torch.atan2(pil.real * rec.imag - pil.imag * rec.real,
                       pil.real * rec.real + pil.imag * rec.imag)


def pilot_based_foe(rec_symbs, pilot_symbs, device=None):
    """FOE from the phase slope between aligned received and sent pilots (reference :26-43).

    ``rec_symbs`` is taken to ``device`` (None: the card). Returns (foe, foePerMode (nmodes, 1), condNum (nmodes, 1)): the slope of
    the unwrapped angle of conj(pilot) * received in cycles per symbol, per
    mode and its mean; ``condNum`` is the fit's intercept, as in the
    reference.
    """
    rec = _complex_rows(rec_symbs, resolve_device(device))
    pil = _complex_rows(pilot_symbs, rec.device)
    slope, intercept = phase_slopes(rec.real, rec.imag, pil.real, pil.imag)
    foe_per_mode = (slope / TWO_PI)[:, None]
    return foe_per_mode.mean(), foe_per_mode, intercept[:, None]


def _window_trainer(method, symbols, TrSyms, os, w0):
    """The trainer of one search window: (P, Niter, mu, adaptive) -> (err, taps, mu).

    Kernel B9 for every method it computes (its plain version on CPU
    tensors), the plain per-symbol trainer for the others.
    """
    symbols = torch.as_tensor(symbols, device=w0.device)
    if method in eqops.SEQ_KERNEL_METHODS:
        return lambda P, Niter, mu, adaptive: train_seq(P, TrSyms, Niter, os, mu, w0, symbols,
                                                        method, adaptive)
    errfn = eqops.planes_errfn(method, symbols)
    return lambda P, Niter, mu, adaptive: eqops.train_seq_planes(P, TrSyms, Niter, os, mu, w0,
                                                                 errfn, adaptive)


def frame_sync(rx_signal, ref_symbs, os, frame_len=2 ** 16, M_pilot=4, mu=1e-3, Ntaps=17,
               device=None, **eqargs):
    """Locate the pilot sequence in the frame by a windowed CMA search (reference :46-143).

    ``rx_signal`` (a complex (nmodes, L) tensor or host array) is taken to
    ``device``; None means the card, and without one that raises: pass
    ``device="cpu"`` for the CPU. ``ref_symbs``: the (nmodes, seq_len)
    pilot sequences. ``eqargs`` may set the search training's ``method``
    (default "cma"), ``Niter`` (1) and ``adaptive_stepsize`` (False).

    The W windows of two pilot lengths, half a pilot length apart, each
    take a training of the per-symbol trainer (kernel B9 on the card, one
    launch a window); each mode's window of least error variance is
    filtered with its taps (kernel B2 on the card), FOE-compensated by the
    fourth-power estimate, and cross-correlated against every pilot
    sequence; a greedy assignment on the host gives each mode its pilot
    sequence and shift. Returns (shift_factor (nmodes,), coarse FOE (nmodes,
    1), mode_sync_order (nmodes,), taps of the last mode's window (nmodes,
    nmodes, Ntaps), sync_bool) as numpy values; ``sync_bool`` is False, with
    a warning, when a correlation peak stays below ``FRAME_SYNC_THRS``. On
    the card a search B9 does not take (more than 128 taps per output mode)
    raises ``KernelLimit`` before the capture is moved.
    """
    dev = resolve_device(device)
    E = _complex_rows(rx_signal)
    ref = _complex_rows(ref_symbs)
    seq_len = ref.shape[-1]
    nmodes = E.shape[0]
    if E.shape[-1] < (frame_len + 2 * seq_len) * os:
        raise ValueError("Signal must be at least as long as frame")
    if "method" in eqargs:
        if eqargs["method"] in eqops.REAL_VALUED:
            raise ValueError("using a real-valued equaliser in frame sync is unsupported")
        if eqargs["method"] in eqops.DATA_AIDED:
            raise ValueError("using a data-aided equaliser in frame sync is unsupported")
    method = eqargs.pop("method", "cma")
    Niter = int(eqargs.pop("Niter", 1))
    adaptive = bool(eqargs.pop("adaptive_stepsize", False))
    if eqargs:
        raise TypeError("frame_sync got unexpected arguments %s" % sorted(eqargs))
    search_overlap = 2
    sw = seq_len * os
    step = sw // search_overlap
    num_steps = (frame_len * os) // step + 1
    starts = np.arange(search_overlap, num_steps) * step
    TrSyms = eqops._cal_training_symbol_len(os, Ntaps, sw)
    symbols = eqops._reshape_symbols(None, method, M_pilot, np.complex64, nmodes)
    w0 = eqops._init_taps(Ntaps, nmodes, nmodes, np.complex64)
    if dev.type != "cpu" and method in eqops.SEQ_KERNEL_METHODS:
        # B9's limits, from shapes alone
        seq_launch_shape(torch.empty((2 * nmodes, sw), device="meta"), TrSyms, os,
                         torch.empty(w0.shape, dtype=torch.complex64, device="meta"))
    E, ref = E.to(dev), ref.to(dev)
    P = eqops.planes(E)
    train = _window_trainer(method, symbols, TrSyms, int(os), torch.as_tensor(w0, device=dev))
    wxys, evars = [], []
    for s in starts:
        err, wx, _ = train(P[:, s:s + sw].contiguous(), Niter, float(mu), adaptive)
        c = err - err.mean(dim=-1, keepdim=True)
        evars.append((c.real * c.real + c.imag * c.imag).mean(dim=-1))
        wxys.append(wx)
    sub_vars = np.ones((nmodes, num_steps)) * 1e2
    sub_vars[:, search_overlap:] = torch.stack(evars).cpu().numpy().T
    min_range = np.argmin(sub_vars, axis=-1)
    wxy = torch.stack([wxys[m - search_overlap] for m in min_range])   # (nmodes, n, n, t)
    # mode l's segment through its window's taps, FOE-compensated, correlated with every
    # pilot sequence in one batched FFT (reference :110-126)
    sy, foes = [], []
    for l, m in enumerate(min_range):
        y = eqops.apply_filter(E[:, m * step - sw: m * step + sw], os, wxy[l])
        foes.append(find_freq_offset(y))
        sy.append(comp_freq_offset(y, foes[-1])[l])
    sy = torch.stack(sy)                                               # (nmodes, Ls)
    Ls = sy.shape[-1]
    n = seq_len + Ls - 1
    nfft = int(2 ** np.ceil(np.log2(n)))
    Xf = torch.fft.fft(ref, nfft, dim=-1)
    Yf = torch.fft.fft(torch.conj(sy).flip(-1), nfft, dim=-1)
    ac = torch.fft.ifft(Xf[None, :, :] * Yf[:, None, :], dim=-1)[..., :n]
    acm = torch.maximum(ac.real.abs(), ac.imag.abs()).amax(dim=-1).cpu().numpy()
    delays = ((Ls - 1) - torch.argmax(ac.abs(), dim=-1)).cpu().numpy()
    foe_host = torch.stack(foes).cpu().numpy()                         # (nmodes, nmodes, 1)
    sync_bool = True
    mode_sync_order = np.zeros(nmodes, dtype=int)
    not_found_modes = np.arange(0, nmodes)
    shift_factor = np.zeros(nmodes, dtype=int)
    foe_corse = foe_host[0]
    for l in range(nmodes):
        masked = np.where(np.isin(np.arange(nmodes), not_found_modes), acm[l], -np.inf)
        max_sync_pol = int(np.argmax(masked))
        if masked[max_sync_pol] < FRAME_SYNC_THRS:
            warnings.warn("Very low autocorrelation, likely the frame-sync failed")
            sync_bool = False
        mode_sync_order[l] = max_sync_pol
        not_found_modes = not_found_modes[not_found_modes != max_sync_pol]
        shift_factor[l] = min_range[l] * step + os * int(delays[l, max_sync_pol]) - sw
        foe_corse = foe_host[l]                       # the reference keeps the last
    return (shift_factor, np.asarray(foe_corse), mode_sync_order,
            wxy[nmodes - 1].cpu().numpy(), sync_bool)


def correct_shifts(shift_factors, ntaps, os):
    """Correct shift factors for the search's and the equaliser's taps (reference :146-151)."""
    shift_factors = np.asarray(shift_factors)
    if not ((ntaps[1] - ntaps[0]) % os == 0):
        raise ValueError("Taps for search and convergence improperly configured")
    return shift_factors - int((ntaps[1] - ntaps[0]) / 2)


def shift_signal(sig, shift_factors, device=None):
    """Roll each mode back by its shift factor (reference :154-161).

    ``sig`` is taken to ``device`` (None: the card). With several shift
    factors mode i is rolled by -shift_factors[i]; a single factor rolls the
    whole signal forward by it, as in the reference.
    """
    sig = torch.as_tensor(sig).to(resolve_device(device))
    k = len(shift_factors)
    if k > 1:
        return torch.stack([torch.roll(sig[i], -int(shift_factors[i])) for i in range(k)])
    return torch.roll(sig, int(np.asarray(shift_factors).flatten()[0]), dims=-1)


def equalize_pilot_sequence(rx_signal, ref_symbs, shift_fctrs, os, foe_comp=False,
                            mu=(1e-4, 1e-4), M_pilot=4, Ntaps=45, Niter=30,
                            adaptive_stepsize=True, methods=("cma", "cma"), wxinit=None,
                            backend="auto", block_size=None, device=None):
    """Two-stage data-aided equalisation over the pilot sequence (reference :164-228).

    ``rx_signal``: the complex (nmodes, L) signal, taken to ``device``
    (None: the card); the trainings run there through :func:`equaliser.equalise_signal` with ``backend`` (on
    the card "auto" takes kernel B1 where it takes the method and the
    launch, else the plain block trainer; on the CPU the exact per-symbol
    trainer, as in the reference) and ``block_size`` (None: the trainer's
    default). A warm-up of ``methods[0]`` on each
    mode's segment (one training per mode where the shifts differ), with
    ``foe_comp`` the pilot FOE of its output (:func:`pilot_based_foe`) and
    the segments derotated by it, then ``methods[0]`` and ``methods[1]``
    with the pilot sequences as symbols. Returns (taps (nmodes, nmodes,
    Ntaps), foe_all (nmodes, 1)) as numpy arrays.
    """
    E = _complex_rows(rx_signal, resolve_device(device))
    ref = _complex_rows(ref_symbs, E.device)
    npols = E.shape[0]
    seq_len = ref.shape[-1]
    if (methods[0] in eqops.REAL_VALUED) != (methods[1] in eqops.REAL_VALUED):
        raise ValueError("Using a complex and real-valued equalisation method is not supported")
    shift_fctrs = np.asarray(shift_fctrs)
    kw = dict(adaptive_stepsize=adaptive_stepsize, backend=backend, block_size=block_size,
              device=E.device)
    seg_len = seq_len * os + Ntaps - 1
    per_mode = np.unique(shift_fctrs).shape[0] > 1

    def seg(i):
        return E[:, shift_fctrs[i]: shift_fctrs[i] + seg_len]
    wx = wxinit
    if per_mode:
        syms_out = torch.zeros_like(ref)
        for i in range(npols):
            s_i, wx, _ = eqops.equalise_signal(seg(i), os, mu[0], M_pilot, wxy=wx, Ntaps=Ntaps,
                                               Niter=Niter, method=methods[0], apply=True,
                                               modes=[i], **kw)
            # the output of mode i: the reference reads s_i[i] of this one-row result,
            # which its indexing clamps to the row
            syms_out[i] = s_i[0]
    else:
        syms_out, wx, _ = eqops.equalise_signal(seg(0), os, mu[0], M_pilot, wxy=wxinit,
                                                Ntaps=Ntaps, Niter=Niter, method=methods[0],
                                                apply=True, **kw)
    if foe_comp:
        foe, foe_per_mode, _ = pilot_based_foe(syms_out, ref, device=E.device)
        foe_all = np.ones(tuple(foe_per_mode.shape)) * float(foe)
    else:
        foe_all = np.zeros([npols, 1])
    out_taps = wx
    for i in range(npols if per_mode else 1):
        rx = seg(i)
        if foe_comp:
            rx = comp_freq_offset(rx, foe_all, os=os)
        modes = dict(modes=[i]) if per_mode else {}
        out_taps, _ = eqops.equalise_signal(rx, os, mu[0], M_pilot, wxy=out_taps, Ntaps=Ntaps,
                                            Niter=Niter, method=methods[0], symbols=ref,
                                            **modes, **kw)
        # the reference's per-mode branch gives the second method the QPSK alphabet (:219)
        out_taps, _ = eqops.equalise_signal(rx, os, mu[1], 4 if per_mode else M_pilot,
                                            wxy=out_taps, Ntaps=Ntaps if per_mode else None,
                                            Niter=Niter, method=methods[1], symbols=ref,
                                            **modes, **kw)
    return out_taps.cpu().numpy(), foe_all


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` over the last axis of ``fp`` (increasing ``xp``), in float32.

    i = clip(searchsorted(xp, x, right), 1, len - 1), then fp[i-1] +
    ((x - xp[i-1]) / (xp[i] - xp[i-1])) (fp[i] - fp[i-1]), fp[0] left of
    xp[0] and fp[-1] right of xp[-1], as the reference computes it.
    """
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[..., i - 1], fp[..., i]
    f = f0 + ((x - x0) / (x1 - x0)) * (f1 - f0)
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def pilot_based_cpe(signal, pilot_symbs, pilot_idx, frame_len, seq_len=None, num_average=1,
                    use_pilot_ratio=1, max_num_blocks=None, nframes=1, device=None):
    """Pilot-aided carrier phase estimation (reference :231-268, ``pilot_based_cpe_new``).

    ``signal``: the complex (nmodes, L) signal, taken to ``device`` (None:
    the card); ``pilot_symbs`` the sent phase pilots and ``pilot_idx``
    their positions in a frame. The pilot phases over ``nframes`` frames
    are unwrapped and averaged over
    ``num_average`` (made odd) pilots (summed directly, see
    :func:`core.filter.moving_average`), interpolated linearly to every
    symbol between the averaged pilots' positions (a ``searchsorted`` over
    them, as ``jnp.interp`` does), and the signal is derotated. Returns
    (compensated signal, phase trace), each cut to nframes * frame_len.
    """
    if num_average <= 1:
        raise ValueError("need to take average over at least 3")
    if not num_average % 2:
        num_average += 1
        warnings.warn("Number of averages should be odd, adding one average, num_average={}"
                      .format(num_average))
    sig = _complex_rows(signal, resolve_device(device))
    pil = _complex_rows(pilot_symbs, sig.device)
    pilot_idx = np.asarray(pilot_idx)
    idx_new = pilot_idx[:max_num_blocks:use_pilot_ratio]
    nlen = min(frame_len * nframes, sig.shape[-1])
    idx_full = np.ravel(idx_new[None, :] + (np.arange(nframes) * frame_len)[:, None])
    idx_full = idx_full[idx_full < nlen]
    rec = sig[:, torch.as_tensor(idx_full, device=sig.device)]
    pil = pil[:, ::use_pilot_ratio].repeat(1, nframes)[:, :rec.shape[-1]]
    if rec.shape != pil.shape:
        raise ValueError("Improper pilot configuration, the number of received pilots differs "
                         "from reference ones")
    if pil.shape[-1] < num_average:
        raise ValueError("Improper pilot symbol configuration. Averaging block larger than "
                         "number of pilots")
    res_phase_avg = moving_average(unwrap(_conj_angle(rec, pil)), num_average)
    i_adj = (num_average - 1) // 2
    idx_avg = torch.as_tensor(idx_full[i_adj:idx_full.shape[0] - i_adj], dtype=torch.float32,
                              device=sig.device)
    x = torch.arange(nlen, device=sig.device).to(torch.float32)
    trace = _interp(x, idx_avg, res_phase_avg)
    out = derotate(sig[:, :nlen], trace)
    return out[:, :nframes * frame_len], trace[:, :nframes * frame_len]


#: the reference's other name of the same function
pilot_based_cpe_new = pilot_based_cpe


def pilot_based_cpe_legacy(rec_symbs, pilot_symbs, pilot_ins_ratio, num_average=1,
                           use_pilot_ratio=1, max_num_blocks=None, remove_phase_pilots=True,
                           device=None):
    """Block-structured pilot CPE (reference :273-346, the reference's older ``pilot_based_cpe``).

    ``rec_symbs`` comes in blocks of ``pilot_ins_ratio`` symbols whose first
    symbol is a pilot (taken to ``device``; None: the card); the phase is
    averaged over ``num_average`` pilots
    (made odd), the edge blocks take the raw first phases and the last
    averaged phase, and the trace is interpolated linearly over the blocks.
    Returns (data symbols, phase trace).
    """
    rec = _complex_rows(rec_symbs, resolve_device(device))
    pil = _complex_rows(pilot_symbs, rec.device)
    ins, upr = int(pilot_ins_ratio), int(use_pilot_ratio)
    num_blocks = rec.shape[-1] // ins
    if max_num_blocks is not None and num_blocks > max_num_blocks:
        num_blocks = int(max_num_blocks)
    if num_blocks % upr:
        num_blocks -= num_blocks % upr
    rec_pilots = rec[:, ::ins][:, :num_blocks]
    rec = rec[:, :ins * num_blocks]
    num_ref = pil.shape[-1]
    if num_blocks > num_ref:
        num_blocks = num_ref
        rec = rec[:, :num_blocks * ins]
        rec_pilots = rec_pilots[:, :num_blocks]
    elif num_ref > num_blocks:
        pil = pil[:, :num_blocks]
    if upr >= pil.shape[-1]:
        raise ValueError("Can not use every %d pilots since only %d pilot symbols are present"
                         % (upr, pil.shape[-1]))
    rec_pilots, pil = rec_pilots[:, ::upr], pil[:, ::upr]
    if pil.shape[-1] <= num_average:
        raise ValueError("Inpropper pilot symbol configuration. Larger averaging block size "
                         "than total number of pilot symbols")
    if not num_average % 2:
        num_average += 1
    base = unwrap(_conj_angle(rec_pilots, pil))
    avg = moving_average(base, num_average)
    half = (num_average - 1) // 2
    pilot_phase = torch.cat([base[:, :half], avg, avg[:, -1:].expand(-1, half)], dim=-1)
    npts = pilot_phase.shape[-1]
    pos = torch.arange(0, npts * ins * upr, ins * upr, device=rec.device).to(torch.float32)
    pos_new = torch.arange(0, npts * ins * upr, device=rec.device).to(torch.float32)
    trace = _interp(pos_new, pos, pilot_phase)
    data = derotate(rec, trace)
    if remove_phase_pilots:
        keep = np.ones(data.shape[-1], dtype=bool)
        keep[np.arange(0, data.shape[-1], ins)] = False
        data = data[:, torch.as_tensor(np.nonzero(keep)[0], device=rec.device)]
    return data, trace
