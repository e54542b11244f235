"""Adaptive equalisation on signal objects (counterpart of ``qampy_tpu/equalisation.py``).

Thin adapters: they take ``os``, ``M`` and the symbols from the signal,
call ``ops.equaliser`` or ``ops.pilots`` on the signal's device and return
signals with the attributes carried over. The trainers and filters are the
port's kernels on the card (B1, B9 and B2; see ``ops.equaliser``).

A pilot signal's frames are filtered in one launch of kernel B2's frame
entry for each pair of output modes (:func:`_apply_to_pilotsignal`), where
the reference calls the filter once per mode and frame.
"""
from __future__ import annotations

import numpy as np
import torch

from qampy_tpu_torch import phaserec
from qampy_tpu_torch.ops import equaliser as core_equalisation
from qampy_tpu_torch.ops import pilots as pilotbased_receiver
from qampy_tpu_torch.ops.equaliser import (CDcomp, DATA_AIDED, DECISION_BASED,  # noqa: F401
                                           NONDECISION_BASED, REAL_VALUED, TRAINING_FCTS)
from qampy_tpu_torch.ops.equaliser_cuda import apply_filter_frames
from qampy_tpu_torch.ops.phase import to_device

__all__ = ["apply_filter", "equalise_signal", "dual_mode_equalisation", "pilot_equaliser",
           "pilot_equaliser_nframes", "CDcomp"]


def _apply_to_pilotsignal(sig, wxy, frames):
    """The taps applied to the given frames of a synced pilot signal (reference :21-69).

    Output row i is filtered from the start of its mode's frame
    (``shiftfctrs[i % nmodes]``, moved by half the difference between the
    taps and the sync's taps, and by a frame where it falls before the
    start) plus each frame's offset, as the reference's three branches cut
    it (one segment, one per mode, one per mode and frame). Here all of
    them are one call of the frame filter (B2's frame entry on the card,
    two output modes a launch) with (nout, nframes) window starts; the
    outputs of the frames follow each other along the time axis. Returns a
    signal at the symbol rate.
    """
    wxy = torch.as_tensor(wxy, device=sig.device).to(torch.complex64)
    nout, _, Ntaps = wxy.shape
    L = sig.shape[-1]
    shiftfctrs = np.asarray(sig.shiftfctrs).astype(np.int64)
    if Ntaps != sig.synctaps:
        shiftfctrs = shiftfctrs - (Ntaps - sig.synctaps) // 2
    if np.min(shiftfctrs) < 0:
        shiftfctrs = shiftfctrs + sig.os * sig.frame_len
    frames = np.asarray(list(frames), dtype=np.int64)
    step = sig.os * sig.frame_len
    if not shiftfctrs.max() + step * (frames.max() + 1) < L - (Ntaps - 1):
        raise ValueError("Trying to equalise frame {}, but signal is not long enough"
                         .format(frames.max()))
    offs = shiftfctrs[np.arange(nout) % sig.shape[0], None] + step * frames[None, :]
    out = apply_filter_frames(core_equalisation.planes(sig.samples).contiguous(), sig.os, wxy,
                              to_device(offs, sig.device), sig.frame_len)
    return sig.recreate_from_np_array(torch.complex(out[0], out[1]).reshape(nout, -1),
                                      fs=sig.fb)


def apply_filter(sig, wxy, method=None, frames=[0]):
    """Apply equaliser taps to a signal object (reference :72-88).

    A pilot signal has its ``frames`` filtered (:func:`_apply_to_pilotsignal`);
    any other signal, or ``frames`` empty, the whole capture. ``method`` is
    accepted as in the reference and not used.
    """
    if hasattr(sig, "pilots") and frames:
        return _apply_to_pilotsignal(sig, wxy, frames)
    return sig.recreate_from_np_array(core_equalisation.apply_filter(sig.samples, sig.os, wxy),
                                      fs=sig.fb)


def _get_symbols(sig, methods):
    """The symbols a method trains on: the sent symbols for a data-aided one, else the alphabet."""
    methods = (methods,) if isinstance(methods, str) else methods
    for method in methods:
        if method in DATA_AIDED:
            return sig.symbols.cpu().numpy()
    return getattr(sig, "coded_symbols_host", None)


def equalise_signal(sig, mu, wxy=None, Ntaps=None, TrSyms=None, Niter=1, method="mcma",
                    adaptive_stepsize=False, symbols=None, modes=None, apply=False, **kwargs):
    """Adaptive equalisation of a signal object on its device (reference :91-104).

    ``kwargs`` go to ``ops.equaliser.equalise_signal`` (``backend``,
    ``block_size``, ``avoid_cma_sing``). Returns (wxy, err), or with
    ``apply`` (signal at the symbol rate, wxy, err).
    """
    if symbols is None:
        symbols = _get_symbols(sig, method)
    kwargs.setdefault("device", sig.device)
    res = core_equalisation.equalise_signal(
        sig.samples, sig.os, mu, sig.M, wxy=wxy, Ntaps=Ntaps, TrSyms=TrSyms, Niter=Niter,
        method=method, adaptive_stepsize=adaptive_stepsize, symbols=symbols, modes=modes,
        apply=apply, **kwargs)
    if apply:
        sig_out, wxy, err = res
        return sig.recreate_from_np_array(sig_out, fs=sig.fb), wxy, err
    return res


def dual_mode_equalisation(sig, mu, Ntaps, TrSyms=(None, None), Niter=(1, 1),
                           methods=("mcma", "sbd"), adaptive_stepsize=(False, False),
                           symbols=None, modes=None, apply=True, **kwargs):
    """Two-stage equalisation of a signal object on its device (reference :107-120).

    Returns (signal at the symbol rate, wxy, (err1, err2)), or without
    ``apply`` (wxy, (err1, err2)).
    """
    if symbols is None:
        symbols = _get_symbols(sig, methods)
    kwargs.setdefault("device", sig.device)
    res = core_equalisation.dual_mode_equalisation(
        sig.samples, sig.os, mu, sig.M, Ntaps=Ntaps, TrSyms=TrSyms, Niter=Niter,
        methods=methods, adaptive_stepsize=adaptive_stepsize, symbols=symbols, modes=modes,
        apply=apply, **kwargs)
    if apply:
        sig_out, wx, err = res
        return sig.recreate_from_np_array(sig_out, fs=sig.fb), wx, err
    return res


def pilot_equaliser(signal, mu, Ntaps, apply=True, foe_comp=True, wxinit=None, frame=0,
                    verbose=False, **eqkwargs):
    """Pilot-aided equalisation of one frame of a synced pilot signal (reference :123-154).

    The taps come from ``ops.pilots.equalize_pilot_sequence`` over the
    frame's pilot sequence (``eqkwargs``: ``methods``, ``Niter``,
    ``backend``, ...); with ``foe_comp`` its pilot FOE is taken out of the
    whole signal (``phaserec.comp_freq_offset``, on the whole signal's time
    axis) before the frame is filtered. Returns (taps, signal) with
    ``apply``, else the taps; ``verbose`` adds the FOE and (Ntaps, synctaps).
    """
    if signal.shiftfctrs is None:
        raise ValueError("Signal must be synced to the frame first (run sync2frame)")
    eq_shiftfctrs = np.array(signal.shiftfctrs, dtype=int)
    mu = np.atleast_1d(mu)
    if len(mu) == 1:
        mu = np.repeat(mu, 2)
    if wxinit is not None:
        Ntaps = np.asarray(wxinit.cpu() if torch.is_tensor(wxinit) else wxinit).shape[-1]
    if (abs(Ntaps - signal.synctaps) % 2) != 0:
        raise ValueError("Tap difference needs to be an integer of the oversampling")
    elif Ntaps != signal.synctaps:
        eq_shiftfctrs = (eq_shiftfctrs - (Ntaps - signal.synctaps) // 2
                         + signal.os * signal.frame_len * frame)
    if not signal.shape[-1] - eq_shiftfctrs.max() > signal.frame_len * signal.os:
        raise ValueError("You are trying to equalise an incomplete frame which does not work")
    taps_all, foe_all = pilotbased_receiver.equalize_pilot_sequence(
        signal.samples, signal.pilot_seq, eq_shiftfctrs, os=signal.os, mu=mu, foe_comp=foe_comp,
        Ntaps=Ntaps, wxinit=wxinit, device=signal.device, **eqkwargs)
    out_sig = phaserec.comp_freq_offset(signal, foe_all) if foe_comp else signal
    if apply:
        eq_mode_sig = apply_filter(out_sig, taps_all, frames=[frame])
        if verbose:
            return taps_all, eq_mode_sig, foe_all, (Ntaps, signal.synctaps)
        return taps_all, eq_mode_sig
    if verbose:
        return taps_all, foe_all, (Ntaps, signal.synctaps)
    return taps_all


def pilot_equaliser_nframes(signal, mu, Ntaps, apply=True, foe_comp=True, frames=[0],
                            wxinit=None, verbose=True, **eqkwargs):
    """Pilot-aided equalisation frame by frame (reference :157-183).

    Frame 0's taps start every later frame's training, so the frames are
    trained one after the other, each by :func:`pilot_equaliser` (one pilot
    equalisation and one frame filter launch a frame); ``frames`` None takes
    every whole frame. With ``apply`` returns (taps per frame, the frames'
    outputs as one signal, the rest of the per-frame results).
    """
    if signal.shiftfctrs is None:
        raise ValueError("Signal must be synced to the frame first (run sync2frame)")
    if frames is None:
        frames = np.arange((signal.shape[-1] - np.max(signal.shiftfctrs))
                           // (signal.os * signal.frame_len))
    frames = np.atleast_1d(frames)
    if not (signal.shape[-1] - (np.max(signal.shiftfctrs)
                                + np.max(frames) * signal.frame_len * signal.os)
            > signal.frame_len * signal.os):
        raise ValueError("The last frame must be complete for equalisation")
    if wxinit is not None:
        Ntaps = np.asarray(wxinit.cpu() if torch.is_tensor(wxinit) else wxinit).shape[-1]
    rets = []
    for i in frames:
        ret = pilot_equaliser(signal, mu, Ntaps, apply=apply, foe_comp=foe_comp, wxinit=wxinit,
                              verbose=verbose, frame=int(i), **eqkwargs)
        if i == 0:
            wxinit = ret[0]
        rets.append(ret)
    out = tuple(zip(*rets))
    if apply:
        sout = torch.cat([s.samples for s in out[1]], dim=-1)
        return out[0], signal.recreate_from_np_array(sout, fs=signal.fb), out[2:]
    return out
