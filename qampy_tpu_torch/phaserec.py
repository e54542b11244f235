"""Carrier and phase recovery on signal objects (counterpart of ``qampy_tpu/phaserec.py``).

Each function takes a signal of ``qampy_tpu_torch.signals`` and returns a
signal with the same attributes (and the phase, where the reference does),
running on the signal's device. The phase searches classify the alphabet
from the signal's host copy, so they read nothing back from the card.
"""
from __future__ import annotations

import numpy as np
import torch

from qampy_tpu_torch.ops import phase as core_phaserecovery
from qampy_tpu_torch.ops import pilots as core_pilotbased_receiver
from qampy_tpu_torch.signals import Signal
from qampy_tpu_torch.utils import as_tensor


def bps(E, Mtestangles, N, **kwargs):
    """Blind phase search (phaserec.py:15-18): (signal, phase); kernels B3 and B6 on the card."""
    out, ph = core_phaserecovery.bps(E.samples, Mtestangles, E.coded_symbols_host, N, **kwargs)
    return E.recreate_from_np_array(out), ph


def bps_twostage(E, Mtestangles, N, B=4, **kwargs):
    """Two-stage blind phase search (phaserec.py:21-25): (signal, phase); B3, B8, B6 on the card."""
    out, ph = core_phaserecovery.bps_twostage(E.samples, Mtestangles, E.coded_symbols_host, N,
                                              B=B, **kwargs)
    return E.recreate_from_np_array(out), ph


def find_freq_offset(sig, average_over_modes=False, fft_size=4096):
    """Blind frequency-offset search (phaserec.py:28-32): (nmodes, 1) offsets.

    The defaults are this API's own (per mode, 4096 points), not
    ``ops.phase.find_freq_offset``'s (averaged, 2^16).
    """
    return core_phaserecovery.find_freq_offset(sig.samples, sig.os,
                                               average_over_modes=average_over_modes,
                                               fft_size=fft_size)


def comp_freq_offset(sig, freq_offset):
    """Compensate a frequency offset (phaserec.py:35-38)."""
    return sig.recreate_from_np_array(
        core_phaserecovery.comp_freq_offset(sig.samples, freq_offset, sig.os))


def viterbiviterbi(E, N):
    """Viterbi-Viterbi phase recovery (phaserec.py:41-44): (signal, phase)."""
    out, ph = core_phaserecovery.viterbiviterbi(E.samples, N, E.M)
    return E.recreate_from_np_array(out), ph


def phase_partition_16qam(E, Nblock):
    """QPSK-partitioning phase recovery of 16-QAM (phaserec.py:47-50): (signal, phase)."""
    out, ph = core_phaserecovery.phase_partition_16qam(E.samples, Nblock)
    return E.recreate_from_np_array(out), ph


def pilot_cpe(signal, N=3, pilot_rat=1, max_blocks=None, nframes=1, use_seq=False):
    """Pilot-based carrier phase estimation of a pilot signal (phaserec.py:53-67): (signal, trace).

    Through ``ops.pilots.pilot_based_cpe`` on the signal's device, with the
    phase pilots (and the pilot sequence, with ``use_seq``).
    """
    idx = np.nonzero(np.asarray(signal.idx_pil))[0]
    if use_seq:
        seq_len, pilots = signal.pilot_seq_len, signal.pilots
    else:
        seq_len, pilots, idx = None, signal.ph_pilots, idx[signal.pilot_seq_len:]
    out, phase_tr = core_pilotbased_receiver.pilot_based_cpe(
        signal.samples, pilots, idx, signal.frame_len, seq_len=seq_len,
        max_num_blocks=max_blocks, use_pilot_ratio=pilot_rat, num_average=N, nframes=nframes,
        device=signal.device)
    return signal.recreate_from_np_array(out), phase_tr


def _rows(x, device=None):
    return torch.atleast_2d(as_tensor(x.samples if isinstance(x, Signal) else x, device))


def find_pilot_const_phase(rec_pilots, ref_pilots):
    """The constant phase of received against sent pilots (phaserec.py:70-75): (nmodes, 1).

    The mean of the unwrapped angle of conj(ref) * rec per mode.
    """
    rec = _rows(rec_pilots)
    ref = _rows(ref_pilots, rec.device)
    ph = core_phaserecovery.unwrap(torch.angle(torch.conj(ref) * rec), dim=-1)
    return torch.mean(ph, dim=-1, keepdim=True)


def correct_pilot_const_phase(signal, phase_offsets):
    """Remove a constant phase per mode (phaserec.py:78-84): a signal for a signal."""
    sig = signal.samples if isinstance(signal, Signal) else as_tensor(signal)
    ph = torch.as_tensor(phase_offsets, device=sig.device)
    out = sig * torch.polar(torch.ones_like(ph), -ph).to(sig.dtype)
    return signal.replace(samples=out) if isinstance(signal, Signal) else out
