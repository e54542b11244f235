"""Pilot frames and a simple transmitter (``qampy_tpu/core/pilotbased_transmitter.py``).

The frame builders are ``SignalWithPilots`` constructions, as in the JAX
package (the original module builds them on a removed module); ``sim_tx``
resamples a frame and applies the basic impairments on its device.
"""
from __future__ import annotations

import numpy as np

from qampy_tpu_torch.core import impairments as cimpairments
from qampy_tpu_torch.signals import SignalWithPilots, TDHQAMSymbols, cal_pilot_idx

__all__ = ["gen_dataframe_with_phasepilots", "gen_dataframe_without_phasepilots",
           "gen_dataframe_with_phasepilots_hybridmodulation", "sim_tx"]


def gen_dataframe_with_phasepilots(M, nmodes, frame_len=2 ** 16, pilot_seq_len=8192,
                                   pilot_ins_ratio=32, **kwargs):
    """A pilot frame: a QPSK sequence, then a phase pilot every ``pilot_ins_ratio`` symbols."""
    return SignalWithPilots(M, frame_len, pilot_seq_len, pilot_ins_ratio, nmodes=nmodes,
                            Mpilots=4, **kwargs)


def gen_dataframe_without_phasepilots(M, nmodes, frame_len=2 ** 16, pilot_seq_len=8192,
                                      **kwargs):
    """A pilot frame with the leading pilot sequence only (reference :30-38)."""
    return SignalWithPilots(M, frame_len, pilot_seq_len, 0, nmodes=nmodes, Mpilots=4, **kwargs)


def gen_dataframe_with_phasepilots_hybridmodulation(M=(128, 256), mod_ratio=(1, 1), npols=2,
                                                    frame_len=2 ** 18, pilot_seq_len=256,
                                                    pilot_ins_ratio=32, **kwargs):
    """A pilot frame around a time-domain hybrid QAM payload (reference :41-65).

    The payload interleaves the two orders in the ratio ``mod_ratio``
    (``TDHQAMSymbols``, 'dist' power scaling), rounded up to whole hybrid
    frames. Returns (pilot signal, payload).
    """
    if len(M) != 2 or len(mod_ratio) != 2:
        raise ValueError("exactly two modulation formats/ratios are supported")
    if (frame_len - pilot_seq_len) % pilot_ins_ratio != 0:
        raise ValueError("Pilot insertion ratio not properly selected")
    _, idx_dat, _ = cal_pilot_idx(frame_len, pilot_seq_len, pilot_ins_ratio)
    Ndat = int(np.count_nonzero(idx_dat))
    fr = mod_ratio[1] / (mod_ratio[0] + mod_ratio[1])
    f_M = TDHQAMSymbols._cal_fractions(fr)[0]
    payload = TDHQAMSymbols((M[0], M[1]), -(-Ndat // f_M) * f_M, fr=fr, nmodes=npols, **kwargs)
    return SignalWithPilots.from_symbol_array(payload, frame_len, pilot_seq_len, pilot_ins_ratio,
                                              pilot_kwargs={"M": 4}), payload


def sim_tx(frame, os, snr=None, modal_delay=None, freqoff=None, linewidth=None, rot_angle=None,
           beta=0.1, generator=None):
    """Resample a frame to ``os`` samples a symbol, then impair it (reference :68-88).

    Modal delay, phase noise, carrier offset, noise and a rotation of the
    polarisations, in the reference's order, on the frame's device;
    ``generator`` None draws a fresh seed.
    """
    sig = frame.resample(frame.fb * os, beta=beta)
    arr = sig.samples
    gen = cimpairments.fresh_generator(arr.device) if generator is None else generator
    if modal_delay is not None:
        arr = cimpairments.add_modal_delay(arr, modal_delay)
    if linewidth is not None:
        arr = cimpairments.apply_phase_noise(arr, linewidth, sig.fs, gen)
    if freqoff is not None:
        arr = cimpairments.add_carrier_offset(arr, freqoff, sig.fs)
    if snr is not None:
        arr = cimpairments.change_snr(arr, snr, sig.fb, sig.fs, gen)
    if rot_angle is not None:
        arr = cimpairments.rotate_field(arr, rot_angle)
    return sig.replace(samples=arr.to(sig.dtype))
