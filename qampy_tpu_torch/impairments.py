"""Impairments on signal objects (counterpart of ``qampy_tpu/impairments.py``).

Each function takes a signal of ``qampy_tpu_torch.signals`` (or a tensor)
and returns a signal with the same attributes over the impaired samples,
on the signal's device. A random one takes ``generator=`` (a
``torch.Generator`` on the signal's device) where the reference takes
``key=``; None draws a fresh seed, as the reference's ``key=None`` does.
"""
from __future__ import annotations

import warnings

import numpy as np

from qampy_tpu_torch.core import impairments as cimpairments
from qampy_tpu_torch.core.impairments import rotate_field  # noqa: F401 (the reference's namespace)
from qampy_tpu_torch.signals import SignalWithPilots, rewrap, samples_of

__all__ = ["add_awgn", "apply_PMD", "apply_phase_noise", "change_snr", "add_carrier_offset",
           "add_dispersion", "add_modal_delay", "simulate_transmission", "sim_tx_response",
           "sim_DAC_response", "sim_mod_response", "rotate_field"]


def _gen(sig, generator):
    return cimpairments.fresh_generator(samples_of(sig).device) if generator is None else generator


def add_awgn(sig, strgth, generator=None):
    """Add complex AWGN of standard deviation ``strgth`` (reference qampy/impairments.py:28-39)."""
    return rewrap(sig, cimpairments.add_awgn(samples_of(sig), strgth, _gen(sig, generator)))


def apply_PMD(sig, theta, t_dgd):
    """First-order PMD: rotation by ``theta``, differential delay ``t_dgd`` (reference :42-45)."""
    return rewrap(sig, cimpairments.apply_PMD_to_field(samples_of(sig), theta, t_dgd, sig.fs))


def apply_phase_noise(sig, df, generator=None):
    """Laser phase noise of linewidth ``df`` (reference :48-51)."""
    return rewrap(sig, cimpairments.apply_phase_noise(samples_of(sig), df, sig.fs,
                                                       _gen(sig, generator)))


def change_snr(sig, snr, generator=None):
    """Noise for an SNR of ``snr`` dB, oversampling-aware (reference :54-57)."""
    return rewrap(sig, cimpairments.change_snr(samples_of(sig), snr, sig.fb, sig.fs,
                                                _gen(sig, generator)))


def add_carrier_offset(sig, fo):
    """A carrier frequency offset of ``fo`` Hz (reference :60-63)."""
    return rewrap(sig, cimpairments.add_carrier_offset(samples_of(sig), fo, sig.fs))


def add_dispersion(sig, D, L, wl0=1550e-9):
    """Chromatic dispersion of D (s/m^2) over L metres (reference :66-69)."""
    return rewrap(sig, cimpairments.add_dispersion(samples_of(sig), sig.fs, D, L, wl0=wl0))


def add_modal_delay(sig, delay):
    """Delay mode i by ``delay[i]`` samples, circularly (reference :72-75)."""
    return rewrap(sig, cimpairments.add_modal_delay(samples_of(sig), delay))


def simulate_transmission(sig, snr=None, freq_off=None, lwdth=None, dgd=None,
                          theta=np.pi / 3.731, modal_delay=None, roll_frame_sync=False,
                          generator=None):
    """Phase noise, carrier offset, SNR, modal delay and PMD in the reference's order (:78-93).

    ``roll_frame_sync`` first rolls the capture by its pilot count, so that
    a receiver has to find the frame (a warning where there is a single
    frame, whose end then wraps into its start).
    """
    if roll_frame_sync:
        if not (isinstance(sig, SignalWithPilots) and sig.nframes > 1):
            warnings.warn("Only single frame present, discontinuity introduced")
        sig = rewrap(sig, cimpairments.roll_frame_sync(samples_of(sig), sig.pilots.shape[1]))
    arr = cimpairments.simulate_transmission(samples_of(sig), sig.fb, sig.fs, _gen(sig, generator),
                                             snr=snr, freq_off=freq_off, lwdth=lwdth, dgd=dgd,
                                             theta=theta, modal_delay=modal_delay)
    return rewrap(sig, arr)


def sim_tx_response(sig, enob=6, tgt_v=1, clip_rat=1, quant_bits=0,
                    dac_params={"cutoff": 18e9, "fn": None, "ch": None}, generator=None,
                    **mod_prms):
    """The transmitter: DAC, amplifier, IQ modulator (reference :96-103)."""
    arr = cimpairments.sim_tx_response(samples_of(sig), sig.fs, enob=enob, tgt_v=tgt_v,
                                       clip_rat=clip_rat, quant_bits=quant_bits,
                                       dac_params=dac_params, generator=_gen(sig, generator),
                                       **mod_prms)
    return rewrap(sig, arr)


def sim_DAC_response(sig, enob=5, clip_rat=1, quant_bits=0, generator=None, **dac_params):
    """The DAC: clipping, quantisation, ENOB noise and its response (reference :106-110)."""
    arr = cimpairments.sim_DAC_response(samples_of(sig), sig.fs, enob=enob, clip_rat=clip_rat,
                                        quant_bits=quant_bits, generator=_gen(sig, generator),
                                        **dac_params)
    return rewrap(sig, arr)


def sim_mod_response(sig, dcbias=1, gfactr=1, cfactr=0, dcbias_out=0.5, gfactr_out=1):
    """The IQ modulator's field for the drive ``sig`` (reference :113-118)."""
    arr = cimpairments.modulator_response(samples_of(sig), dcbias=dcbias, gfactr=gfactr,
                                          cfactr=cfactr, dcbias_out=dcbias_out,
                                          gfactr_out=gfactr_out)
    return rewrap(sig, arr)
