"""Transmission and transceiver impairments in torch (``qampy_tpu/core/impairments.py``).

Channel impairments (noise, phase noise, carrier offset, PMD, modal delay,
dispersion) and the transmitter's models (quantisers, the DAC's ENOB and
frequency response, the amplifier, the IQ modulator) on complex (nmodes, L)
tensors on any device. Each random function takes an explicit
``torch.Generator`` on the tensor's device: the same seed gives other
numbers than the reference's ``jax.random`` keys, so tests compare
statistics, or hand both packages one capture. None of them reads a value
back from the card: the maxima and powers stay tensors. A measured DAC
response is read and interpolated on the host (:func:`load_dac_response`),
as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from qampy_tpu_torch.core.digital_pre_compensation import clipper
from qampy_tpu_torch.core.filter import filter_signal
from qampy_tpu_torch.helpers import normalise_and_center, rescale_signal
from qampy_tpu_torch.ops.phase import to_device


def fresh_generator(device):
    """A generator on ``device`` seeded from numpy's entropy, as the reference's ``key=None``."""
    return torch.Generator(device=device).manual_seed(int(np.random.randint(0, 2 ** 31 - 1)))


def _randn(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def phase_noise(shape, df, fs, generator):
    """Wiener phase noise, variance 2*pi*df/fs per step (reference :68-73).

    The walk is summed in float64 and returned as float32.
    """
    dev = generator.device
    steps = _randn(shape, generator, dev).double() * np.sqrt(2 * np.pi * df / fs)
    return torch.cumsum(steps, dim=-1).float()


def apply_phase_noise(sig, df, fs, generator):
    """Add laser phase noise to a complex signal (reference :76-80)."""
    ph = phase_noise(sig.shape, df, fs, generator)
    return sig * torch.polar(torch.ones_like(ph), ph)


def add_awgn(sig, strgth, generator):
    """Add complex AWGN of standard deviation ``strgth`` (reference :83-89)."""
    nr = _randn(sig.shape, generator, sig.device)
    ni = _randn(sig.shape, generator, sig.device)
    return sig + (strgth / np.sqrt(2)) * torch.complex(nr, ni)


def change_snr(sig, snr, fb, fs, generator):
    """Set the SNR of a (noiseless) signal, oversampling-aware (reference :92-98)."""
    p = torch.mean(torch.abs(sig) ** 2)
    n = 10 ** (-snr / 20) * np.sqrt(fs / fb)
    return add_awgn(sig, torch.sqrt(p) * n, generator)


def add_carrier_offset(sig, fo, fs):
    """Add a carrier frequency offset ``fo`` to a signal sampled at ``fs`` (reference :101-107).

    sig * exp(2j pi t fo / fs), t = 0, ..., L-1 along the last axis. The
    phase is reckoned in float64 cycles, reduced to [0, 1), and rounded to
    float32 once: the reference forms it in float32, whose t and phase lose
    precision over long captures (past 2^24 samples t itself rounds).
    """
    t = torch.arange(sig.shape[-1], dtype=torch.float64, device=sig.device)
    cyc = torch.remainder(t * (float(fo) / float(fs)), 1.0)
    ph = (2 * np.pi * cyc).to(torch.float32)
    return sig * torch.polar(torch.ones_like(ph), ph)


def _rotation(theta, dtype, device):
    return torch.tensor([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]],
                        dtype=dtype, device=device)


def apply_PMD_to_field(field, theta, t_dgd, fs):
    """First-order PMD on a dual-pol field: rotate, delay the axes by -+t_dgd/2, rotate back.

    Reference :49-65, in the frequency domain of the shifted spectrum.
    """
    L = field.shape[-1]
    omega = 2 * np.pi * torch.linspace(-fs / 2, fs / 2, L + 1, dtype=torch.float64,
                                       device=field.device)[:-1]
    Sf = torch.fft.fftshift(torch.fft.fft(torch.fft.ifftshift(field, dim=-1), dim=-1), dim=-1)
    Sf = _rotation(theta, Sf.dtype, field.device) @ Sf
    ph = torch.stack([-omega * t_dgd / 2, omega * t_dgd / 2]).float()
    Sf = Sf * torch.polar(torch.ones_like(ph), ph)
    Sf = _rotation(-theta, Sf.dtype, field.device) @ Sf
    out = torch.fft.fftshift(torch.fft.ifft(torch.fft.ifftshift(Sf, dim=-1), dim=-1), dim=-1)
    return out.to(field.dtype)


def add_modal_delay(sig, delay):
    """Delay mode i by ``delay[i]`` samples, circularly (reference :110-117)."""
    if len(delay) != sig.shape[0]:
        raise ValueError("Delay array must have the same length as number of modes of signal")
    return torch.stack([torch.roll(sig[i], int(d)) for i, d in enumerate(delay)])


def roll_frame_sync(sig, npilots):
    """Roll a pilot capture by its pilot count, as ``simulate_transmission(roll_frame_sync=True)``.

    Reference ``qampy_tpu/impairments.py:83-86``: the first frame then starts
    ``npilots`` samples into the capture, so the receiver has to find it.
    """
    return torch.roll(sig, int(npilots), dims=-1)


def simulate_transmission(sig, fb, fs, generator, snr=None, freq_off=None, lwdth=None,
                          dgd=None, theta=np.pi / 3.731, modal_delay=None):
    """Phase noise, carrier offset, SNR, modal delay and PMD in the reference's order.

    Reference :120-135.
    """
    if lwdth is not None:
        sig = apply_phase_noise(sig, lwdth, fs, generator)
    if freq_off is not None:
        sig = add_carrier_offset(sig, freq_off, fs)
    if snr is not None:
        sig = change_snr(sig, snr, fb, fs, generator)
    if modal_delay is not None:
        sig = add_modal_delay(sig, modal_delay)
    if dgd is not None:
        sig = apply_PMD_to_field(sig, theta, dgd, fs)
    return sig


# ---------------------------------------------------------------------------
# field rotations
# ---------------------------------------------------------------------------

def rotate_field(field, theta):
    """Rotate a dual-polarisation field by ``theta`` (reference :28-33)."""
    field = torch.as_tensor(field)
    return _rotation(theta, field.dtype, field.device) @ field


def H_PMD(theta, t_dgd, omega):
    """The PMD response (H, h3) over the angular frequencies ``omega`` (reference :36-46).

    H (2, 2, N) is the rotation by ``theta`` times the differential delay of
    ``t_dgd``; h3 is the rotation back, a 2 x 2 real tensor.
    """
    omega = torch.as_tensor(omega)
    ph = omega * (t_dgd / 2)
    e_m, e_p = torch.polar(torch.ones_like(ph), -ph), torch.polar(torch.ones_like(ph), ph)
    z = torch.zeros_like(e_m)
    h2 = torch.stack([torch.stack([e_m, z]), torch.stack([z, e_p])])
    H = torch.einsum("ij,jkl->ikl", _rotation(theta, h2.dtype, omega.device), h2)
    return H, _rotation(-theta, omega.dtype, omega.device)


# ---------------------------------------------------------------------------
# quantisers
# ---------------------------------------------------------------------------

def float32_linspace(start, stop, num):
    """``jnp.linspace(start, stop, num, dtype=float32)`` rounded as the reference computes it.

    XLA on the CPU evaluates it as s = i * f32(1/div), then
    fma(i, f32(stop/div), start * (1 - s)) (the division by div taken as a
    product with its float32 reciprocal); numpy's and torch's linspace
    differ from that in the last bit of about half the points, which would
    move the quantisers' levels. Host numpy, float32 result.
    """
    f32 = np.float32
    div = num - 1
    it = np.arange(div, dtype=f32)
    r = f32(f32(1) / f32(div))
    head = (f32(start) * (f32(1) - it * r)).astype(f32)
    tail = it.astype(np.float64) * np.float64(f32(f32(stop) * r))
    return np.concatenate([(tail + head).astype(f32), [f32(stop)]])


def _levels(start, stop, num, dtype, device):
    """``num`` levels from ``start`` to ``stop`` on ``device``, float32 ones as the reference's."""
    lv = float32_linspace(start, stop, num) if dtype == torch.float32 \
        else np.linspace(start, stop, num)
    return to_device(lv, device).to(dtype)


def _quantize(sig, dec, out):
    """I and Q (or a real signal) each to out[i], i the first with x <= dec[i], else the last."""
    def q(x):
        return out[torch.searchsorted(dec, x.contiguous(), right=False).clamp(0, out.numel() - 1)]
    return torch.complex(q(sig.real), q(sig.imag)) if sig.is_complex() else q(sig)


def quantize_signal(sig, nbits=6, rescale=True, re_normalize=True):
    """Quantise I and Q to 2**nbits levels over [-1, 1] (reference :138-152).

    With ``rescale`` each mode is first divided by its largest magnitude;
    with ``re_normalize`` the result is centred and normalised.
    """
    sig = torch.atleast_2d(torch.as_tensor(sig))
    if rescale:
        sig = sig / sig.abs().amax(dim=-1, keepdim=True).to(sig.dtype)
    levels = _levels(-1, 1, 2 ** nbits, sig.real.dtype, sig.device)
    out = _quantize(sig, levels[:-1], levels)
    return normalise_and_center(out) if re_normalize else out


def quantize_signal_New(sig_in, nbits=6, rescale_in=True, rescale_out=True):
    """Mid-riser quantiser of 2**nbits levels with clipping (reference :155-174).

    ``rescale_in`` scales each mode to a swing of one first; ``rescale_out``
    scales the result by the input's largest real or imaginary magnitude.
    """
    sig_in = torch.atleast_2d(torch.as_tensor(sig_in))
    sig = rescale_signal(sig_in, swing=1) if rescale_in else sig_in
    delta = 2 / 2 ** nbits
    levels_out = _levels(-1 + delta / 2, 1 - delta / 2, 2 ** nbits, sig.real.dtype, sig.device)
    out = _quantize(sig, (levels_out + delta / 2)[:-1], levels_out)
    if rescale_out:
        out = out * _peak_iq(sig_in)
    return out


# ---------------------------------------------------------------------------
# the transmitter's models
# ---------------------------------------------------------------------------

def modulator_response(rfsig, dcbias=1, gfactr=1, cfactr=0, dcbias_out=0.5, gfactr_out=1):
    """The IQ Mach-Zehnder modulator's field for the drive ``rfsig`` (reference :177-193).

    A real ``dcbias``, ``gfactr`` or ``cfactr`` applies to both arms
    (x becomes x + 1j x, as in the reference); a complex one gives the I arm
    its real part and the Q arm its imaginary part.
    """
    rfsig = torch.as_tensor(rfsig)
    if not rfsig.is_complex():
        rfsig = torch.complex(rfsig, torch.zeros_like(rfsig))
    if not np.iscomplex(dcbias):
        dcbias = dcbias + 1j * dcbias
    if not np.iscomplex(gfactr):
        gfactr = gfactr + 1j * gfactr
    if not np.iscomplex(cfactr):
        cfactr = cfactr + 1j * cfactr
    dcbias, gfactr, cfactr = complex(dcbias), complex(gfactr), complex(cfactr)
    vi, vq = rfsig.real + dcbias.real, rfsig.imag + dcbias.imag

    def arm(v, g, c):
        ph = np.pi * v / 2
        return -(torch.polar(torch.ones_like(ph), ph * (1 + c))
                 + g * torch.polar(torch.ones_like(ph), -ph * (1 - c))) / (1 + g)
    e_i = arm(vi, gfactr.real, cfactr.real)
    e_q = arm(vq, gfactr.imag, cfactr.imag)
    return complex(np.exp(1j * np.pi / 4)) * (
        e_i * complex(np.exp(-1j * np.pi * dcbias_out / 2))
        + gfactr_out * e_q * complex(np.exp(1j * np.pi * dcbias_out / 2))) / (1 + gfactr_out)


def er_to_g(ext_rat):
    """Extinction ratio in dB to the modulator's gain factor (reference :196-198)."""
    return (10 ** (ext_rat / 20) - 1) / (10 ** (ext_rat / 20) + 1)


def _peak_iq(sig):
    """The largest real or imaginary magnitude of a signal, a 0-d tensor."""
    if not sig.is_complex():
        return sig.abs().max()
    return torch.maximum(sig.real.abs().max(), sig.imag.abs().max())


def apply_enob_as_awgn(sig, enob, verbose=False, generator=None):
    """The noise of an ENOB-limited converter as AWGN (reference :229-243).

    The quantisation step is the largest real or imaginary magnitude over
    2^(enob-1), its noise power step^2 / 12 per quadrature. With ``verbose``
    also the SNR in dB that the ENOB allows, a 0-d tensor. ``generator``
    None draws a fresh seed (:func:`fresh_generator`).
    """
    sig = torch.as_tensor(sig)
    generator = fresh_generator(sig.device) if generator is None else generator
    delta = _peak_iq(sig) / 2 ** (enob - 1)
    pownoise_mean = delta ** 2 / 12
    out = add_awgn(sig, torch.sqrt(2 * pownoise_mean), generator)
    if verbose:
        return out, 10 * torch.log10(torch.mean(sig.abs() ** 2) / 2 / pownoise_mean)
    return out


def load_dac_response(fn, fs, N, ch=1):
    """A measured DAC response interpolated onto the N-point FFT grid at ``fs`` (:246-260).

    Host numpy and scipy ``interp1d``, as in the reference; returns a
    (1, N) complex numpy array.
    """
    from scipy import interpolate
    npzfile = np.load(fn)
    dac_f = npzfile['dac_res_ch%d' % ch]
    dacf_complex = np.atleast_2d(dac_f[:, 1] * np.exp(1j * dac_f[:, 2]))
    dacf = np.concatenate((np.fliplr(np.conj(dacf_complex[:, 1:])), dacf_complex), axis=1)
    dac_freq = np.concatenate((np.fliplr(-np.atleast_2d(dac_f[1:, 0])),
                               np.atleast_2d(dac_f[:, 0])), axis=1)
    freq_sig_fft = np.fft.fftfreq(N) * fs
    polyfit = interpolate.interp1d(dac_freq.flatten(), dacf.flatten(), kind='linear',
                                   bounds_error=False,
                                   fill_value=dac_f[min(320, dac_f.shape[0] - 1), 1])
    return np.atleast_2d(polyfit(freq_sig_fft))


def apply_DAC_filter(sig, fs, cutoff=18e9, fn=None, ch=1):
    """The DAC's frequency response: a 2nd-order digital Bessel, or a measured one (:220-226)."""
    sig = torch.as_tensor(sig)
    if fn is None:
        return filter_signal(sig, fs, cutoff, ftype="bessel", order=2)
    sigf = torch.fft.fft(sig, dim=-1)
    H = to_device(load_dac_response(fn, fs, sig.shape[-1], ch=ch), sig.device)
    return torch.fft.ifft(sigf * H.to(sigf.dtype), dim=-1)


def sim_DAC_response(sig, fs, enob=5, clip_rat=1, quant_bits=0, generator=None, **dac_params):
    """The DAC: clipping, quantisation, ENOB noise, then its response (reference :201-217).

    ``generator`` draws the ENOB noise (None: a fresh seed);
    ``dac_params`` (``cutoff``, ``fn``, ``ch``) select the response, none
    leaves it out.
    """
    sig = torch.as_tensor(sig)
    sig_clip = sig if np.isclose(clip_rat, 1) else clipper(rescale_signal(sig, 1 / clip_rat), 1)
    if not np.isclose(quant_bits, 0):
        sig_clip = quantize_signal_New(sig_clip, nbits=quant_bits, rescale_in=True,
                                       rescale_out=True)
    if not np.isclose(enob, 0):
        sig_clip = apply_enob_as_awgn(sig_clip, enob, generator=generator)
    if dac_params:
        return apply_DAC_filter(sig_clip, fs, **dac_params)
    return sig_clip


def ideal_amplifier_response(sig, out_volt):
    """Scale the drive to a largest real or imaginary magnitude of ``out_volt`` (:263-267)."""
    sig = torch.as_tensor(sig)
    return sig / _peak_iq(sig) * out_volt


def sim_tx_response(sig, fs, enob=6, tgt_v=1, clip_rat=1, quant_bits=0,
                    dac_params={"cutoff": 18e9, "fn": None, "ch": None}, generator=None,
                    **mod_prms):
    """The transmitter: DAC, amplifier, IQ modulator (reference :270-276)."""
    sig_dac_out = sim_DAC_response(sig, fs, enob, clip_rat=clip_rat, quant_bits=quant_bits,
                                   generator=generator, **dac_params)
    return modulator_response(ideal_amplifier_response(sig_dac_out, tgt_v), **mod_prms)


def add_dispersion(sig, fs, D, L, wl0=1550e-9):
    """Chromatic dispersion of D (s/m^2) over L metres at ``wl0`` (reference :279-288).

    The phase -omega^2 beta2 L / 2 is reckoned in float64 and reduced to
    one turn before it is rounded to the signal's precision (the reference
    forms it in float32, whose rounding grows with omega^2).
    """
    sig = torch.as_tensor(sig)
    C = 2.99792458e8
    N = sig.shape[-1]
    omega = torch.fft.fftfreq(N, 1 / fs, dtype=torch.float64, device=sig.device) * np.pi * 2
    beta2 = D * wl0 ** 2 / (C * np.pi * 2)
    ph = torch.remainder(-0.5 * omega ** 2 * beta2 * L, 2 * np.pi).to(sig.real.dtype)
    H = torch.polar(torch.ones_like(ph), ph)
    sff = torch.fft.fft(torch.fft.ifftshift(sig, dim=-1), dim=-1)
    return torch.fft.fftshift(torch.fft.ifft(sff * H, dim=-1), dim=-1)
