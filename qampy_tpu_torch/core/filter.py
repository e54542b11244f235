"""Filters on tensors (counterpart of ``qampy_tpu/core/filter.py``).

FFT filters (brick-wall, Gaussian, exponential, root-raised cosine) and the
IIR filters (digital Bessel and Butterworth as second-order sections, and
the analog prototypes simulated in continuous time), on a tensor of any
device, and the moving average.

The IIR recurrences are linear with a constant transition matrix,
``s[k] = M s[k-1] + b[k]``. The reference runs them as a ``lax.scan`` below
``IIR_ASSOC_MIN_SAMPLES`` and as an associative scan of (N, n, n) matrix
products above it, capped at a state dimension of four. The port runs every
length and order through one form, :func:`affine_prefix_states`: ceil(log2
N) doubling passes over an (N, n, channels) tensor with the powers of M
taken on the host in float64. It carries no (N, n, n) products, so it has no
cap on the state (ROADMAP queue C); each pass is a fixed sequence of
elementwise operations, so the card's result is the same on every call.

The filters are designed on the host with scipy, as in the reference. The
arithmetic follows the input: complex64 or float32 runs in float32,
complex128 or float64 in float64.
"""
from __future__ import annotations

import numpy as np
import scipy.signal as scisig
import torch

from qampy_tpu_torch.core.special import rrcos_freq, rrcos_time
from qampy_tpu_torch.ops.phase import to_device
from qampy_tpu_torch.ops.phase_cuda import moving_average as _window_mean

__all__ = ["fftconvolve_same", "pre_filter", "pre_filter_wdm", "filter_signal",
           "rrcos_pulseshaping", "moving_average", "affine_prefix_states"]


def _real_dtype(x):
    return torch.float64 if x.dtype in (torch.float64, torch.complex128) else torch.float32


def _complex_dtype(*xs):
    return torch.complex128 if any(_real_dtype(x) == torch.float64 for x in xs) \
        else torch.complex64


def fftconvolve_same(sig, h):
    """Linear convolution along the last axis, the 'same' part (reference core/filter.py:19-38).

    ``scipy.signal.fftconvolve(sig, h, 'same')`` on each row, through an
    FFT of 2**ceil(log2(n + m - 1)) points. The result has ``sig``'s dtype
    (real where both inputs are real).
    """
    sig = torch.as_tensor(sig)
    h = torch.as_tensor(h, device=sig.device)
    n, m = sig.shape[-1], h.shape[-1]
    nfull = n + m - 1
    nfft = int(2 ** np.ceil(np.log2(nfull)))
    cdt = _complex_dtype(sig, h)
    full = torch.fft.ifft(torch.fft.fft(sig.to(cdt), nfft) * torch.fft.fft(h.to(cdt), nfft))
    start = (m - 1) // 2
    out = full[..., start:start + n]
    if not (sig.is_complex() or h.is_complex()):
        out = out.real
    return out.to(sig.dtype)


def pre_filter(signal, bw):
    """Brick-wall low-pass pre-filter keeping a fraction of the spectrum (reference :41-52)."""
    signal = torch.as_tensor(signal)
    sig = torch.atleast_2d(signal)
    N = sig.shape[1]
    h = np.zeros(N, dtype=np.float64 if _real_dtype(sig) == torch.float64 else np.float32)
    cut = int(N / (bw / 2))
    h[cut:-cut] = 1
    h = to_device(h, sig.device)
    spec = torch.fft.fftshift(torch.fft.fft(sig, dim=-1), dim=-1) * h
    s = torch.fft.ifft(torch.fft.ifftshift(spec, dim=-1), dim=-1)
    return s.flatten() if signal.dim() < 2 else s


def pre_filter_wdm(signal, bw, os, center_freq=0):
    """Ideal low-pass selecting the band |f - center_freq| < bw/2 (reference :55-64).

    The reference module's original reads an undefined variable; this is
    the behaviour the JAX package fixed it to.
    """
    signal = torch.as_tensor(signal)
    N = signal.shape[-1]
    f = np.fft.fftfreq(N, 1 / os)
    h = (np.abs(f - center_freq) < bw / 2).astype(
        np.float64 if _real_dtype(signal) == torch.float64 else np.float32)
    return torch.fft.ifft(torch.fft.fft(signal, dim=-1) * to_device(h, signal.device), dim=-1)


# ---------------------------------------------------------------------------
# the IIR recurrence
# ---------------------------------------------------------------------------

def _columns(sig):
    """A (modes, N) real or complex tensor as (N, C) real columns (real and imaginary apart)."""
    x = torch.view_as_real(sig).permute(1, 0, 2) if sig.is_complex() else sig.T[..., None]
    return x.reshape(sig.shape[-1], -1)


def _from_columns(y, like):
    """The inverse of :func:`_columns` for a result of ``like``'s shape and kind."""
    N = like.shape[-1]
    if like.is_complex():
        return torch.view_as_complex(y.reshape(N, -1, 2).permute(1, 0, 2).contiguous())
    return y.reshape(N, -1).T.contiguous()


def prefix_powers(M, N, dtype):
    """The powers M^(2^j) that :func:`affine_prefix_states` passes over N samples use.

    Squared on the host in float64 and rounded to ``dtype`` (float32 or
    float64), for d = 2^j < N, up to the first that rounds to zero: a
    (passes, n, n) host array.
    """
    P = np.asarray(M, dtype=np.float64)
    hdt = np.float32 if dtype == torch.float32 else np.float64
    powers = []
    d = 1
    while d < N:
        Pt = P.astype(hdt)
        if not np.any(Pt):
            break
        powers.append(Pt)
        P = P @ P
        d *= 2
    return np.stack(powers) if powers else np.zeros((0,) + P.shape, hdt)


def affine_prefix_states(M, b):
    """All states of ``s[k] = M s[k-1] + b[k]`` with ``s[-1] = 0``, without a loop over samples.

    M: the constant (n, n) transition matrix, a host array; b: the (N, n, C)
    real tensor of offsets (C independent columns). Returns the (N, n, C)
    states. Doubling passes: after the pass of distance d = 2^j,
    x[k] = sum of M^(k-i) b[i] over the last 2d terms, by
    ``x[k] += M^d x[k - d]`` (the powers squared on the host in float64, then
    rounded to ``b``'s dtype). A pass whose power rounds to zero would add
    exact zeros, and it and every later pass are skipped; so a stable filter
    takes as many passes as its impulse response needs to fall below the
    dtype's smallest number, at most ceil(log2 N).
    """
    N, n, _ = b.shape
    powers = prefix_powers(M, N, b.dtype)
    if not len(powers):
        return b
    Pd = to_device(powers, b.device)
    x = b.clone()
    d = 1
    for j in range(len(powers)):
        prev = x[:-d]
        upd = x[d:] + Pd[j, :, 0].view(1, n, 1) * prev[:, 0:1]
        for k in range(1, n):
            upd = upd + Pd[j, :, k].view(1, n, 1) * prev[:, k:k + 1]
        x[d:] = upd
        d *= 2
    return x


def _sosfilt(sos, sig):
    """``scipy.signal.sosfilt`` along the last axis of a (modes, N) tensor, by prefix states.

    Each section's direct-form-II-transposed state obeys z[k] = M z[k-1] +
    c x[k], M = [[-a1, 1], [-a2, 0]], c = [b1 - a1 b0, b2 - a2 b0], and its
    output is y[k] = b0 x[k] + z[k-1][0] (reference ``_sosfilt_assoc``,
    core/filter.py:116-139); the sections run one after the other.
    """
    sos = np.asarray(sos, dtype=np.float64)
    dt = _real_dtype(sig)
    x = _columns(sig.to(_complex_dtype(sig) if sig.is_complex() else dt))
    for s in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = (float(v) for v in sos[s])
        M = np.array([[-a1, 1.0], [-a2, 0.0]])
        c = np.array([b1 - a1 * b0, b2 - a2 * b0]).astype(
            np.float32 if dt == torch.float32 else np.float64)
        S = affine_prefix_states(M, torch.stack([float(c[0]) * x, float(c[1]) * x], dim=1))
        z = torch.cat([torch.zeros_like(x[:1]), S[:-1, 0]])
        x = float(np.float32(b0) if dt == torch.float32 else b0) * x + z
    return _from_columns(x, sig)


def _van_loan(b, a, fs):
    """First-order-hold discretisation of the analog system (b, a) at ``fs``, in float64.

    Returns (Ad, Bd0, Bd1, C, D): x[k+1] = Ad x[k] + Bd0 u[k] + Bd1 u[k+1],
    y[k] = C x[k] + D u[k], from one augmented matrix exponential (Van Loan
    1978), lsim's ``interp=True`` model (reference ``_lsim_scan``, :228-260).
    Host scipy, as in the reference.
    """
    from scipy.linalg import expm
    A, B, C, D = scisig.tf2ss(b, a)
    n = A.shape[0]
    dt = 1.0 / fs
    Mv = np.zeros((n + 2, n + 2))
    Mv[:n, :n] = A * dt
    Mv[:n, n:n + 1] = B * dt
    Mv[n, n + 1] = dt
    Fm = expm(Mv)
    H0, H1 = Fm[:n, n], Fm[:n, n + 1] / dt
    return Fm[:n, :n], H0 - H1, H1, C[0], float(np.asarray(D).reshape(-1)[0])


def _lsim(b, a, sig, fs):
    """``scipy.signal.lsim((b, a), u, arange(N)/fs)`` on each row of a (modes, N) tensor.

    The full complex signal is filtered (scipy casts complex input to real,
    dropping Q; the reference filters both quadratures, and so does the
    port). The state runs through :func:`affine_prefix_states` at any order.
    """
    Ad, Bd0, Bd1, C, D = _van_loan(b, a, fs)
    dt = _real_dtype(sig)
    rnd = (lambda v: float(np.float32(v))) if dt == torch.float32 else float
    u = _columns(sig.to(_complex_dtype(sig) if sig.is_complex() else dt))
    n = Ad.shape[0]
    bs = torch.stack([rnd(Bd0[i]) * u[:-1] + rnd(Bd1[i]) * u[1:] for i in range(n)], dim=1)
    S = affine_prefix_states(Ad.astype(np.float32) if dt == torch.float32 else Ad, bs)
    xs = torch.cat([torch.zeros_like(S[:1]), S])
    y = rnd(C[0]) * xs[:, 0]
    for i in range(1, n):
        y = y + rnd(C[i]) * xs[:, i]
    return _from_columns(y + rnd(D) * u, sig)


def _spectral_window(sig, fs, g_of_f):
    """sig filtered by the real window g(f) over the shifted spectrum (the gauss and exp types)."""
    N = sig.shape[1]
    f = torch.linspace(-fs / 2, fs / 2, N + 1, dtype=torch.float64, device=sig.device)[:-1]
    g = g_of_f(f).to(_real_dtype(sig))
    fsig = torch.fft.fftshift(torch.fft.fft(torch.fft.fftshift(sig, dim=-1), dim=-1), dim=-1) * g
    return torch.fft.fftshift(torch.fft.ifft(torch.fft.fftshift(fsig, dim=-1), dim=-1), dim=-1)


def filter_signal(signal, fs, cutoff, ftype="bessel", order=2, analog=False):
    """Low-pass filter emulating an analog component (reference core/filter.py:170-225).

    ``ftype`` "gauss" and "exp" are windows over the spectrum; "bessel" and
    "butter" are IIR filters designed by scipy on the host: digital
    second-order sections at ``fs`` by default, or with ``analog`` the
    continuous-time prototype (cutoff in Hz) simulated at ``fs``.
    """
    signal = torch.as_tensor(signal)
    sig = torch.atleast_2d(signal)
    if ftype == "gauss":
        w = cutoff / (2 * np.sqrt(2 * np.log(2)))
        out = _spectral_window(sig, fs, lambda f: torch.exp(-f ** 2 / (2 * w ** 2)))
    elif ftype == "exp":
        w = cutoff / (np.sqrt(2 * np.log(2) ** 2))

        def g_of_f(f):
            g = torch.exp(-torch.sqrt(f ** 2 / (2 * w ** 2)))
            return g / g.max()
        out = _spectral_window(sig, fs, g_of_f)
    elif analog:
        Wn = cutoff * 2 * np.pi
        if ftype == "bessel":
            b, a = scisig.bessel(order, Wn, 'low', norm='mag', analog=True, output='ba')
        elif ftype == "butter":
            b, a = scisig.butter(order, Wn, 'low', analog=True, output='ba')
        else:
            raise ValueError("unknown analog filter type %s" % ftype)
        out = _lsim(b, a, sig, fs)
    else:
        if ftype == "bessel":
            sos = scisig.bessel(order, cutoff, 'low', norm='mag', analog=False, output='sos',
                                fs=fs)
        elif ftype == "butter":
            sos = scisig.butter(order, cutoff, 'low', analog=False, output='sos', fs=fs)
        else:
            raise ValueError("unknown filter type %s" % ftype)
        out = _sosfilt(sos, sig)
    return out.flatten() if signal.dim() == 1 else out


# ---------------------------------------------------------------------------
# pulse shaping
# ---------------------------------------------------------------------------

def _rrcos_pulseshaping_freq(sig, fs, T, beta):
    """The root-raised-cosine filter applied in the spectrum (reference :300-307)."""
    sig = torch.as_tensor(sig)
    f = torch.fft.fftfreq(sig.shape[-1], dtype=torch.float64, device=sig.device) * fs
    nyq = rrcos_freq(f, beta, T)
    nyq = nyq / nyq.max()
    sig_f = torch.fft.fft(sig, dim=-1)
    return torch.fft.ifft(sig_f * nyq.to(_real_dtype(sig_f)), dim=-1)


def rrcos_pulseshaping(sig, fs, T, beta, taps=1001):
    """Root-raised-cosine filter of ``taps`` taps by FFT convolution (reference :310-320).

    The taps are the impulse response at the sample times of ``fs`` in
    float32, normalised to a peak of one, as the reference forms them (a
    filter design, made on the host and copied to the signal's device);
    with ``taps=None`` the filter is applied in the spectrum instead.
    """
    sig = torch.as_tensor(sig)
    if taps is None:
        return _rrcos_pulseshaping_freq(sig, fs, T, beta)
    t = np.linspace(0, taps, taps, endpoint=False)
    t -= t[(t.size - 1) // 2]
    t /= fs
    nqt = rrcos_time(t, beta, T)
    nqt = (nqt / nqt.max()).numpy().astype(
        np.float64 if _real_dtype(sig) == torch.float64 else np.float32)
    return fftconvolve_same(sig, to_device(nqt, sig.device))


def moving_average(sig, N=3):
    """Moving average of length N over the valid region (reference core/filter.py:323-336).

    out[..., l] = (sig[..., l] + ... + sig[..., l+N-1]) / N for l = 0, ...,
    len - N, on a real tensor of any leading shape. Summed directly, last
    term first, as the port's pilot CPE sums it (``phase_cuda.moving_average``):
    the reference forms the same average as a difference of cumulative sums,
    whose float32 rounding grows with the length of the row.
    """
    sig = torch.as_tensor(sig)
    N = int(N)
    if N < 1 or N > sig.shape[-1]:
        raise ValueError("moving average of %d over %d samples" % (N, sig.shape[-1]))
    return _window_mean(sig, N, sig.shape[-1] - N + 1)
