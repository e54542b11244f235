"""Signal objects over tensors (counterpart of ``qampy_tpu/signals.py``).

In the reference a signal is a JAX pytree (signals.py:123-160). Here it is
a plain class over a complex tensor: the samples, the sent symbols and the
coded alphabet are tensors on the signal's device; the rates, M, the Gray
encoding, the bits and a host copy of the alphabet are attributes. Every
array-like operation (indexing, arithmetic, ``replace``,
``recreate_from_np_array``) returns a new signal with the attributes
carried over, and ``np.asarray(sig)`` gives the samples on the host.

Constructors take ``device``: None is the card (``utils.resolve_device``),
``device="cpu"`` the CPU. The bit sources are numpy, so one seed gives the
reference's bits, and the symbols are mapped from them on the device. The
metrics read their result once a call; the phase drivers take the
alphabet's host copy and so read nothing back.

``Signal.resample`` shapes and resamples on the signal's device
(``core.resample.rrcos_resample``); ``save_to_file`` writes the host form
(``core.io.save_signal``).

Also here: the pilot frame layout (:func:`cal_pilot_idx`) and the Gray
mapping (:func:`generate_mapping`) that the pilot chain and the workload use.
"""
from __future__ import annotations

import fractions
import warnings

import numpy as np
import torch

from qampy_tpu_torch import helpers
from qampy_tpu_torch.core import sync
from qampy_tpu_torch.core.metrics import (cal_mi, decision_idx, estimate_snr,
                                          generate_bitmapping_mtx, make_decision,
                                          soft_l_value_demapper, soft_l_value_demapper_minmax)
from qampy_tpu_torch.prbs import make_prbs_extXOR
from qampy_tpu_torch.theory import (cal_scaling_factor_qam, cal_symbols_psk, cal_symbols_qam,
                                    gray_code_qam)
from qampy_tpu_torch.utils import as_tensor, resolve_device

DEFAULT_DTYPE = np.complex64


def cal_pilot_idx(frame_len, pilot_seq_len, pilot_ins_rat):
    """Frame layout (reference ``SignalWithPilots._cal_pilot_idx``, signals.py:1045-1057).

    A frame opens with ``pilot_seq_len`` pilot symbols; after it, every
    ``pilot_ins_rat``-th symbol is a phase pilot, starting with the first.
    Returns (idx, idx_dat, idx_pil): the symbol positions and the boolean
    payload and pilot masks.
    """
    idx = np.arange(frame_len)
    idx_pil_seq = idx < pilot_seq_len
    if pilot_ins_rat == 0 or pilot_ins_rat is None:
        idx_pil = idx_pil_seq
    else:
        if (frame_len - pilot_seq_len) % pilot_ins_rat != 0:
            raise ValueError("Frame without pilot sequence divided by pilot rate needs to be "
                             "an integer")
        idx_ph_pil = ((idx - pilot_seq_len) % pilot_ins_rat != 0) & (idx - pilot_seq_len > 0)
        idx_pil = ~idx_ph_pil
    idx_dat = ~idx_pil
    return idx, idx_dat, idx_pil


def generate_mapping(M, scale, dtype=np.complex64, symbols=None):
    """Gray-coded M-QAM mapping (reference ``SignalQAMGrayCoded._generate_mapping``, :479-493).

    Returns (coded_symbols, graycode, encoding): ``coded_symbols[i]`` is the
    symbol of coded index i, scaled by 1/``scale``, and ``encoding[i]`` its
    log2(M) bits, the binary of i with the most significant bit first.
    ``symbols`` and ``graycode`` of another alphabet (PSK) may replace the
    QAM ones when ``symbols`` is given as (points, graycode).
    """
    Nbits = int(np.log2(M))
    if symbols is None:
        points, graycode = cal_symbols_qam(M).astype(dtype), gray_code_qam(M)
        points /= scale
    else:
        points, graycode = symbols
    u = np.zeros_like(graycode)
    u[graycode] = np.arange(u.size)
    coded_symbols = points[u]
    encoding = ((np.arange(graycode.size)[:, None] >> np.arange(Nbits - 1, -1, -1)) & 1
                ).astype(bool)
    return coded_symbols, graycode, encoding


# ---------------------------------------------------------------------------
# bit sources (host numpy, as in the reference)
# ---------------------------------------------------------------------------

class RandomBits(np.ndarray):
    """Random bits of shape (nmodes, N) from ``RandomState(seed)`` (signals.py:49-64)."""

    def __new__(cls, N, nmodes=1, seed=None):
        R = np.random.RandomState(seed)
        obj = R.randint(0, high=2, size=(nmodes, N)).astype(bool).view(cls)
        obj._rand_state = R
        obj._seed = seed
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self._seed = getattr(obj, "_seed", None)
        self._rand_state = getattr(obj, "_rand_state", None)


class PRBSBits(np.ndarray):
    """PRBS bits of shape (nmodes, N), one LFSR order and seed per mode (signals.py:67-98)."""

    def __new__(cls, N, nmodes=1, seed=(None, None), order=(15, 23)):
        order = list(order)
        seed = list(seed)
        if len(order) < nmodes:
            warnings.warn("PRBS order not given for all modes, picking random orders and seeds")
            order_n, seed_n = [], []
            for i in range(nmodes):
                try:
                    order_n.append(order[i])
                    seed_n.append(seed[i])
                except IndexError:
                    o = int(np.random.choice([15, 23]))
                    order_n.append(o)
                    seed_n.append(int(np.random.randint(0, 2 ** o)))
            order, seed = order_n, seed_n
        bits = np.empty((nmodes, N), dtype=bool)
        for i in range(nmodes):
            bits[i][:] = make_prbs_extXOR(order[i], N, seed[i])
        obj = bits.view(cls)
        obj._order = order
        obj._seed = seed
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self._seed = getattr(obj, "_seed", None)
        self._order = getattr(obj, "_order", None)


def _on(x, device):
    """``x`` (a tensor, a signal or a host array) as a tensor on ``device``."""
    return as_tensor(x.samples if isinstance(x, Signal) else x, device)


def _modulate(bits, encoding_weights, coded, nbits):
    """Bits (nmodes, >= Nsym*nbits) to symbols on the bits' device: MSB-first index, a gather."""
    nsym = bits.shape[-1] // nbits
    b = bits[..., :nsym * nbits].reshape(bits.shape[:-1] + (nsym, nbits)).to(torch.int64)
    return coded[(b * encoding_weights).sum(-1)]


# ---------------------------------------------------------------------------
# base signal
# ---------------------------------------------------------------------------

class Signal:
    """Base signal: (nmodes, N) samples, the sent symbols and metadata (signals.py:166-445).

    The object behaves like its samples (indexing, arithmetic,
    ``np.asarray``), and every such operation returns a new signal with
    the attributes carried over.
    """

    def __init__(self, samples, symbols=None, coded_symbols=None, fb=1, fs=None, M=None,
                 device=None):
        dev = samples.device if torch.is_tensor(samples) and device is None \
            else resolve_device(device)
        self.samples = _on(samples, dev)
        self._symbols = self.samples if symbols is None else _on(symbols, dev)
        self._set_alphabet(None if coded_symbols is None else np.asarray(
            coded_symbols.cpu() if torch.is_tensor(coded_symbols) else coded_symbols))
        self._fb = fb
        self._fs = fb if fs is None else fs
        self._M = M

    def _set_alphabet(self, coded_host):
        """The coded alphabet: a host copy (``coded_host``) and its tensor on the device."""
        self._coded_host = coded_host
        self._coded_symbols = None if coded_host is None else torch.as_tensor(
            coded_host, device=self.samples.device)

    # -- replace/copy ------------------------------------------------------
    def replace(self, **kwargs):
        """A copy with the given fields replaced (``samples``, ``symbols`` or ``_symbols``, ...)."""
        obj = object.__new__(type(self))
        obj.__dict__.update(self.__dict__)
        for k, v in kwargs.items():
            key = k if k in obj.__dict__ else "_" + k
            if key not in obj.__dict__:
                raise AttributeError("%s has no field %s" % (type(self).__name__, k))
            if key == "_coded_symbols":
                obj._set_alphabet(None if v is None else np.asarray(
                    v.cpu() if torch.is_tensor(v) else v))
            else:
                obj.__dict__[key] = v
        return obj

    def recreate_from_np_array(self, arr, **kwargs):
        """New samples with the same metadata (signals.py:199-203); ``fb`` alone keeps ``os``."""
        if "fb" in kwargs and "fs" not in kwargs:
            kwargs["fs"] = self.os * kwargs["fb"]
        return self.replace(samples=_on(arr, self.samples.device), **kwargs)

    def to(self, device):
        """The signal with its tensors on ``device``."""
        obj = self.replace()
        for k, v in self.__dict__.items():
            if torch.is_tensor(v):
                obj.__dict__[k] = v.to(device)
            elif isinstance(v, Signal):
                obj.__dict__[k] = v.to(device)
        return obj

    # -- array protocol ----------------------------------------------------
    @property
    def shape(self):
        return tuple(self.samples.shape)

    @property
    def ndim(self):
        return self.samples.dim()

    @property
    def dtype(self):
        return self.samples.dtype

    @property
    def device(self):
        return self.samples.device

    def __len__(self):
        return self.samples.shape[0]

    def __array__(self, dtype=None, copy=None):
        a = self.samples.detach().cpu().numpy()
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, key):
        return self.replace(samples=self.samples[key])

    def __repr__(self):
        return "%s(shape=%s, dtype=%s, device=%s, fb=%s, fs=%s, M=%s)" % (
            type(self).__name__, self.shape, self.dtype, self.device, self._fb, self._fs, self._M)

    def _binop(self, other, op):
        o = other.samples if isinstance(other, Signal) else other
        return self.replace(samples=op(self.samples, o))

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binop(other, lambda a, b: b / a)

    def __neg__(self):
        return self.replace(samples=-self.samples)

    def conj(self):
        return self.replace(samples=torch.conj(self.samples).resolve_conj())

    @property
    def real(self):
        return self.samples.real

    @property
    def imag(self):
        return self.samples.imag

    def flatten(self):
        return self.samples.flatten()

    def copy(self):
        return self.replace()

    # -- metadata ----------------------------------------------------------
    @property
    def M(self):
        return self._M

    @property
    def fb(self):
        return self._fb

    @property
    def fs(self):
        return self._fs

    @property
    def os(self):
        return int(round(self._fs / self._fb))

    @property
    def symbols(self):
        return self._symbols

    @property
    def coded_symbols(self):
        return self._coded_symbols

    @property
    def coded_symbols_host(self):
        """The coded alphabet on the host, which the phase drivers classify without a read-back."""
        return self._coded_host

    # -- resampling and saving ----------------------------------------------
    def resample(self, fnew, **kwargs):
        """RRC-filtered rational resampling to the rate ``fnew`` (signals.py:307-314).

        ``kwargs`` go to ``core.resample.rrcos_resample`` (``beta``,
        ``taps``, ``renormalise``; ``Ts`` defaults to 1/fb). A rate within
        ``np.isclose`` of the present one returns a copy.
        """
        from qampy_tpu_torch.core import resample as _resample
        if np.isclose(fnew / self._fs, 1):
            return self.replace()
        Ts = kwargs.pop("Ts", 1 / self._fb)
        new = _resample.rrcos_resample(self.samples, self._fs, fnew, Ts=Ts, **kwargs)
        return self.replace(samples=new.to(self.dtype), _fs=fnew)

    def save_to_file(self, fn, lvl=5):
        """Save the signal's host form as a zlib-compressed pickle (``core.io.save_signal``)."""
        from qampy_tpu_torch.core.io import save_signal
        save_signal(fn, self, lvl)

    # -- sync helpers ------------------------------------------------------
    def _signal_present(self, signal):
        if signal is None:
            return torch.atleast_2d(self.samples)
        return torch.atleast_2d(_on(signal, self.samples.device))

    def _sync_and_adjust(self, tx, rx, synced=False):
        """Greedy mode matching and length adjustment (signals.py:324-369).

        Every (rx mode, tx mode) pair is correlated in one batched FFT; the
        pairs' peaks, offsets and quarter turns are read to the host at
        once, the reference's greedy assignment (strictly larger peak wins,
        in its order) pairs the modes there, and each rx mode's tx is
        turned, rolled and cut or extended on the device.
        """
        if synced:
            return self._adjust_only(tx, rx)
        tx = torch.atleast_2d(tx)
        rx = torch.atleast_2d(rx)
        txmodes, rxmodes = tx.shape[0], rx.shape[0]
        ac = sync._xcorr_full(1. * rx[:, None, :], 1. * tx[None, :, :])
        offset, turns, score = sync.correlation_peaks(ac, tx.shape[-1])
        table = torch.stack([score.double(), offset.double(), turns.double()], -1).cpu().numpy()
        idxx = list(range(max(txmodes, rxmodes)))
        tx_out, rx_out = [], []
        for j in range(rxmodes):
            acm, best_i = -100., None
            for i in idxx:
                act = float(table[j, i % txmodes, 0])
                if act > acm:
                    best_i, acm = i, act
            idxx.remove(best_i)
            _, off, turn = table[j, best_i % txmodes]
            t, r = sync.adjust_synced(sync.quarter_turn(tx[best_i % txmodes], turn), rx[j],
                                      int(off), "tx")
            tx_out.append(t)
            rx_out.append(r)
        return torch.stack(tx_out), torch.stack(rx_out)

    def _adjust_only(self, tx, rx, which="tx"):
        """Length adjustment without sync (signals.py:371-390)."""
        tx = torch.atleast_2d(tx)
        rx = torch.atleast_2d(rx)
        if tx.shape[0] > rx.shape[0]:
            tx = tx[:rx.shape[0]]
        if tx.shape == rx.shape:
            return tx, rx
        if which == "tx":
            method = "truncate" if tx.shape[1] > rx.shape[1] else "extend"
        elif which == "rx":
            method = "extend" if tx.shape[1] > rx.shape[1] else "truncate"
        else:
            raise ValueError("which has to be either 'tx' or 'rx'")
        pairs = [sync.adjust_data_length(tx[i], rx[i], method) for i in range(tx.shape[0])]
        return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])

    # -- decisions & metrics ----------------------------------------------
    def make_decision(self, signal=None, verbose=False):
        """Nearest-point decisions (signals.py:393-399); with ``verbose`` (syms, dist, idx)."""
        outsyms, dist, idx = make_decision(self._signal_present(signal), self.coded_symbols)
        if verbose:
            return outsyms, dist, idx
        return outsyms

    def cal_ser(self, signal_rx=None, synced=False, verbose=False):
        """Symbol error rate per mode, a (nmodes,) tensor (signals.py:401-410)."""
        signal_rx = self._signal_present(signal_rx)
        symbols_tx, signal_rx = self._sync_and_adjust(self.symbols, signal_rx, synced)
        data_demod = self.make_decision(signal_rx)
        errs = data_demod - symbols_tx
        ser = torch.count_nonzero(errs, dim=-1) / data_demod.shape[1]
        if verbose:
            return ser, errs, symbols_tx
        return ser

    def cal_evm(self, signal_rx=None, synced=False, blind=False):
        """RMS error vector magnitude per mode (signals.py:412-419)."""
        signal_rx = self._signal_present(signal_rx)
        if blind:
            symbols_tx = self.make_decision(signal_rx)
        else:
            symbols_tx, signal_rx = self._sync_and_adjust(self.symbols, signal_rx, synced)
        return torch.sqrt(torch.mean(helpers.cabssquared(symbols_tx - signal_rx), dim=-1))

    def est_snr(self, signal_rx=None, synced=False, symbols_tx=None, verbose=False):
        """Data-aided SNR per mode, linear (signals.py:421-431); ``verbose``: (snr, S0, N0)."""
        signal_rx = self._signal_present(signal_rx)
        if symbols_tx is None:
            symbols_tx = self.symbols
        symbols_tx, signal_rx = self._sync_and_adjust(_on(symbols_tx, signal_rx.device),
                                                      signal_rx, synced)
        snr, s0, n0 = estimate_snr(signal_rx, symbols_tx, self.coded_symbols)
        if verbose:
            return snr, s0, n0
        return snr

    def normalize_and_center(self, symbol_based=False, synced=False):
        """A normalised and centred copy (signals.py:433-442)."""
        if not symbol_based:
            return self.replace(samples=helpers.normalise_and_center(self.samples))
        s = self.samples - torch.mean(self.samples, dim=-1, keepdim=True)
        p = self.est_snr(synced=synced, verbose=True)[1]
        return self.replace(samples=s / torch.sqrt(p)[:, None].to(s.dtype))


def samples_of(sig):
    """The samples of a signal object, or the argument as a tensor (the adapters' input)."""
    return sig.samples if isinstance(sig, Signal) else torch.as_tensor(sig)


def rewrap(sig, arr):
    """``arr`` as a copy of the signal ``sig`` in its dtype, or ``arr`` itself where ``sig``
    is no signal object (the adapters' output)."""
    return sig.replace(samples=arr.to(sig.dtype)) if isinstance(sig, Signal) else arr


# ---------------------------------------------------------------------------
# gray-coded QAM
# ---------------------------------------------------------------------------

class SignalQAMGrayCoded(Signal):
    """Gray-coded square or cross M-QAM signal (signals.py:452-648).

    ``bitclass(N log2 M, nmodes=nmodes, **kwargs)`` gives the bits on the
    host (``RandomBits``: ``seed=``; ``PRBSBits``: ``order=``, ``seed=``);
    they are mapped to symbols on ``device``.
    """

    def __init__(self, M, N, nmodes=1, fb=1, bitclass=RandomBits, dtype=DEFAULT_DTYPE,
                 device=None, **kwargs):
        bits = bitclass(int(N * np.log2(M)), nmodes=nmodes, **kwargs)
        self._init_from_bits(M, np.asarray(bits), fb, dtype, resolve_device(device))

    def _init_from_bits(self, M, bits, fb, dtype, dev, scale=None):
        """Map host ``bits`` with this class's mapping and set every field."""
        if scale is None:
            scale = np.sqrt(cal_scaling_factor_qam(M))
        coded, graycode, encoding, bitmap_mtx = self._generate_mapping(M, scale, dtype=dtype)
        self._M = M
        self._fb = fb
        self._fs = fb
        self._code = np.asarray(graycode)
        self._encoding = np.asarray(encoding)
        self._bits = np.asarray(bits)
        self.samples = _modulate(torch.as_tensor(self._bits, device=dev),
                                 self._weights(dev), torch.as_tensor(coded, device=dev),
                                 self.Nbits)
        self._symbols = self.samples
        self._set_alphabet(coded)
        self._bitmap_mtx = torch.as_tensor(bitmap_mtx, device=dev)

    def _weights(self, dev):
        return 2 ** torch.arange(self.Nbits - 1, -1, -1, device=dev)

    # -- mapping construction (host-side, static) -------------------------
    @classmethod
    def _generate_mapping(cls, M, scale, dtype=DEFAULT_DTYPE):
        """Constellation, Gray code, bit encoding and bit map (signals.py:478-493)."""
        coded, graycode, encoding = generate_mapping(M, scale, dtype)
        bitmap_mtx = generate_bitmapping_mtx(
            coded, cls._demodulate_idx(np.arange(graycode.size), encoding), M, dtype=dtype)
        return coded, graycode, encoding, bitmap_mtx

    @staticmethod
    def _demodulate_idx(symbol_idx, encoding):
        """Symbol indices to bits, host numpy (signals.py:495-502)."""
        symbol_idx = np.asarray(symbol_idx)
        bits = np.asarray(encoding)[symbol_idx]
        if symbol_idx.ndim > 1:
            return bits.reshape(symbol_idx.shape[0], -1)
        return bits.flatten()

    @staticmethod
    def _modulate(data, encoding, coded_symbols, dtype=DEFAULT_DTYPE):
        """Bits to symbols, host numpy (signals.py:504-514)."""
        data = np.atleast_2d(np.asarray(data, dtype=bool))
        M = np.asarray(coded_symbols).shape[0]
        bitspsym = int(np.log2(M))
        Nsym = data.shape[1] // bitspsym
        cov = 2 ** np.arange(bitspsym - 1, -1, -1)
        idx = data[:, :Nsym * bitspsym].reshape(data.shape[0], Nsym, bitspsym) @ cov
        return np.asarray(coded_symbols)[idx].astype(dtype)

    # -- alternative constructors -----------------------------------------
    @classmethod
    def from_symbol_array(cls, symbs, M=None, fb=1, dtype=None, device=None):
        """A signal of the decisions on ``symbs`` (signals.py:517-544)."""
        dev = symbs.device if torch.is_tensor(symbs) and device is None else resolve_device(device)
        symbs = torch.atleast_2d(_on(symbs, dev))
        host = symbs.cpu().numpy()
        if M is None:
            warnings.warn("no M given, estimating from unique symbols, this can cause errors")
            M = np.unique(host).shape[0]
        if dtype is None:
            dtype = host.dtype
        P = (abs(np.unique(host)) ** 2).mean()
        if not np.isclose(P, 1):
            warnings.warn("Power of symbols is not normalized to 1, this might cause issues later")
        scale = np.sqrt(cal_scaling_factor_qam(M)) / np.sqrt(P)
        coded, _, encoding, _ = cls._generate_mapping(M, scale, dtype=dtype)
        idx = decision_idx(symbs, torch.as_tensor(coded, device=dev)).cpu().numpy()
        obj = object.__new__(cls)
        obj._init_from_bits(M, cls._demodulate_idx(idx, encoding), fb, dtype, dev, scale)
        return obj

    @classmethod
    def from_bit_array(cls, bits, M, fb=1, dtype=DEFAULT_DTYPE, device=None):
        """A signal of the given bits (signals.py:546-568); a length not divisible is cut."""
        arr = np.atleast_2d(np.asarray(bits))
        nbits = int(np.log2(M))
        if arr.shape[1] % nbits > 0:
            warnings.warn("Length of bits not divisible by log2(M), truncating")
            arr = arr[:, : arr.shape[1] // nbits * nbits]
        obj = object.__new__(cls)
        obj._init_from_bits(M, arr, fb, dtype, resolve_device(device))
        return obj

    # -- properties --------------------------------------------------------
    @property
    def bits(self):
        return self._bits

    @property
    def bitmap_mtx(self):
        return self._bitmap_mtx

    @property
    def Nbits(self):
        return int(np.log2(self._M))

    # -- modulate / demodulate --------------------------------------------
    def modulate(self, data):
        """Bits (a host array or tensor) to symbols with this mapping, on the signal's device."""
        dev = self.samples.device
        return _modulate(torch.atleast_2d(_on(data, dev)), self._weights(dev),
                         self._coded_symbols, self.Nbits)

    def demodulate(self, symbols):
        """Symbols (or integer symbol indices) to bits: a bool tensor on the signal's device.

        Reference signals.py:589-595, which returns them on the host.
        """
        s = _on(symbols, self.samples.device)
        idx = s if not (s.is_complex() or s.is_floating_point()) else decision_idx(
            s, self._coded_symbols)
        bits = torch.as_tensor(self._encoding, device=s.device)[idx.long()]
        if idx.dim() > 1:
            return bits.reshape(idx.shape[0], -1)
        return bits.flatten()

    # -- bit-level metrics -------------------------------------------------
    def cal_ber(self, signal_rx=None, synced=False, verbose=False):
        """Bit error rate per mode, a (nmodes,) float64 tensor (signals.py:598-608)."""
        signal_rx = self._signal_present(signal_rx)
        symbols_tx, signal_rx = self._sync_and_adjust(self.symbols, signal_rx, synced)
        bits_demod = self.demodulate(signal_rx)
        tx_synced = self.demodulate(symbols_tx)
        errs = tx_synced ^ bits_demod
        ber = torch.count_nonzero(errs, dim=-1).double() / bits_demod.shape[1]
        if verbose:
            return ber, errs, tx_synced
        return ber

    def cal_gmi(self, signal_rx=None, synced=False, snr=None, llr_minmax=False):
        """Generalised mutual information per mode (signals.py:610-630): numpy (gmi, gmi_per_bit).

        The L-values come from the chunked soft demapper on the device, the
        bitwise sums in float64 there; one read at the end.
        """
        signal_rx = self._signal_present(signal_rx)
        nmodes = signal_rx.shape[0]
        tx, rx = self._sync_and_adjust(self.symbols, signal_rx, synced)
        if snr is None:
            snr = self.est_snr(rx, synced=True, symbols_tx=tx)
        else:
            snr = np.atleast_1d(snr)
            snr = np.ones(nmodes) * 10 ** (snr / 10) if snr.size != nmodes else 10 ** (snr / 10)
            snr = torch.as_tensor(snr.astype(np.float32), device=rx.device)
        bits = self.demodulate(tx).reshape(nmodes, -1, self.Nbits)
        demapper = soft_l_value_demapper_minmax if llr_minmax else soft_l_value_demapper
        per_bit = []
        for mode in range(nmodes):
            lv = demapper(rx[mode], snr[mode], self._bitmap_mtx).double()
            sgn = 1.0 - 2.0 * bits[mode].double()                      # (-1) ** bit
            per_bit.append(1 - torch.mean(torch.log2(1 + torch.exp(sgn * lv)), dim=0))
        gmi_per_bit = torch.stack(per_bit).cpu().numpy()
        return np.sum(gmi_per_bit, axis=-1), gmi_per_bit

    def cal_mi(self, signal_rx=None, synced=False, snr=None, fast=True):
        """Mutual information per mode (signals.py:632-648), numpy."""
        signal_rx = self._signal_present(signal_rx)
        nmodes = signal_rx.shape[0]
        tx, rx = self._sync_and_adjust(self.symbols, signal_rx, synced)
        if snr is None:
            N0 = 1 / self.est_snr(rx, synced=True, symbols_tx=tx).cpu().numpy()
        else:
            snr = np.atleast_1d(snr)
            N0 = np.ones(nmodes) * 10 ** (-snr / 10) if snr.size != nmodes else 10 ** (-snr / 10)
        return np.array([float(cal_mi(rx[m], tx[m], self._coded_symbols, float(N0[m]), fast))
                         for m in range(nmodes)])


class SignalPSKGrayCoded(SignalQAMGrayCoded):
    """Gray-coded M-PSK signal (signals.py:651-668)."""

    @classmethod
    def _generate_mapping(cls, M, scale, dtype=DEFAULT_DTYPE):
        graycode = np.asarray([v ^ (v >> 1) for v in range(M)])
        coded, graycode, encoding = generate_mapping(
            M, scale, dtype, symbols=(cal_symbols_psk(M).astype(dtype), graycode))
        bitmap_mtx = generate_bitmapping_mtx(
            coded, cls._demodulate_idx(np.arange(graycode.size), encoding), M, dtype=dtype)
        return coded, graycode, encoding, bitmap_mtx


class QPSKfromBERT(SignalQAMGrayCoded):
    """QPSK from BERT-style delayed PRBS I and Q ports (signals.py:671-699)."""

    def __init__(self, N, nmodes=1, fb=1, prbsorders=((15,), (15,)), prbsshifts=(0, 0),
                 prbsinvert=(False, False), dtype=DEFAULT_DTYPE, device=None):
        bitsI = np.roll(np.asarray(PRBSBits(N, nmodes=nmodes, order=prbsorders[0])),
                        prbsshifts[0], axis=1)
        bitsQ = np.roll(np.asarray(PRBSBits(N, nmodes=nmodes, order=prbsorders[1])),
                        prbsshifts[1], axis=1)
        if prbsinvert[0]:
            bitsI = ~bitsI
        if prbsinvert[1]:
            bitsQ = ~bitsQ
        bits = np.zeros((nmodes, 2 * N), dtype=bool)
        bits[:, ::2] = bitsI
        bits[:, 1::2] = bitsQ
        self._init_from_bits(4, bits, fb, dtype, resolve_device(device))


class SymbolOnlySignal(Signal):
    """Signal over an arbitrary alphabet without a bit mapping (signals.py:702-746)."""

    def __init__(self, M, N, symbols, nmodes=1, fb=1, dtype=None, seed=None, device=None):
        symbols = np.asarray(symbols)
        coded = symbols if dtype is None else symbols.astype(dtype)
        samples = np.random.RandomState(seed).choice(coded, (nmodes, N))
        super().__init__(samples, coded_symbols=coded, fb=fb, M=M, device=device)

    @classmethod
    def from_symbol_array(cls, symbs, coded_symbols=None, fb=1, device=None):
        """A signal of the decisions on ``symbs`` over ``coded_symbols`` (signals.py:721-734)."""
        dev = symbs.device if torch.is_tensor(symbs) and device is None else resolve_device(device)
        symbs = torch.atleast_2d(_on(symbs, dev))
        if coded_symbols is None:
            coded_symbols = np.unique(symbs.cpu().numpy()).flatten()
        coded = np.asarray(coded_symbols)
        det, _, _ = make_decision(symbs, torch.as_tensor(coded, device=dev))
        obj = object.__new__(cls)
        Signal.__init__(obj, det, coded_symbols=coded, fb=fb, M=coded.size, device=dev)
        return obj

    def cal_ber(self, *args, **kwargs):
        raise NotImplementedError("SymbolOnlySignal does not have bits; BER not possible")

    def cal_gmi(self, *args, **kwargs):
        raise NotImplementedError("SymbolOnlySignal does not have bits; GMI not possible")

    def demodulate(self, *args, **kwargs):
        raise NotImplementedError("SymbolOnlySignal does not have bits")

    def modulate(self, *args, **kwargs):
        raise NotImplementedError("SymbolOnlySignal does not have bits")


class ResampledQAM(SignalQAMGrayCoded):
    """Gray-coded QAM made at the symbol rate and resampled to ``fs`` (signals.py:749-766)."""

    def __init__(self, M, N, fb=1, fs=1, resamplekwargs={"beta": 0.1}, **kwargs):
        super().__init__(M, N, fb=fb, **kwargs)
        if not np.isclose(fs / fb, 1):
            from qampy_tpu_torch.core import resample as _resample
            new = _resample.rrcos_resample(self.samples, fb, fs, Ts=1 / fb, **resamplekwargs)
            self.samples = new.to(self._symbols.dtype)
        self._fs = fs

    @classmethod
    def from_symbol_array(cls, array, fs, **kwargs):
        """A signal object resampled to ``fs`` (``array.resample``); anything else raises."""
        if not isinstance(array, Signal):
            raise ValueError("from_symbol_array requires a Signal object")
        return array.resample(fs, **kwargs)


# ---------------------------------------------------------------------------
# time-domain hybrid QAM
# ---------------------------------------------------------------------------

class TDHQAMSymbols(Signal):
    """Time-domain hybrid QAM interleaving two QAM orders (signals.py:773-930)."""

    def __init__(self, M, N, fr=0.5, power_method="dist", M1class=SignalQAMGrayCoded,
                 M2class=SignalQAMGrayCoded, device=None, **kwargs):
        M1, M2 = M
        f_M, f_M1, f_M2 = self._cal_fractions(fr)
        frms = N // f_M
        if N % f_M > 0:
            N = f_M * frms
            warnings.warn("overall pattern not divisible by frame count, truncating to %d symbols"
                          % N)
        syms1 = M1class(M1, frms * f_M1, device=device, **kwargs)
        syms2 = M2class(M2, frms * f_M2, device=device, **kwargs)
        self._interleave(syms1, syms2, fr, power_method, N)

    def _interleave(self, syms1, syms2, fr, power_method, N):
        f_M, f_M1, _ = self._cal_fractions(fr)
        scale = self.calculate_power_ratio(syms1.coded_symbols_host, syms2.coded_symbols_host,
                                           power_method)
        s1 = syms1.samples
        out = torch.zeros((s1.shape[0], N), dtype=s1.dtype, device=s1.device)
        _, idx1, idx2 = self._cal_symbol_idx(N, f_M, f_M1)
        out[:, torch.as_tensor(idx1, device=s1.device)] = s1
        out[:, torch.as_tensor(idx2, device=s1.device)] = syms2.samples / np.sqrt(scale)
        self.samples = out
        self._symbols = out
        self._set_alphabet(None)
        self._symbols_M1 = syms1
        self._symbols_M2 = syms2
        self._powratio = scale
        self._fr = fr
        self._fb = syms1.fb
        self._fs = syms1.fb
        self._M = (syms1.M, syms2.M)
        self._power_method = power_method

    @staticmethod
    def _cal_fractions(fr):
        ratn = fractions.Fraction(fr).limit_denominator()
        return ratn.denominator, ratn.denominator - ratn.numerator, ratn.numerator

    @staticmethod
    def _cal_symbol_idx(N, f_M, f_M1):
        idx = np.arange(N)
        return idx, idx % f_M < f_M1, idx % f_M >= f_M1

    @staticmethod
    def calculate_power_ratio(M1symbols, M2symbols, method="dist"):
        """Power ratio that spaces both orders' points equally (signals.py:828-835)."""
        if method != "dist":
            raise NotImplementedError("Only 'dist' method is currently implemented")
        d1 = np.min(abs(np.diff(np.unique(np.asarray(M1symbols)))))
        d2 = np.min(abs(np.diff(np.unique(np.asarray(M2symbols)))))
        return (d2 / d1) ** 2

    @property
    def powratio(self):
        return self._powratio

    @property
    def fr(self):
        return self._fr

    @property
    def f_M(self):
        return self._cal_fractions(self._fr)[0]

    @property
    def f_M1(self):
        return self._cal_fractions(self._fr)[1]

    @property
    def f_M2(self):
        return self._cal_fractions(self._fr)[2]

    @property
    def symbols_M1(self):
        return self._symbols_M1

    @property
    def symbols_M2(self):
        return self._symbols_M2

    @classmethod
    def from_symbol_arrays(cls, syms_M1, syms_M2, fr, power_method="dist"):
        """Interleave two symbol signals, M2 scaled to equal spacing (signals.py:865-901)."""
        if syms_M1.ndim != 2 or syms_M2.ndim != 2:
            raise ValueError("input needs to have two dimensions")
        if syms_M1.shape[0] != syms_M2.shape[0]:
            raise ValueError("Number of modes must be the same")
        f_M, f_M1, f_M2 = cls._cal_fractions(fr)
        N1, N2 = syms_M1.shape[1], syms_M2.shape[1]
        nframes = (N1 + N2) // f_M
        if N1 != nframes * f_M1 or N2 != nframes * f_M2:
            raise ValueError("symbol array lengths do not form whole TDHQAM frames for fr=%s" % fr)
        obj = object.__new__(cls)
        obj._interleave(syms_M1, syms_M2, fr, power_method, N1 + N2)
        return obj

    def _divide_signal_frame(self, signal):
        """Split a received TDHQAM signal into its M1 and M2 streams (signals.py:903-930).

        The frame alignment maximises the mean amplitude of the subframe of
        the larger order; host numpy, as in the reference.
        """
        sig_np = np.atleast_2d(np.asarray(signal.cpu() if torch.is_tensor(signal) else signal))
        f_M, f_M1, _ = self._cal_fractions(self._fr)
        if self._power_method != "dist":
            raise NotImplementedError("currently only 'dist' method is implemented")
        idx = np.arange(sig_np.shape[1])
        idx1, idx2 = idx[idx % f_M < f_M1], idx[idx % f_M >= f_M1]
        idx_m = idx1 if self.M[0] > self.M[1] else idx2
        s1_rows, s2_rows = [], []
        for row in sig_np:
            pows = [np.mean(np.abs(row[(idx_m + j) % idx.max()])) for j in range(f_M)]
            imax = int(np.argmax(pows))
            s1_rows.append(row[(idx1 + imax) % idx.max()])
            s2_rows.append(row[(idx2 + imax) % idx.max()])
        dev = self.samples.device
        return (self._symbols_M1.from_symbol_array(np.stack(s1_rows), fb=self.fb, M=self.M[0],
                                                   device=dev),
                self._symbols_M2.from_symbol_array(np.stack(s2_rows), fb=self.fb, M=self.M[1],
                                                   device=dev))


# ---------------------------------------------------------------------------
# pilot signals
# ---------------------------------------------------------------------------

class SignalWithPilots(Signal):
    """A pilot sequence, periodic phase pilots and the payload in frames (signals.py:937-1243).

    The payload and the pilots are signal objects of their own, so the
    frame-level metrics delegate to them.
    """

    def __init__(self, M, frame_len, pilot_seq_len, pilot_ins_rat, nframes=1, pilot_scale=1,
                 Mpilots=4, dataclass=SignalQAMGrayCoded, nmodes=1, dtype=DEFAULT_DTYPE,
                 device=None, **kwargs):
        _, idx_dat, idx_pil = cal_pilot_idx(frame_len, pilot_seq_len, pilot_ins_rat)
        dev = resolve_device(device)
        npil, ndat = int(np.count_nonzero(idx_pil)), int(np.count_nonzero(idx_dat))
        pilots = SignalQAMGrayCoded(Mpilots, npil, nmodes=nmodes, dtype=dtype, device=dev,
                                    **kwargs) * pilot_scale
        symbs = dataclass(M, ndat, nmodes=nmodes, dtype=dtype, device=dev, **kwargs)
        self._frame_samples(symbs.samples, pilots.samples, idx_dat, nframes)
        self._fb = kwargs.pop("fb", symbs.fb)
        self._fs = kwargs.pop("fs", symbs.fb)
        self._set_frame(frame_len, pilot_seq_len, pilot_ins_rat, symbs, pilots, idx_dat,
                        pilot_scale)

    def _frame_samples(self, payload, pilots, idx_dat, nframes):
        """One frame of pilots at ~idx_dat and payload at idx_dat, tiled ``nframes`` times."""
        dev = payload.device
        out = torch.empty((payload.shape[0], idx_dat.size), dtype=payload.dtype, device=dev)
        out[:, torch.as_tensor(~idx_dat, device=dev)] = pilots[:, :int(np.count_nonzero(~idx_dat))]
        out[:, torch.as_tensor(idx_dat, device=dev)] = payload[:, :int(np.count_nonzero(idx_dat))]
        self.samples = out.repeat(1, nframes)
        self._symbols = self.samples
        self._set_alphabet(None)
        self._M = None

    def _set_frame(self, frame_len, pilot_seq_len, pilot_ins_rat, symbs, pilots, idx_dat,
                   pilot_scale):
        self._frame_len = frame_len
        self._pilot_seq_len = pilot_seq_len
        self._pilot_ins_rat = pilot_ins_rat
        self._symbols_obj = symbs
        self._pilots_obj = pilots
        self._idx_dat = idx_dat
        self._pilot_scale = pilot_scale
        self._shiftfctrs = None
        self._synctaps = None
        self._foe = None

    @classmethod
    def from_symbol_array(cls, payload, frame_len, pilot_seq_len, pilot_ins_rat, pilots=None,
                          pilot_idx=None, nframes=1, pilot_scale=1, payload_is_frame=False,
                          pilot_class=None, pilot_kwargs=None, payload_class=None,
                          payload_kwargs=None, device=None, **kwargs):
        """A pilot signal around an existing payload (signals.py:979-1042).

        Pilots are generated (``pilot_class(**pilot_kwargs)``) or given;
        ``pilot_idx`` places them explicitly; with ``payload_is_frame`` the
        payload is a whole frame whose pilot positions are taken as pilots.
        """
        pilot_class = pilot_class or SignalQAMGrayCoded
        payload_class = payload_class or SignalQAMGrayCoded
        pilot_kwargs = {"M": 4} if pilot_kwargs is None else dict(pilot_kwargs)
        payload_kwargs = {} if payload_kwargs is None else dict(payload_kwargs)
        dev = payload.device if isinstance(payload, Signal) and device is None \
            else resolve_device(device)
        payload_arr = np.asarray(payload)
        nmodes, N = payload_arr.shape
        if pilot_idx is None:
            _, idx_dat, idx_pil = cal_pilot_idx(frame_len, pilot_seq_len, pilot_ins_rat)
        else:
            idx_pil = np.zeros(frame_len, dtype=bool)
            idx_pil[np.asarray(pilot_idx)] = True
            idx_dat = ~idx_pil
        Ndat = int(np.count_nonzero(idx_dat))
        if Ndat > N:
            raise ValueError("data frame is too short for the given frame length")
        if "M" in kwargs:
            if "M" in payload_kwargs:
                raise ValueError("M can not be given for both payload and signal")
            payload_kwargs["M"] = kwargs.pop("M")
        if payload_is_frame:
            pilots = pilot_class.from_symbol_array(payload_arr[:, idx_pil], device=dev,
                                                   **pilot_kwargs)
            payload = payload_class.from_symbol_array(payload_arr[:, idx_dat], device=dev,
                                                      **payload_kwargs)
            payload_arr = np.asarray(payload)
        if pilots is None:
            pilots = pilot_class(pilot_kwargs["M"], int(np.count_nonzero(idx_pil)), nmodes=nmodes,
                                 dtype=payload_arr.dtype, device=dev) / np.sqrt(pilot_scale)
        else:
            parr = np.atleast_2d(np.asarray(pilots))
            if parr.shape[0] == 1 and nmodes > 1:
                parr = np.vstack([parr] * nmodes)
            if not isinstance(pilots, Signal):
                pilots = pilot_class.from_symbol_array(parr, device=dev, **pilot_kwargs)
            elif parr.shape[0] != np.asarray(pilots).shape[0]:
                pilots = pilots.replace(samples=_on(parr, dev))
        if not isinstance(payload, Signal):
            payload = payload_class.from_symbol_array(payload_arr, device=dev, **payload_kwargs)
        obj = object.__new__(cls)
        trunc = _on(payload_arr[:, :Ndat], dev)
        obj._frame_samples(trunc, pilots.samples.to(dev), idx_dat, nframes)
        obj._fb = payload.fb
        obj._fs = payload.fb
        obj._set_frame(frame_len, pilot_seq_len, pilot_ins_rat,
                       payload.replace(samples=trunc, _symbols=trunc), pilots, idx_dat,
                       pilot_scale)
        return obj

    _cal_pilot_idx = staticmethod(cal_pilot_idx)

    # -- properties --------------------------------------------------------
    @property
    def M(self):
        return self._symbols_obj.M

    @property
    def Mpilots(self):
        return self._pilots_obj.M

    @property
    def pilot_scale(self):
        return self._pilot_scale

    @property
    def pilots(self):
        return self._pilots_obj.samples

    @property
    def pilot_seq(self):
        return self._pilots_obj.samples[:, :self._pilot_seq_len]

    @property
    def ph_pilots(self):
        return self._pilots_obj.samples[:, self._pilot_seq_len:]

    @property
    def symbols(self):
        return self._symbols_obj.samples

    @property
    def coded_symbols(self):
        return self._symbols_obj.coded_symbols

    @property
    def coded_symbols_host(self):
        return self._symbols_obj.coded_symbols_host

    @property
    def bitmap_mtx(self):
        return self._symbols_obj.bitmap_mtx

    @property
    def Nbits(self):
        return self._symbols_obj.Nbits

    @property
    def frame_len(self):
        return self._frame_len

    @property
    def pilot_seq_len(self):
        return self._pilot_seq_len

    @property
    def pilot_ins_rat(self):
        return self._pilot_ins_rat

    @property
    def nframes(self):
        return self.shape[-1] // (self.os * self._frame_len)

    @property
    def idx_payload(self):
        return np.tile(self._idx_dat, self.nframes)[: self.shape[-1]]

    @property
    def idx_pilots(self):
        return np.tile(~self._idx_dat, self.nframes)[: self.shape[-1]]

    @property
    def idx_pil(self):
        return ~self._idx_dat

    @property
    def shiftfctrs(self):
        return self._shiftfctrs

    @shiftfctrs.setter
    def shiftfctrs(self, value):
        self._shiftfctrs = value

    @property
    def synctaps(self):
        return self._synctaps

    @synctaps.setter
    def synctaps(self, value):
        self._synctaps = value

    # -- frame operations --------------------------------------------------
    def sync2frame(self, returntaps=False, **kwargs):
        """Find the frame start and align the modes (signals.py:1153-1171), on the signal's device.

        ``ops.pilots.frame_sync`` with the reference's defaults (cma, 17
        taps, mu 5e-3, 10 iterations, adaptive step) unless given.
        """
        from qampy_tpu_torch.ops import pilots as pilotbased_receiver
        eqargs = {"adaptive_stepsize": True, "Niter": 10, "method": "cma", "Ntaps": 17,
                  "mu": 5e-3}
        eqargs.update(kwargs)
        mu = eqargs.pop("mu")
        Ntaps = eqargs.pop("Ntaps")
        shift_factors, coarse_foe, mode_alignment, wx1, sync_bool = pilotbased_receiver.frame_sync(
            self.samples, self.pilot_seq, self.os, mu=mu, Ntaps=Ntaps, frame_len=self.frame_len,
            M_pilot=self.Mpilots, device=self.samples.device, **eqargs)
        order = np.asarray(mode_alignment)
        self.samples = self.samples[torch.as_tensor(order, device=self.samples.device)]
        shift_factors = np.array(shift_factors)
        shift_factors[shift_factors < 0] += self.frame_len * self.os
        self._shiftfctrs = shift_factors[order]
        self._synctaps = Ntaps
        self._foe = coarse_foe
        if returntaps:
            return wx1, sync_bool
        return sync_bool

    def corr_foe(self, additional_foe=0):
        """Remove the coarse frequency offset found by :meth:`sync2frame` (signals.py:1173-1178)."""
        from qampy_tpu_torch.ops import phase as _phase
        foe_off = np.ones(np.asarray(self._foe).shape) * (np.mean(self._foe) + additional_foe)
        self._foe = np.zeros_like(foe_off)
        self.samples = _phase.comp_freq_offset(self.samples, foe_off, self.os)

    def _frame_idx(self, frames=None):
        if frames is None:
            return np.arange(self.nframes), self.nframes
        frames = np.atleast_1d(frames)
        nframes = int(np.max(frames)) + 1
        if nframes > max(self.nframes, 1):
            raise ValueError("Signal object only contains {} frames".format(self.nframes))
        return frames, nframes

    def get_data(self, frames=None):
        """The payload (pilots removed) as a payload signal (signals.py:1191-1204).

        Needs symbol-rate samples aligned to the frame start.
        """
        frames, nframes = self._frame_idx(frames)
        if nframes < 1:
            idx = self._idx_dat[: self.shape[-1]]
        else:
            idx = np.zeros(self.frame_len * nframes, dtype=bool)
            for i in frames:
                idx[i * self.frame_len:(i + 1) * self.frame_len] = self._idx_dat
        sel = torch.as_tensor(np.nonzero(idx)[0], device=self.samples.device)
        return self._symbols_obj.replace(samples=self.samples[:, sel])

    def extract_pilots(self, frames=None):
        """The received pilots as a pilot signal (signals.py:1206-1210)."""
        frames, _ = self._frame_idx(frames)
        idx = np.hstack([np.nonzero(~self._idx_dat)[0] + i * self._frame_len for i in frames])
        return self._pilots_obj.replace(samples=self.samples[:, torch.as_tensor(
            idx, device=self.samples.device)])

    # -- frame-aware metrics (signals.py:1213-1243) --------------------------
    def cal_ser(self, frames=None, synced=True, signal_rx=None, verbose=False):
        if signal_rx is None:
            signal_rx = self.get_data(frames)
        return signal_rx.cal_ser(synced=synced, verbose=verbose)

    def cal_ber(self, frames=None, synced=True, signal_rx=None, verbose=False):
        if signal_rx is None:
            signal_rx = self.get_data(frames)
        return signal_rx.cal_ber(synced=synced, verbose=verbose)

    def cal_evm(self, frames=None, synced=True, signal_rx=None, blind=False):
        if signal_rx is None:
            signal_rx = self.get_data(frames)
        return signal_rx.cal_evm(synced=synced, blind=blind)

    def cal_gmi(self, frames=None, synced=True, snr=None, signal_rx=None, use_pilot_snr=False):
        if use_pilot_snr and snr is not None:
            raise ValueError("use_pilot_snr must not be True if snr is not None")
        if signal_rx is None:
            signal_rx = self.get_data(frames)
        if use_pilot_snr:
            snr = self.est_snr(use_pilots=True)
        return signal_rx.cal_gmi(synced=synced, snr=snr)

    def est_snr(self, frames=None, synced=True, signal_rx=None, symbols_tx=None,
                use_pilots=False):
        if signal_rx is None:
            if use_pilots:
                signal_rx = self.extract_pilots(frames=frames)
            else:
                signal_rx = self.get_data(frames=frames)
        return signal_rx.est_snr(synced=synced, symbols_tx=symbols_tx)


#: the reference's name of the base class (qampy/signals.py:144)
SignalBase = Signal
