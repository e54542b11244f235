"""Adaptive MIMO equalisation: host constants, error functions, plain trainers, entry functions.

Counterpart of ``qampy_tpu/ops/equaliser.py``. The host-side constants
(equaliser.py:61-207, 659-696) are numpy. The error functions (:242-336),
the exact per-symbol trainer ``train_equaliser_seq`` (:343-394), the
block-LMS trainer ``train_equaliser_block`` (:414-495) and the filter
``apply_filter_to_signal`` (:509) are plain PyTorch; the trainers and the
filter compute on float32 [Re rows; Im rows] planes, one rounding per
tensor op. They are the plain versions that the CUDA kernels of
``ops/equaliser_cuda.py`` are held against, what the chains run on CPU
tensors, and the ``"seq"`` and ``"block"`` backends of the entry functions
``equalise_signal`` and ``dual_mode_equalisation`` (:697-846), whose
``"cuda"`` and ``"cuda_block"`` backends are the kernels B9 and B1.

The block trainer has two sources of its error function: an
:class:`ErrSpec` of host constants, the form kernel B1 implements (the
complex methods cma, sgncma, mcma, rde and the decision methods sbd, mddma,
dd on a square, rectangular or cross grid or a general alphabet of up to
256 points), and any error function of :func:`_make_error_fn` /
:func:`_make_error_fn_real`, which the ``"block"`` backend takes
for every method and alphabet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from qampy_tpu_torch.ops._build import KernelLimit
from qampy_tpu_torch.ops.phase import (KIND_CODE, detect_grid, gen_points, grid_consts,
                                       grid_decision_info)
from qampy_tpu_torch.theory import cal_symbols_qam, cal_scaling_factor_qam
from qampy_tpu_torch.utils import resolve_device

#: Decision based equalisation methods (reference core/equalisation/equalisation.py:87)
DECISION_BASED = ("sbd", "mddma", "dd", "sbd_data", "dd_real", "dd_data_real")
#: Non-decision based equalisation methods (:90)
NONDECISION_BASED = ("cma", "cma2", "mcma", "rde", "mrde", "cma_real", "sgncma_real", "sgncma")
#: Real-valued equalisation methods (:93)
REAL_VALUED = ("cma_real", "dd_real", "dd_data_real", "sgncma_real")
#: Data-aided equalisation methods (:96)
DATA_AIDED = ("dd_data_real", "sbd_data")
#: All available adaptive equaliser methods (:99)
TRAINING_FCTS = DECISION_BASED + NONDECISION_BASED
#: Extended blind methods: the square-contour algorithm and the
#: constellation-matched error (reference equaliser.py:50-54)
EXTENDED_METHODS = ("sca", "cme")
#: Methods of the :class:`ErrSpec` block trainer and kernel B1 (the
#: reference's PALLAS_BLOCK_METHODS)
BLOCK_METHODS = ("cma", "sgncma", "mcma", "rde", "sbd", "mddma", "dd")
#: Methods of the per-symbol kernel B9 (the reference's PALLAS_METHODS)
SEQ_KERNEL_METHODS = ("cma", "sgncma", "mcma", "rde")
#: Trainer backends of ``equalise_signal`` and ``dual_mode_equalisation``
BACKENDS = ("auto", "seq", "block", "cuda", "cuda_block")
#: The block trainer's methods that decide on the constellation
DECISION_BLOCK_METHODS = ("sbd", "mddma", "dd")


# ---------------------------------------------------------------------------
# per-method training constants (host-side, static)
# ---------------------------------------------------------------------------

def _cal_Rconstant(M):
    """CMA radius constant (reference core/equalisation/equalisation.py:271-275)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    return np.mean(abs(syms) ** 4) / np.mean(abs(syms) ** 2)


def _cal_Rconstant_complex(M):
    """MCMA complex radius constant (reference :277-281)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    return (np.mean(syms.real ** 4) / np.mean(syms.real ** 2)
            + 1.j * np.mean(syms.imag ** 4) / np.mean(syms.imag ** 2))


def _cal_Rdash(syms):
    return ((abs(syms.real + syms.imag) + abs(syms.real - syms.imag))
            * (np.sign(syms.real + syms.imag) + np.sign(syms.real - syms.imag)
               + 1.j * (np.sign(syms.real + syms.imag) - np.sign(syms.real - syms.imag)))
            * syms.conj())


def _cal_Rsca(M):
    """SCA radius constant (reference :265-269)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    Rd = _cal_Rdash(syms)
    return np.mean((abs(syms.real + syms.imag) + abs(syms.real - syms.imag)) ** 2 * Rd) / (4 * np.mean(Rd))


def generate_partition_codes_radius(M):
    """RDE partition codebook (reference :338-359): [codes, partition boundaries]."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    codes = np.unique(abs(syms) ** 4 / abs(syms) ** 2)
    parts = codes[:-1] + np.diff(codes) / 2
    return np.hstack([codes, parts])


def generate_partition_codes_complex(M):
    """MRDE complex partition codebook (reference :311-336)."""
    syms = cal_symbols_qam(M)
    syms = syms / np.sqrt(cal_scaling_factor_qam(M))
    syms_r = np.unique(abs(syms.real) ** 4 / abs(syms.real) ** 2)
    syms_i = np.unique(abs(syms.imag) ** 4 / abs(syms.imag) ** 2)
    codes = syms_r + 1.j * syms_i
    part_r = syms_r[:-1] + np.diff(syms_r) / 2
    part_i = syms_i[:-1] + np.diff(syms_i) / 2
    return np.hstack([codes, part_r + 1.j * part_i])


def _min_spacing(M):
    """Distance between constellation points along one dimension."""
    levels = np.unique(cal_symbols_qam(M).real / np.sqrt(cal_scaling_factor_qam(M)))
    return float(np.min(np.diff(levels)))


def generate_symbols_for_eq(method, M, dtype):
    """Per-method constants/symbol arrays (reference :101-136)."""
    if method in ("cma", "cma2", "sgncma"):
        return np.atleast_2d(_cal_Rconstant(M) + 0j).astype(dtype)
    if method == "sca":
        return np.atleast_2d(_cal_Rsca(M) + 0j).astype(dtype)
    if method == "cme":
        # row = [R, d, beta]: CMA radius, the sinusoid's period d (the grid
        # penalty sin(pi*x/d) vanishes at every constellation level) and the
        # CMA/sin mixing ratio beta (reference equaliser.py:124-131)
        return np.atleast_2d(np.array(
            [_cal_Rconstant(M), _min_spacing(M) / 2, 0.5]) + 0j).astype(dtype)
    if method == "mcma":
        return np.atleast_2d(_cal_Rconstant_complex(M)).astype(dtype)
    if method == "rde":
        return np.atleast_2d(generate_partition_codes_radius(M) + 0j).astype(dtype)
    if method == "mrde":
        return np.atleast_2d(generate_partition_codes_complex(M)).astype(dtype)
    if method in ("sbd", "mddma", "dd"):
        return np.atleast_2d(cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
    if method in ("sgncma_real", "cma_real"):
        return np.repeat([np.atleast_1d(_cal_Rconstant_complex(M).real.astype(dtype))], 2, axis=0)
    if method == "dd_real":
        symbols = cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))
        return np.vstack([symbols.real, symbols.imag]).astype(dtype)
    if method in DATA_AIDED:
        raise ValueError("%s is a data-aided method and needs the symbols to be passed" % method)
    raise ValueError("%s is unknown method" % method)


def generate_symbols_for_eq_from_alphabet(method, const, dtype):
    """Blind-method constants computed from an arbitrary alphabet (reference :150-194).

    The CMA-family radius constants of a custom alphabet must come from the
    alphabet's own moments, or the modulus criterion converges the output
    to the wrong scale.
    """
    const = np.asarray(const).reshape(-1)
    if method in ("cma", "cma2", "sgncma"):
        R = np.mean(np.abs(const) ** 4) / np.mean(np.abs(const) ** 2)
        return np.atleast_2d(R + 0j).astype(dtype)
    if method == "mcma":
        R = (np.mean(const.real ** 4) / np.mean(const.real ** 2)
             + 1j * np.mean(const.imag ** 4) / np.mean(const.imag ** 2))
        return np.atleast_2d(R).astype(dtype)
    if method == "rde":
        # [codes..., partition boundaries...]: the |s|^4/|s|^2 moment radius
        # of every |s| shell of the alphabet
        r2 = np.abs(const) ** 2
        shells = np.unique(np.round(r2, 6))
        codes = np.array([np.mean(r2[np.isclose(np.round(r2, 6), s)] ** 2)
                          / np.mean(r2[np.isclose(np.round(r2, 6), s)])
                          for s in shells])
        parts = codes[:-1] + np.diff(codes) / 2
        return np.atleast_2d(np.hstack([codes, parts]) + 0j).astype(dtype)
    if method == "mrde":
        sr = np.unique(np.round(np.abs(const.real) ** 4
                                / np.abs(const.real) ** 2, 9))
        si = np.unique(np.round(np.abs(const.imag) ** 4
                                / np.abs(const.imag) ** 2, 9))
        n = min(sr.size, si.size)
        sr, si = sr[:n], si[:n]
        codes = sr + 1j * si
        parts = (sr[:-1] + np.diff(sr) / 2) + 1j * (si[:-1] + np.diff(si) / 2)
        return np.atleast_2d(np.hstack([codes, parts])).astype(dtype)
    if method in ("sbd", "mddma", "dd"):
        return np.atleast_2d(const).astype(dtype)
    raise ValueError("no alphabet-derived constants for method %r" % method)


def _reshape_symbols(symbols, method, M, dtype, nmodes):
    """Normalise the shape of the symbols/constants array (reference :568-594)."""
    if method in EXTENDED_METHODS:
        # sca takes one constant, cme a [R, d, beta] row; anything else is
        # replaced by the generated constants
        nconst = {"sca": 1, "cme": 3}[method]
        if symbols is None or np.asarray(symbols).shape[-1] != nconst:
            symbols = generate_symbols_for_eq(method, M, dtype)
    elif symbols is None or method in NONDECISION_BASED:
        symbols = generate_symbols_for_eq(method, M, dtype)
    symbols = np.asarray(symbols)
    if method not in REAL_VALUED:
        if symbols.ndim == 1 or symbols.shape[0] == 1:
            symbols = np.tile(symbols, (nmodes, 1))
        elif symbols.shape[0] != nmodes:
            raise ValueError(
                "Symbols array is shape {} but signal has {} modes".format(symbols.shape, nmodes))
        return np.atleast_2d(symbols.astype(dtype))
    if np.iscomplexobj(symbols):
        if symbols.ndim == 1 or symbols.shape[0] == 1:
            symbols = np.repeat([symbols.real, symbols.imag], nmodes // 2, axis=0).squeeze()
            symbols = symbols.reshape(nmodes, -1)
        elif symbols.shape[0] == nmodes // 2:
            symbols = np.vstack([symbols.real, symbols.imag])
        else:
            raise ValueError(
                "Complex symbols array has {} modes, needs 1 or {}".format(symbols.shape[0], nmodes // 2))
    else:
        if symbols.shape[0] == 2 and nmodes > 2:
            symbols = np.repeat([symbols[0], symbols[1]], nmodes // 2, axis=0).squeeze()
            symbols = symbols.reshape(nmodes, -1)
        elif symbols.shape[0] != nmodes:
            raise ValueError(
                "Symbols array is shape {} but signal has {} modes".format(symbols.shape, nmodes))
    return symbols.astype(dtype)


def _init_taps(Ntaps, nmodes, nmodes2, dtype):
    """Identity centre-tap initialisation (reference :364-373)."""
    wxy = np.zeros((nmodes, nmodes2, Ntaps), dtype=dtype)
    for i in range(nmodes):
        wxy[i, i, Ntaps // 2] = 1
    return wxy


def orthogonalizetaps(wx):
    """Y-pol taps orthogonal to X-pol to avoid the CMA singularity (reference :284-309)."""
    return np.conj(np.asarray(wx)[::-1, ::-1])


def _convert_sig_to_real(E):
    """Stack [Re; Im] into a 2*nmodes real signal (reference :253-257)."""
    return torch.cat([E.real, E.imag], dim=0)


def _convert_sig_to_cmplx(E, modes):
    """Inverse of _convert_sig_to_real (reference :259-260)."""
    return torch.complex(E[:modes // 2], E[modes // 2:])


def planes(E):
    """Stack a complex (nmodes, L) signal into float32 [Re rows; Im rows]."""
    return _convert_sig_to_real(E).float()


# ---------------------------------------------------------------------------
# error functions: vectorised over the samples and, with a (nout, k) symbols
# array and a (nout, S) estimate, over the output modes
# ---------------------------------------------------------------------------
# Parity with the reference's equaliser.py:242-336. ``syms`` is the per-mode
# symbol/constant row, (k,) beside an estimate of shape (S,) or (nout, k)
# beside (nout, S); ``i`` the (S,) training-symbol indices that the
# data-aided methods read. Products and sums are written on the real and
# imaginary parts, one rounding per operation, so that kernel B9 can repeat
# them exactly.

def _partition_value(signal, partitions, codebook):
    """Radius partition lookup, vectorised (reference pythran_equalisation.py:4-9)."""
    idx = (signal[..., None] > partitions[..., None, :]).sum(dim=-1)
    return torch.gather(codebook.expand(*idx.shape[:-1], -1), -1, idx)


def _nearest(Xest, syms):
    """Per-element nearest-symbol decision (the expanded distance |s|^2 - 2 Re(x conj(s)))."""
    if syms.is_complex():
        sr, si = syms.real[..., None, :], syms.imag[..., None, :]
        d = (sr * sr + si * si) - 2 * (Xest.real[..., None] * sr + Xest.imag[..., None] * si)
    else:
        s = syms[..., None, :]
        d = s * s - 2 * (Xest[..., None] * s)
    idx = torch.argmin(d, dim=-1)
    return torch.gather(syms.expand(*idx.shape[:-1], -1), -1, idx)


def _split_codebook(syms):
    """[codes, partitions] halves of an rde/mrde row (``jnp.array_split(row, 2)``)."""
    n1 = (syms.shape[-1] + 1) // 2
    return syms[..., :n1], syms[..., n1:]


def _make_error_fn(method):
    """Return err_fn(Xest, syms, i) for a complex-valued method."""
    if method in ("cma", "sgncma"):
        # the reference dispatch maps "sgncma" to the plain CMA error
        # (equaliser.py:244-246); matched deliberately
        def fn(Xest, syms, i):
            xr, xi = Xest.real, Xest.imag
            d = syms[..., :1].real - (xr * xr + xi * xi)
            return torch.complex(d * xr, d * xi)
    elif method == "cma2":
        def fn(Xest, syms, i):
            return (syms[..., :1] - Xest * Xest) * Xest
    elif method == "mcma":
        def fn(Xest, syms, i):
            xr, xi = Xest.real, Xest.imag
            dr = syms[..., :1].real - xr * xr
            di = syms[..., :1].imag - xi * xi
            return torch.complex(dr * xr, di * xi)
    elif method == "rde":
        def fn(Xest, syms, i):
            codebook, partition = _split_codebook(syms)
            xr, xi = Xest.real, Xest.imag
            sq = xr * xr + xi * xi
            d = _partition_value(sq, partition.real, codebook.real) - sq
            return torch.complex(xr * d, xi * d)
    elif method == "mrde":
        def fn(Xest, syms, i):
            codebook, partition = _split_codebook(syms)
            xr, xi = Xest.real, Xest.imag
            sqr, sqi = xr * xr, xi * xi
            rr = _partition_value(sqr, partition.real, codebook.real)
            ri = _partition_value(sqi, partition.imag, codebook.imag)
            return torch.complex((rr - sqr) * xr, (ri - sqi) * xi)
    elif method == "sbd":
        def fn(Xest, syms, i):
            s = _nearest(Xest, syms)
            return torch.complex((s.real - Xest.real) * s.real.abs(),
                                 (s.imag - Xest.imag) * s.imag.abs())
    elif method == "sbd_data":
        def fn(Xest, syms, i):
            s = syms[..., i]
            d = s - Xest
            return torch.complex(d.real * s.real.abs(), d.imag * s.imag.abs())
    elif method == "mddma":
        def fn(Xest, syms, i):
            s = _nearest(Xest, syms)
            xr, xi = Xest.real, Xest.imag
            return torch.complex((s.real ** 2 - xr ** 2) * xr, (s.imag ** 2 - xi ** 2) * xi)
    elif method == "dd":
        def fn(Xest, syms, i):
            return _nearest(Xest, syms) - Xest
    elif method == "sca":
        # square-contour algorithm: drive whichever I/Q component is larger
        # towards the square contour of squared radius R2; both when equal
        def fn(Xest, syms, i):
            R2 = syms[..., :1].real
            xr, xi = Xest.real, Xest.imag
            ar, ai = xr.abs(), xi.abs()
            A = (ar >= ai).to(xr.dtype)
            B = (ai >= ar).to(xr.dtype)
            return torch.complex(16 * xr * (R2 - xr ** 2) * A, 16 * xi * (R2 - xi ** 2) * B)
    elif method == "cme":
        # constellation-matched error: the CMA term plus a sinusoidal
        # constellation-grid penalty of period d, mixed in with ratio beta
        def fn(Xest, syms, i):
            R, d, beta = (syms[..., j:j + 1].real for j in range(3))
            xr, xi = Xest.real, Xest.imag
            c = R - (xr * xr + xi * xi)
            k = beta * np.pi / (2 * d)
            return torch.complex(c * xr + k * torch.sin(xr * np.pi / d),
                                 c * xi + k * torch.sin(xi * np.pi / d))
    else:
        raise ValueError("Unknown method %s" % method)
    return fn


def _make_error_fn_real(method):
    """Return err_fn(Xest, syms, i) for a real-valued method (reference :318-336)."""
    if method == "cma":
        def fn(Xest, syms, i):
            return (syms[..., :1] - Xest ** 2) * Xest
    elif method == "sgncma":
        def fn(Xest, syms, i):
            return torch.sign(syms[..., :1] - Xest ** 2) * torch.sign(Xest)
    elif method == "dd":
        def fn(Xest, syms, i):
            s = _nearest(Xest, syms)
            return (s - Xest) * s.abs()
    elif method == "dd_data":
        def fn(Xest, syms, i):
            s = syms[..., i]
            return (s - Xest) * s.abs()
    else:
        raise ValueError("Unknown method %s" % method)
    return fn


def planes_errfn(method, symbols, real_valued=False):
    """A trainer's error function (zr, zi, idxs) -> (er, ei) from the method's name.

    ``symbols``: the (nout, k) tensor of per-mode rows, complex (float for
    a real-valued method, whose ``zi`` and ``ei`` are None).
    """
    if real_valued:
        fn = _make_error_fn_real(method)
        return lambda zr, zi, idxs: (fn(zr, symbols, idxs), None)
    fn = _make_error_fn(method)

    def planes_fn(zr, zi, idxs):
        e = fn(torch.complex(zr, zi), symbols, idxs)
        return e.real, e.imag
    return planes_fn


# ---------------------------------------------------------------------------
# error functions from host constants: the form kernel B1 implements
# ---------------------------------------------------------------------------

class ErrSpec(NamedTuple):
    """Host constants of a block-trainer error function.

    ``method`` is one of :data:`BLOCK_METHODS` ("sgncma" is stored as
    "cma"). ``consts`` holds, per output mode, the radius constant (Rr, Ri)
    of mcma, the radius R of cma or the [codes, partitions] row of rde (its
    real parts); for sbd, mddma and dd it is the grid spec of the decision
    (``ops.phase.detect_grid``: square, rectangular, cross or the points of
    a general alphabet), one for all outputs.
    """
    method: str
    consts: tuple


def err_spec(method, symbols):
    """Build the :class:`ErrSpec` of ``method`` from a host symbols array.

    ``symbols`` is the (nout, k) array of ``_reshape_symbols``: row m holds
    output m's constants (cma, mcma, rde) or constellation (sbd, mddma, dd).
    """
    if method not in BLOCK_METHODS:
        raise NotImplementedError(
            "block trainer kernel method %r: the kernel takes %s, as the reference's "
            "fused block trainer does" % (method, BLOCK_METHODS))
    symbols = np.atleast_2d(np.asarray(symbols))
    if method == "mcma":
        return ErrSpec(method, tuple((float(r.real), float(r.imag))
                                     for r in symbols[:, 0]))
    if method in ("cma", "sgncma"):
        return ErrSpec("cma", tuple(float(r.real) for r in symbols[:, 0]))
    if method == "rde":
        return ErrSpec(method, tuple(tuple(float(x) for x in row.real) for row in symbols))
    # the decision is made on the first row's alphabet, as in the reference
    # (equaliser_pallas.py:316)
    grid = detect_grid(symbols[0])
    if grid is None:
        raise ValueError("method %r decides on a constellation of at least two points, got "
                         "symbols of shape %s" % (method, symbols.shape))
    if grid_decision_info(grid)[0] == "gen":
        gen_points(grid)          # refuses an alphabet above its limit
    return ErrSpec(method, grid)


def block_kernel_takes(method, symbols, nout, real_valued=False, launch=None):
    """Whether kernel B1 trains this: the routing rule of ``backend="auto"`` on the card.

    True when the :class:`ErrSpec` trainer takes the method and the
    alphabet (at most 256 points where it has no grid) and, with ``launch``
    = (P, TrSyms, os, wx, block_size), when B1's launcher takes that
    launch: its own rules (``equaliser_cuda.check_block_launch``: at most 2
    output modes, a [codes, partitions] row of at most 64 entries, a block
    that is a multiple of 32 up to 1024, the shared memory of one CTA),
    asked on the host without building the kernels. ``auto`` takes the
    plain block trainer for whatever this refuses. Only the kernel's limits
    (``KernelLimit``) make it False: arguments that no backend takes (a
    capture shorter than the training, planes that do not match the taps,
    an alphabet of one point) raise here as they do from every backend.
    """
    if real_valued or method not in BLOCK_METHODS:
        return False
    try:
        spec = err_spec(method, symbols)
        if launch is not None:
            from qampy_tpu_torch.ops.equaliser_cuda import check_block_launch
            check_block_launch(*launch, spec)
        elif nout > 2:
            return False
    except KernelLimit:
        return False
    return True


def spec_rows(spec, nout):
    """The constants of the first ``nout`` outputs of a per-output spec (cma, mcma, rde)."""
    if len(spec.consts) < nout:
        raise ValueError("%s constants for %d outputs, the taps have %d"
                         % (spec.method, len(spec.consts), nout))
    return spec.consts[:nout]


def block_errfn(spec, nout, device):
    """The error function (zr, zi, idxs) -> (er, ei) of an :class:`ErrSpec`.

    zr/zi: (..., nout, S) filter output. mcma: (R - z^2) z per axis; cma:
    (R - |z|^2) z; rde: (r - |z|^2) z with r the codebook radius of the
    partition |z|^2 falls in (equaliser.py:244-263); with d the decided
    point (:func:`grid_decision`), per axis, sbd: (d - z)|d|, mddma:
    (d^2 - z^2) z, dd: d - z (equaliser_pallas.py:277-288).
    """
    if spec.method == "mcma":
        c = torch.tensor(spec_rows(spec, nout), dtype=torch.float32, device=device)
        cr, ci = c[:, 0:1], c[:, 1:2]
        return lambda zr, zi, idxs=None: ((cr - zr * zr) * zr, (ci - zi * zi) * zi)
    if spec.method == "cma":
        rs = spec_rows(spec, nout)
        # one radius for every output stays a Python scalar: no host-to-device copy
        r = rs[0] if len(set(rs)) == 1 else torch.tensor(
            rs, dtype=torch.float32, device=device)[:, None]

        def cma(zr, zi, idxs=None):
            d = r - (zr * zr + zi * zi)
            return d * zr, d * zi
        return cma
    if spec.method == "rde":
        codes, parts = _split_codebook(torch.tensor(spec_rows(spec, nout), dtype=torch.float32,
                                                    device=device))

        def rde(zr, zi, idxs=None):
            sq = zr * zr + zi * zi
            d = _partition_value(sq, parts, codes) - sq
            return d * zr, d * zi
        return rde
    dec = grid_decision(spec.consts, device)
    if spec.method == "sbd":
        def fn(zr, zi, idxs=None):
            dr, di = dec(zr, zi)
            return (dr - zr) * dr.abs(), (di - zi) * di.abs()
    elif spec.method == "mddma":
        def fn(zr, zi, idxs=None):
            dr, di = dec(zr, zi)
            return (dr * dr - zr * zr) * zr, (di * di - zi * zi) * zi
    else:
        def fn(zr, zi, idxs=None):
            dr, di = dec(zr, zi)
            return dr - zr, di - zi
    return fn


def grid_decision(grid, device):
    """The decision (zr, zi) -> (dr, di) of sbd, mddma and dd on a grid spec of any kind.

    The reference's ``_make_block_err_decision`` (equaliser_pallas.py:208-273),
    every product and sum rounded on its own; half-way points go up
    (floor(x + 0.5), never round). Square and rectangular grids decide each
    axis on its own levels. Cross QAM, in units x = (z - lo)/d0, takes the
    closer of two rectangle clamps: A clamps the columns to [0, n-1] and the
    rows to [c, n-1-c], B the other way round, and A wins a tie. A general
    alphabet takes the point of the greatest score 2<z, s_k> - |s_k|^2, the
    first of equal ones, from the table of ``ops.phase.gen_points``.
    """
    gc = grid_consts(grid, "the decision of sbd, mddma and dd")
    d0, (lor, loi, g2, g3) = gc.d0, gc.g

    def level(z, lo, hi):
        return lo + d0 * torch.clamp(torch.floor((z - lo) / d0 + 0.5), 0.0, hi)
    if gc.code == KIND_CODE["r"]:
        return lambda zr, zi: (level(zr, lor, g2), level(zi, loi, g3))
    if gc.kind == "x":
        nm1, cc, ccm = g2, g3, g2 - g3

        def cross(zr, zi):
            x, y = (zr - lor) / d0, (zi - loi) / d0
            rx, ry = torch.floor(x + 0.5), torch.floor(y + 0.5)
            iA, jA = torch.clamp(rx, 0.0, nm1), torch.clamp(ry, cc, ccm)
            iB, jB = torch.clamp(rx, cc, ccm), torch.clamp(ry, 0.0, nm1)
            useA = ((x - iA) ** 2 + (y - jA) ** 2) <= ((x - iB) ** 2 + (y - jB) ** 2)
            return lor + d0 * torch.where(useA, iA, iB), loi + d0 * torch.where(useA, jA, jB)
        return cross
    a2, b2, c = torch.as_tensor(gc.points, device=device).unbind(-1)
    order = torch.arange(a2.shape[0], device=device)

    def nearest(zr, zi):
        # 2 (zr a + zi b) - c: the doubling is exact, so the table's 2a and 2b give the
        # reference's score bit for bit
        sc = (zr.unsqueeze(-1) * a2 + zi.unsqueeze(-1) * b2) - c
        first = torch.where(sc == sc.amax(-1, keepdim=True), order, order.shape[0]).amin(-1)
        return 0.5 * a2[first], 0.5 * b2[first]
    return nearest


# ---------------------------------------------------------------------------
# trainers on planes
# ---------------------------------------------------------------------------

def _windows(P, Ts, os, ntaps):
    """X[..., r*ntaps + t, s] = P[..., r, s*os + t] over all rows r of P."""
    if P.shape[-1] < (Ts - 1) * os + ntaps:
        raise ValueError("capture of %d samples is shorter than the %d training "
                         "windows need" % (P.shape[-1], (Ts - 1) * os + ntaps))
    U = P.unfold(-1, ntaps, os)[..., :Ts, :]             # (..., rows, Ts, ntaps)
    return U.transpose(-1, -2).reshape(*P.shape[:-2], P.shape[-2] * ntaps, Ts)


def training_windows(P, Ts, os, ntaps):
    """The training windows X[k, s] = E[m, s*os + t], k = m*ntaps + t, as planes.

    P: (..., 2*nmodes, L) float32. Returns (Xr, Xi), each (..., nmodes*ntaps, Ts).
    """
    K = P.shape[-2] // 2 * ntaps
    X = _windows(P, Ts, os, ntaps)
    return X[..., :K, :].contiguous(), X[..., K:, :].contiguous()


def _real_taps(wx, batch=()):
    """(wr, wi) float32 (*batch, nout, K) copies of taps (..., nout, nmodes, ntaps).

    wi is None for real taps. Taps without the batch axes are shared by
    every row of the batch.
    """
    K = wx.shape[-2] * wx.shape[-1]

    def flat(w):
        w = w.reshape(*w.shape[:-2], K).float()
        return w.expand(*batch, *w.shape[-2:]).clone()
    if wx.is_complex():
        return flat(wx.real), flat(wx.imag)
    return flat(wx), None


def train_block_planes(P, TrSyms, Niter, os, mu, wx, err, adaptive=False,
                       block_size=32, real=False):
    """Plain block-LMS training on float32 planes.

    Same math as the reference block trainer (equaliser.py:414-495,
    equaliser_pallas.py:376-431): per block of S samples with taps frozen,
    z = W X, the error, W += (mu err) conj(X)^T; with ``adaptive`` the
    aggregated rule 1/mu += e_prev^2 over the sign-flip samples, skipping
    sample 0 of each pass. Taps, mu and the last error carry across blocks.

    P: (..., 2*nmodes, L) float32, any leading batch axes (the pilot chain's
    frame search trains its candidate windows as one batch, and its LMS
    trainer each output mode on its own segment, where the reference
    vmaps); wx: (nout, nmodes, ntaps) complex64, shared by the batch, or
    (..., nout, nmodes, ntaps) with the batch axes of P, one set per row.
    ``err`` is an :class:`ErrSpec` or an error function (zr, zi,
    idxs) -> (er, ei), idxs the (S,) sample indices of the block in its
    pass. With ``real`` (the real-valued methods) P is the (..., nmodes, L)
    real signal, the taps are real and zi, ei are None.
    Returns (err (..., nout, Niter*Ts) complex64, taps (..., nout, nmodes,
    ntaps), mu (..., nout) float32); err and taps are float32 with ``real``.
    """
    nout, nmodes, ntaps = wx.shape[-3:]
    batch = P.shape[:-2]
    S = min(int(block_size), int(TrSyms))
    nblocks = int(TrSyms) // S
    Ts = nblocks * S
    if real:
        Xr, Xi = _windows(P, Ts, os, ntaps), None
    else:
        Xr, Xi = training_windows(P, Ts, os, ntaps)
    errfn = block_errfn(err, nout, P.device) if isinstance(err, ErrSpec) else err
    wr, wi = _real_taps(wx, batch)
    mu_c = torch.full((*batch, nout), mu, dtype=torch.float32, device=P.device)
    prev_r = torch.zeros(*batch, nout, 1, dtype=torch.float32, device=P.device)
    prev_i = torch.zeros_like(prev_r)
    sidx = torch.arange(S, device=P.device)
    errs_r, errs_i = [], []
    for b in range(int(Niter) * nblocks):
        blk = b % nblocks
        idxs = sidx + blk * S
        xr = Xr[..., blk * S:(blk + 1) * S]
        xrt = xr.transpose(-1, -2)
        if real:
            er, _ = errfn(wr @ xr, None, idxs)
            wr = wr + (er * mu_c[..., None]) @ xrt
        else:
            xi = Xi[..., blk * S:(blk + 1) * S]
            zr = wr @ xr - wi @ xi
            zi = wr @ xi + wi @ xr
            er, ei = errfn(zr, zi, idxs)
            errs_i.append(ei)
            ger = er * mu_c[..., None]
            gei = ei * mu_c[..., None]
            xit = xi.transpose(-1, -2)
            wr = wr + (ger @ xrt + gei @ xit)
            wi = wi + (gei @ xrt - ger @ xit)
        errs_r.append(er)
        if adaptive:
            pr = torch.cat([prev_r, er[..., :S - 1]], dim=-1)
            if real:
                keep, e2 = er * pr > 0, pr * pr
            else:
                pi = torch.cat([prev_i, ei[..., :S - 1]], dim=-1)
                keep, e2 = (er * pr > 0) & (ei * pi > 0), pr * pr + pi * pi
                prev_i = ei[..., S - 1:]
            flip = ~keep & (idxs > 0)
            mu_c = 1.0 / (1.0 / mu_c + torch.where(flip, e2, 0.0).sum(dim=-1))
            prev_r = er[..., S - 1:]
    if real:
        return (torch.cat(errs_r, dim=-1), wr.reshape(*batch, nout, nmodes, ntaps), mu_c)
    err_out = torch.complex(torch.cat(errs_r, dim=-1), torch.cat(errs_i, dim=-1))
    return err_out, torch.complex(wr, wi).reshape(*batch, nout, nmodes, ntaps), mu_c


def step_sizes(mu, nout, device):
    """The (nout,) float32 step sizes of a training: one value for all modes, or one per mode.

    A tensor of per-mode step sizes is what a training returns, so a caller
    can hand the taps and the steps of one call on to the next.
    """
    if isinstance(mu, torch.Tensor):
        if mu.shape != (nout,):
            raise ValueError("step sizes of shape %s for %d output modes" % (tuple(mu.shape), nout))
        return mu.to(device=device, dtype=torch.float32).clone()
    return torch.full((nout,), float(mu), dtype=torch.float32, device=device)


def train_seq_planes(P, TrSyms, Niter, os, mu, wx, errfn, adaptive=False, real=False):
    """The exact per-symbol LMS recurrence on float32 planes (reference equaliser.py:343-394).

    For i = 0 .. Niter*TrSyms-1, tr = i mod TrSyms, each output mode on its
    own: z = sum(w x) over the window x = E[:, tr*os : tr*os + ntaps], the
    error, w += mu err conj(x). With ``adaptive`` the step shrinks by the
    PREVIOUS error, mu <- mu / (1 + mu |e_prev|^2), unless both parts of
    the error kept their sign; sample 0 of each pass is skipped and the
    previous error carries across the passes. A Python loop over the
    symbols, vectorised over the output modes; every product and sum is a
    tensor op of its own, which fixes the rounding that kernel B9 repeats.

    P, wx, ``real``: as :func:`train_block_planes`; ``mu``: a float or the
    (nout,) steps of an earlier call (:func:`step_sizes`); ``errfn`` an
    error function (zr, zi, idxs) -> (er, ei) on (nout, 1) estimates.
    Returns (err (nout, Niter*TrSyms), taps (nout, nmodes, ntaps), mu (nout,)).
    """
    nout, nmodes, ntaps = wx.shape
    TrSyms = int(TrSyms)
    if real:
        Xr, Xi = _windows(P, TrSyms, os, ntaps).t().contiguous(), None
    else:
        Xr, Xi = (x.t().contiguous() for x in training_windows(P, TrSyms, os, ntaps))
    wr, wi = _real_taps(wx)
    mu_c = step_sizes(mu, nout, P.device).unsqueeze(-1)
    pr = torch.zeros(nout, 1, dtype=torch.float32, device=P.device)
    pi = torch.zeros_like(pr)
    tidx = torch.arange(TrSyms, device=P.device)
    errs_r, errs_i = [], []
    for i in range(int(Niter) * TrSyms):
        tr = i % TrSyms
        xr = Xr[tr]
        if real:
            er, _ = errfn((wr * xr).sum(dim=-1, keepdim=True), None, tidx[tr:tr + 1])
            wr = wr + mu_c * (er * xr)
        else:
            xi = Xi[tr]
            zr = (wr * xr - wi * xi).sum(dim=-1, keepdim=True)
            zi = (wr * xi + wi * xr).sum(dim=-1, keepdim=True)
            er, ei = errfn(zr, zi, tidx[tr:tr + 1])
            errs_i.append(ei)
            wr, wi = (wr + mu_c * (er * xr + ei * xi), wi + mu_c * (ei * xr - er * xi))
        errs_r.append(er)
        if adaptive and tr > 0:
            if real:
                keep, e2 = er * pr > 0, pr * pr
            else:
                keep, e2 = (er * pr > 0) & (ei * pi > 0), pr * pr + pi * pi
            mu_c = torch.where(keep, mu_c, mu_c / (1 + mu_c * e2))
        pr = er
        if not real:
            pi = ei
    if real:
        return torch.cat(errs_r, dim=-1), wr.reshape(nout, nmodes, ntaps), mu_c[:, 0]
    err_out = torch.complex(torch.cat(errs_r, dim=-1), torch.cat(errs_i, dim=-1))
    return err_out, torch.complex(wr, wi).reshape(nout, nmodes, ntaps), mu_c[:, 0]


def _trainer_inputs(E, wx, symbols, real_valued):
    """(planes or real signal, taps, symbols) tensors on E's device, in the working types."""
    E = torch.as_tensor(E)
    dev = E.device
    if real_valued:
        if E.is_complex():
            raise ValueError("a real-valued method trains on the stacked [Re; Im] signal")
        return (E.float(), torch.as_tensor(wx, device=dev).float(),
                torch.as_tensor(symbols, device=dev).float())
    return (planes(E), torch.as_tensor(wx, device=dev).to(torch.complex64),
            torch.as_tensor(symbols, device=dev).to(torch.complex64))


def train_equaliser_seq(E, TrSyms, Niter, os, mu, wx, symbols, method,
                        adaptive=False, real_valued=False):
    """Exact sequential LMS training with the reference's contract (equaliser.py:344).

    E: (nmodes, L) complex (the stacked real signal with ``real_valued``);
    wx: (nout, nmodes, ntaps); symbols: (nout, k) per-mode rows. Every
    method of the reference. Returns (err (nout, TrSyms*Niter), wx, mu (nout,)).
    """
    P, wx, symbols = _trainer_inputs(E, wx, symbols, real_valued)
    return train_seq_planes(P, TrSyms, Niter, os, mu, wx,
                            planes_errfn(method, symbols, real_valued), adaptive, real_valued)


def train_equaliser_block(E, TrSyms, Niter, os, mu, wx, symbols, method,
                          adaptive=False, real_valued=False, block_size=32):
    """Block-LMS training with the reference's contract (equaliser.py:414), every method.

    Arguments as :func:`train_equaliser_seq`; the error comes per block,
    (nout, nblocks*Niter*S) long.
    """
    P, wx, symbols = _trainer_inputs(E, wx, symbols, real_valued)
    return train_block_planes(P, TrSyms, Niter, os, mu, wx,
                              planes_errfn(method, symbols, real_valued), adaptive, block_size,
                              real_valued)


# ---------------------------------------------------------------------------
# filter application
# ---------------------------------------------------------------------------

def apply_filter_planes(P, os, wx):
    """Plain strided MIMO FIR on planes: out[j, i] = sum_{k,t} E[k, i*os+t] w[j,k,t].

    P: (2*nmodes, L) float32; wx: (nout, nmodes, ntaps) complex64. Returns
    the (2*nout, Lout) float32 output planes, Lout = (L - ntaps)//os + 1.
    """
    nout, nmodes, ntaps = wx.shape
    Lout = (P.shape[-1] - ntaps) // os + 1
    U = P.unfold(-1, ntaps, os)[:, :Lout]                # (2*nmodes, Lout, ntaps)
    Ur, Ui = U[:nmodes], U[nmodes:]
    wr, wi = wx.real.float(), wx.imag.float()
    outr = (torch.einsum("mlt,jmt->jl", Ur, wr) - torch.einsum("mlt,jmt->jl", Ui, wi))
    outi = (torch.einsum("mlt,jmt->jl", Ur, wi) + torch.einsum("mlt,jmt->jl", Ui, wr))
    return torch.cat([outr, outi], dim=0)


def check_pilot_side(pilots, frame_len):
    """(poff, pstride, npil) of a frame filter's pilot side output, checked against the frame."""
    poff, pstride, npil = (int(v) for v in pilots)
    if poff < 0 or pstride < 1 or npil < 1 or poff + (npil - 1) * pstride >= frame_len:
        raise ValueError("pilot side output of %d outputs at offset %d, stride %d does not fit "
                         "a frame of %d" % (npil, poff, pstride, frame_len))
    return poff, pstride, npil


def apply_filter_frames_planes(P, os, wx, offs, frame_len, pilots=None):
    """Plain frame-batched filter: out[i, f, k] = sum_{m,t} E[m, offs[i,f] + k*os + t] w[i,m,t].

    The sum the reference pilot chain forms per frame with nmodes^2 stacked
    virtual inputs and block-diagonal taps (pilot_chain.py:698-715), over
    all frames at once. P: (2*nmodes, L) float32; wx: (nout, nmodes, ntaps)
    complex64; offs: (nout, nframes) int64 window starts, each window of
    (frame_len - 1)*os + ntaps samples inside the capture. Returns
    (2, nout, nframes, frame_len) float32, [Re; Im]. With ``pilots`` =
    (poff, pstride, npil) it also returns the side output, the contiguous
    (2, nout, nframes, npil) copy of the outputs k = poff + p*pstride.
    """
    if pilots is not None:
        poff, pstride, npil = check_pilot_side(pilots, frame_len)
        out = apply_filter_frames_planes(P, os, wx, offs, frame_len)
        return out, out[..., poff:poff + (npil - 1) * pstride + 1:pstride].contiguous()
    nout, nmodes, ntaps = wx.shape
    fr_len = (frame_len - 1) * os + ntaps
    idx = offs[..., None] + torch.arange(fr_len, device=P.device)
    U = P[:, idx].unfold(-1, ntaps, os)          # (2*nmodes, nout, nframes, F, ntaps)
    Ur, Ui = U[:nmodes], U[nmodes:]
    wr, wi = wx.real.float(), wx.imag.float()
    outr = (torch.einsum("mifkt,imt->ifk", Ur, wr) - torch.einsum("mifkt,imt->ifk", Ui, wi))
    outi = (torch.einsum("mifkt,imt->ifk", Ur, wi) + torch.einsum("mifkt,imt->ifk", Ui, wr))
    return torch.stack([outr, outi])


#: the matmul precisions that the filter's float32 sums compute (JAX's names and aliases)
FILTER_PRECISIONS = ("HIGHEST", "FLOAT32")


def check_filter_precision(precision):
    """Refuse a filter ``precision`` below float32 (``None`` and HIGHEST are taken).

    The reference's ``precision`` picks the MXU's passes (its default HIGH,
    ~2^-22 relative); the port's filter sums every product in float32 with
    TF32 off, which is the reference's HIGHEST, so a string or an enum whose
    name is "highest" (or its alias "float32") is the one precision there is.
    """
    if precision is None:
        return
    name = str(getattr(precision, "name", precision)).upper()
    if name not in FILTER_PRECISIONS:
        raise ValueError("precision=%r: the port's filter sums in float32 with TF32 off (the "
                         "reference's HIGHEST); lower precisions are not computed"
                         % (precision,))


def apply_filter_to_signal(E, os, wx, precision=None):
    """Apply equaliser taps and downsample by os (reference pythran_equalisation.py:37-76).

    E: (nmodes, L) complex; returns (nout, Lout) complex64. ``precision``:
    None or "highest" (:func:`check_filter_precision`); the sums are float32
    either way.
    """
    check_filter_precision(precision)
    out = apply_filter_planes(planes(E), os, wx)
    nout = out.shape[0] // 2
    return torch.complex(out[:nout], out[nout:])


def apply_filter(E, os, wxy, modes=None, method=None):
    """Top-level apply_filter (reference equaliser.py:629-647), on the device of ``E``.

    A complex signal with complex taps goes through the port's filter
    (``equaliser_cuda.apply_filter``: kernel B2 on the card, two output
    modes per launch). Real-valued taps of shape (2n, 2n, ntaps): a strided
    real FIR over the stacked [Re; Im] signal, which the reference computes
    in XLA outside any Pallas kernel (``apply_filter_to_signal``,
    equaliser.py:509); here it is one plain float32 contraction over the
    unfolded signal (a library convolution would round to TF32 on the
    card). ``modes`` selects tap rows; ``method`` is accepted for API
    compatibility and ignored.
    """
    from qampy_tpu_torch.ops import equaliser_cuda
    wxy = torch.as_tensor(wxy, device=E.device)
    rows = np.arange(wxy.shape[0]) if modes is None else np.atleast_1d(np.asarray(modes))
    w = wxy[torch.as_tensor(rows, device=E.device)]
    if E.is_complex() and w.is_complex():
        P = planes(E)
        w = w.to(torch.complex64)
        outs = [equaliser_cuda.apply_filter(P, int(os), w[j:j + 2]) for j in range(0, len(w), 2)]
        return torch.cat([torch.complex(*o.chunk(2)) for o in outs])
    if w.is_complex():
        raise ValueError("complex taps need a complex signal")
    if E.is_complex():
        E = _convert_sig_to_real(E)
    out = torch.einsum("klt,jkt->jl", E.float().unfold(-1, w.shape[-1], int(os)), w.float())
    return _convert_sig_to_cmplx(out, rows.shape[0])


#: the reference keeps a pure-python apply_filter variant; here there is one
apply_filter_py = apply_filter


# ---------------------------------------------------------------------------
# entry functions
# ---------------------------------------------------------------------------

def _cal_training_symbol_len(os, ntaps, L):
    """Default training length (reference equaliser.py:654)."""
    return int(L // os // ntaps - 1) * int(ntaps)


def _resolve_backend(backend, block_size, on_cpu, block_kernel_ok=False):
    """Resolve ``backend="auto"`` and ``block_size=None`` for the tensor's device.

    "auto" is the exact per-symbol trainer for a CPU tensor, as in the
    reference (equaliser.py:697-716). On the card it is a block trainer:
    kernel B1 ("cuda_block") where ``block_kernel_ok`` (a bool, or a
    function of the resolved block size) says that B1 takes the method, the
    alphabet and the launch
    (:func:`block_kernel_takes`), else the plain block trainer ("block"),
    which takes every method, width, codebook and block size. That is a
    rule of "auto" alone: an explicit kernel backend raises on what its
    kernel does not take. ``block_size=None`` is 32 for the per-symbol
    trainers and for a block trainer on the CPU, 128 for a block trainer on
    the card. Explicit values always win.
    """
    if backend not in BACKENDS:
        raise ValueError("unknown backend %r: one of %s" % (backend, BACKENDS))
    if backend == "auto" and not on_cpu:
        block_size = 128 if block_size is None else block_size
        ok = block_kernel_ok(block_size) if callable(block_kernel_ok) else block_kernel_ok
        backend = "cuda_block" if ok else "block"
    elif backend == "auto":
        backend = "seq"
    if block_size is None:
        block_size = 128 if backend in ("block", "cuda_block") and not on_cpu else 32
    return backend, block_size


def _to_device(E, device):
    """The signal as a complex64 (or float32) tensor on ``device`` (None: the card)."""
    E = torch.as_tensor(E).to(resolve_device(device))
    return E.to(torch.complex64) if E.is_complex() else E.float()


def equalise_signal(E, os, mu, M, wxy=None, Ntaps=None, TrSyms=None, Niter=1,
                    method="mcma", adaptive_stepsize=False, symbols=None, modes=None,
                    apply=False, backend="auto", block_size=None,
                    avoid_cma_sing=False, device=None):
    """Blind/data-aided adaptive equalisation of a (nmodes, L) signal (reference :719-814).

    ``E`` (a tensor or a host array) is taken to ``device``; None means the
    card, and without one that raises: pass ``device="cpu"`` for the CPU.
    ``backend``: "seq" (the exact per-symbol recurrence) and "block"
    (block-LMS) are the plain trainers and take every method; "cuda" is
    kernel B9 (cma, sgncma, mcma, rde) and "cuda_block" kernel B1 (those
    and sbd, mddma, dd on a square, rectangular or cross grid or a general
    alphabet of up to 256 points), the counterparts of the reference's
    "pallas" and "pallas_block"; on a CPU tensor they run their plain
    versions under the same restrictions, and what they do not take raises
    with the limit and the backend to take instead. "auto": see
    :func:`_resolve_backend`.
    ``avoid_cma_sing`` (dual-pol only) trains mode 0 first and initialises
    mode 1 opposite-orthogonal to it before training mode 1.
    Returns (wxy, err) or (Eest, wxy, err) when apply=True, as tensors.
    """
    from qampy_tpu_torch.ops import equaliser_cuda
    method = method.lower()
    E = _to_device(E, device)
    dev = E.device
    if avoid_cma_sing:
        if E.shape[0] != 2 or method in REAL_VALUED:
            raise ValueError("avoid_cma_sing needs a dual-pol complex signal")
        if modes is not None:
            raise ValueError("avoid_cma_sing trains both modes; do not pass modes=")
        kw = dict(Ntaps=Ntaps, TrSyms=TrSyms, Niter=Niter, method=method,
                  adaptive_stepsize=adaptive_stepsize, symbols=symbols, apply=False,
                  backend=backend, block_size=block_size, device=dev)
        w0, err0 = equalise_signal(E, os, mu, M, wxy=wxy, modes=[0], **kw)
        w_init = torch.stack([w0[0], torch.conj_physical(w0[0].flip(0, 1))])
        w1, err1 = equalise_signal(E, os, mu, M, wxy=w_init, modes=[1], **kw)
        err = torch.stack([err0[0], err1[1]])
        if apply:
            return apply_filter(E, os, w1), w1, err
        return w1, err
    real_valued = method in REAL_VALUED
    if real_valued:
        E = _convert_sig_to_real(E) if E.is_complex() else E
    elif not E.is_complex():
        raise ValueError("method %r needs a complex signal" % method)
    nmodes = E.shape[0]
    if modes is None:
        modes = np.arange(nmodes)
    else:
        modes = np.atleast_1d(np.asarray(modes))
        if real_valued:
            modes = np.hstack([modes, modes + nmodes // 2])
        if np.max(modes) >= nmodes:
            raise ValueError("largest mode number is larger than shape of signal")
    hdtype = np.float32 if real_valued else np.complex64
    if wxy is None:
        wxy = torch.as_tensor(_init_taps(Ntaps, nmodes, nmodes, hdtype), device=dev)
    else:
        wxy = torch.as_tensor(wxy, device=dev).to(E.dtype)
        if wxy.dim() != 3:
            raise ValueError("wxy needs to be three dimensional")
        Ntaps = wxy.shape[-1]
    TrSyms = int(_cal_training_symbol_len(os, Ntaps, E.shape[-1]) if TrSyms is None else TrSyms)
    if isinstance(symbols, torch.Tensor):
        symbols = symbols.cpu().numpy()
    symbols = _reshape_symbols(symbols, method, M, hdtype, nmodes)
    kern_method = method[:-5] if real_valued else method
    wsel, ssel = wxy[torch.as_tensor(modes, device=dev)], symbols[modes]
    args = (TrSyms, int(Niter), int(os), float(mu), wsel)

    def block_kernel_ok(bs):
        # the launcher's rules look at shapes only: a stand-in of the planes' shape will do
        like = torch.empty((2 * nmodes, E.shape[-1]), device="meta")
        return block_kernel_takes(kern_method, ssel, len(modes), real_valued,
                                  launch=(like, TrSyms, int(os), wsel, bs))
    backend, block_size = _resolve_backend(backend, block_size, dev.type == "cpu",
                                           block_kernel_ok)
    adaptive = bool(adaptive_stepsize)
    if backend == "seq":
        out = train_equaliser_seq(E, *args, ssel, kern_method, adaptive, real_valued)
    elif backend == "block":
        out = train_equaliser_block(E, *args, ssel, kern_method, adaptive, real_valued,
                                    block_size)
    else:
        takes = SEQ_KERNEL_METHODS if backend == "cuda" else BLOCK_METHODS
        if real_valued or method not in takes:
            raise NotImplementedError("backend %r trains the complex methods %s, not %r: "
                                      "take 'seq' or 'block'" % (backend, takes, method))
        if backend == "cuda":
            out = equaliser_cuda.train_seq(planes(E), *args, ssel, method, adaptive)
        else:
            out = equaliser_cuda.train_block(planes(E), *args, err_spec(method, ssel),
                                             adaptive, block_size)
    err_sel, wsel_out, _ = out
    if np.array_equal(modes, np.arange(nmodes)):
        wxy, err = wsel_out, err_sel
    else:
        # only the requested modes were trained; the other rows pass through
        rows = torch.as_tensor(modes, device=dev)
        wxy = wxy.index_copy(0, rows, wsel_out)
        err = torch.zeros((nmodes, err_sel.shape[-1]), dtype=err_sel.dtype,
                          device=dev).index_copy(0, rows, err_sel)
    if apply:
        return apply_filter(E, os, wxy, modes=modes), wxy, err
    return wxy, err


def dual_mode_equalisation(E, os, mu, M, wxy=None, Ntaps=None, TrSyms=(None, None),
                           Niter=(1, 1), methods=("mcma", "sbd"),
                           adaptive_stepsize=(False, False), symbols=None, modes=None,
                           apply=True, backend="auto", block_size=None,
                           avoid_cma_sing=(False, False), device=None):
    """Two-stage equalisation: stage-1 taps warm-start stage 2 (reference :817-846).

    Per-stage pairs as in the reference; ``device``, ``backend`` and
    ``block_size`` as in :func:`equalise_signal`.
    Returns (Eest, wxy, (err1, err2)), or (wxy, (err1, err2)) with apply=False.
    """
    E = _to_device(E, device)
    if isinstance(symbols, torch.Tensor):
        symbols = symbols.cpu().numpy()
    symbols = np.atleast_1d(symbols) if symbols is not None else None
    if symbols is not None and symbols.ndim < 3:
        symbols = np.tile(symbols, (2, 1, 1))
    s0, s1 = (symbols[0], symbols[1]) if symbols is not None else (None, None)
    kw = dict(modes=modes, backend=backend, block_size=block_size, device=E.device)
    wxy1, err1 = equalise_signal(E, os, mu[0], M, wxy=wxy, Ntaps=Ntaps, TrSyms=TrSyms[0],
                                 Niter=Niter[0], method=methods[0],
                                 adaptive_stepsize=adaptive_stepsize[0], symbols=s0,
                                 avoid_cma_sing=avoid_cma_sing[0], **kw)
    wxy2, err2 = equalise_signal(E, os, mu[1], M, wxy=wxy1, TrSyms=TrSyms[1],
                                 Niter=Niter[1], method=methods[1],
                                 adaptive_stepsize=adaptive_stepsize[1], symbols=s1,
                                 avoid_cma_sing=avoid_cma_sing[1], **kw)
    if apply:
        return apply_filter(E, os, wxy2, modes=modes), wxy2, (err1, err2)
    return wxy2, (err1, err2)


def CDcomp(E, fs, N, L, D, wl, device=None):
    """Chromatic dispersion compensation, overlap-add blockwise FFT (reference :849-880).

    ``E`` goes to ``device`` (None: the card). With N = 0 the whole signal
    is filtered in one FFT; otherwise blocks of N/2 samples are zero-padded
    into N, filtered and overlap-added. float32 throughout, as the
    reference computes it. Returns (compensated signal, frequency response H).
    """
    E = _to_device(E, device).flatten()
    samp = E.shape[0]
    c = 2.99792458e8
    if N == 0:
        N = samp
    omega = np.float32(np.pi * fs) * torch.linspace(-1, 1, N, dtype=torch.float32,
                                                    device=E.device)
    beta2 = D * wl ** 2 / (c * 2 * np.pi)
    ph = -.5 * (omega ** 2 * np.float32(beta2) * np.float32(L))
    H = torch.complex(torch.cos(ph), torch.sin(ph))
    if N == samp:
        sigEQ = torch.fft.fftshift(torch.fft.fft(E)) * H
        return torch.fft.ifft(torch.fft.ifftshift(sigEQ)), H
    n = N // 2
    zp = N // 4
    B = samp // n
    # blocks of n samples zero-padded into N = 2n, filtered, overlap-added:
    # block i lands on output rows i and i + 1 of n samples each
    sigB = torch.fft.ifft(torch.fft.fft(F.pad(E[:B * n].reshape(B, n), (zp, N - n - zp)),
                                        dim=-1) * H, dim=-1)
    if N != 2 * n or n != 2 * zp:
        raise ValueError("the block length N must be a multiple of 4, got %d" % N)
    sigEQ = torch.zeros((B + 1, n), dtype=sigB.dtype, device=E.device)
    sigEQ[:B] += sigB[:, :n]
    sigEQ[1:] += sigB[:, n:]
    return sigEQ.reshape(-1)[zp:-zp], H
