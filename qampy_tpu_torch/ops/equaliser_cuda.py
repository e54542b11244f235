"""Kernels B1 (block-LMS trainer) and B2 (strided MIMO filter) with their wrappers.

Each kernel has three functions here: ``*_cuda`` launches the CUDA kernel
of ``csrc/equaliser.cu`` (and raises on anything but contiguous CUDA
tensors), ``*_plain`` is its plain PyTorch version, and the bare name
dispatches on the device of the input: the plain version for a CPU tensor,
the kernel for a CUDA tensor. ``*_cuda.launches`` counts kernel launches.

B1 replaces ``qampy_tpu/ops/equaliser_pallas.py:train_equaliser_block_pallas``
and B2 ``apply_filter_pallas_planes``; the source note in the .cu file says
what bounds each on the card and how its design answers that.
"""
from __future__ import annotations

import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops.equaliser import apply_filter_planes, mcma_rows
from qampy_tpu_torch.ops.equaliser import train_block_planes as train_block_plain

_METHOD_CODE = {"mcma": 0, "mddma": 1}
_MAX_OUT = 2                     # csrc/equaliser.cu kMaxOut
_SMEM_LIMIT = 227 * 1024         # shared memory one CTA may use on Hopper


def filter_group(os, ntaps, nout):
    """Phase group G of the reference filter kernel (0 = unsupported).

    The reference accepts a side-output stride ``dec`` only when it divides
    G (equaliser_pallas.py:479-485, :595); the port keeps the same rule.
    """
    nop = 2 * nout
    for g in range(min(128 // max(nop, 1), (128 - ntaps) // os + 1), 0, -1):
        if 128 % (g * os) == 0:
            return g
    return 0


def check_dec(os, ntaps, nout, dec):
    """Raise ValueError unless the reference would take side-output stride ``dec``."""
    G = filter_group(os, ntaps, nout)
    if dec < 1 or G < 2 or G % dec != 0:
        raise ValueError("side-output stride %d does not divide the filter's phase "
                         "group %d (os=%d, ntaps=%d, nout=%d)" % (dec, G, os, ntaps, nout))


# ---------------------------------------------------------------------------
# B1: block-LMS trainer
# ---------------------------------------------------------------------------

def train_block_cuda(P, TrSyms, Niter, os, mu, wx, spec, adaptive=False, block_size=32):
    """Launch kernel B1; same contract as :func:`train_block_plain`.

    P: (2*nmodes, L) float32 CUDA planes; wx: (nout, nmodes, ntaps)
    complex64 taps on the same device; ``spec`` an ``ErrSpec``.
    Returns (err (nout, Niter*Ts) complex64, taps, mu (nout,) float32).
    """
    _build.require_cuda("train_block_cuda", P, dtype=torch.float32)
    _build.require_cuda("train_block_cuda", wx, dtype=torch.complex64,
                        contiguous=False)
    if wx.device != P.device:
        raise ValueError("train_block_cuda: taps and planes lie on different devices")
    nout, nmodes, ntaps = wx.shape
    if P.dim() != 2 or P.shape[0] != 2 * nmodes:
        raise ValueError("planes of shape %s do not match taps %s"
                         % (tuple(P.shape), tuple(wx.shape)))
    if nout > _MAX_OUT:
        raise ValueError("the trainer kernel takes at most %d output modes" % _MAX_OUT)
    S = min(int(block_size), int(TrSyms))
    if S < 32 or S % 32 or S > 1024:
        raise ValueError("block size %d: the kernel runs one thread per sample and "
                         "needs a multiple of 32 up to 1024" % S)
    nblocks = int(TrSyms) // S
    Ts = nblocks * S
    L = P.shape[-1]
    if L < (Ts - 1) * os + ntaps:
        raise ValueError("capture of %d samples is shorter than the %d training "
                         "windows need" % (L, (Ts - 1) * os + ntaps))
    if spec.method not in _METHOD_CODE:
        raise NotImplementedError("trainer kernel method %r is ROADMAP item A7" % spec.method)
    lib = _build.library()
    smem = lib.qtt_train_block_smem(nmodes, nout, ntaps, os, S)
    if smem > _SMEM_LIMIT:
        raise ValueError("trainer needs %d bytes of shared memory" % smem)
    if spec.method == "mcma":
        c = [x for pair in mcma_rows(spec, nout) for x in pair] + [0.0] * (4 - 2 * nout)
        d0 = lo = nm1 = 0.0
    else:
        c = [0.0] * 4
        d0, lo, n = spec.consts
        nm1 = float(n - 1)
    K = nmodes * ntaps
    wr = wx.real.reshape(nout, K).clone(memory_format=torch.contiguous_format)
    wi = wx.imag.reshape(nout, K).clone(memory_format=torch.contiguous_format)
    mu_t = torch.full((nout,), mu, dtype=torch.float32, device=P.device)
    err_r = torch.empty((nout, int(Niter) * Ts), dtype=torch.float32, device=P.device)
    err_i = torch.empty_like(err_r)
    rc = lib.qtt_train_block(P.data_ptr(), nmodes, L, wr.data_ptr(), wi.data_ptr(),
                             mu_t.data_ptr(), err_r.data_ptr(), err_i.data_ptr(), nout,
                             ntaps, os, S, nblocks, int(Niter), _METHOD_CODE[spec.method],
                             *c, d0, lo, nm1, int(bool(adaptive)), _build.stream_of(P))
    _build.check(rc, "train_block_cuda")
    train_block_cuda.launches += 1
    return (torch.complex(err_r, err_i), torch.complex(wr, wi).reshape(nout, nmodes, ntaps),
            mu_t)


train_block_cuda.launches = 0


def train_block(P, TrSyms, Niter, os, mu, wx, spec, adaptive=False, block_size=32):
    """Block-LMS training: the plain version on CPU tensors, kernel B1 on CUDA."""
    fn = train_block_plain if P.device.type == "cpu" else train_block_cuda
    return fn(P, TrSyms, Niter, os, mu, wx, spec, adaptive, block_size)


# ---------------------------------------------------------------------------
# B2: strided MIMO filter with a decimated side output
# ---------------------------------------------------------------------------

def apply_filter_plain(P, os, wx, dec=None):
    """Plain filter: (2*nout, Lout) planes, plus out[:, ::dec] when ``dec`` is given."""
    out = apply_filter_planes(P, os, wx)
    if dec is None:
        return out
    return out, out[:, ::dec].contiguous()


def apply_filter_cuda(P, os, wx, dec=None):
    """Launch kernel B2; same contract as :func:`apply_filter_plain`."""
    _build.require_cuda("apply_filter_cuda", P, dtype=torch.float32)
    _build.require_cuda("apply_filter_cuda", wx, dtype=torch.complex64,
                        contiguous=False)
    if wx.device != P.device:
        raise ValueError("apply_filter_cuda: taps and planes lie on different devices")
    nout, nmodes, ntaps = wx.shape
    if P.dim() != 2 or P.shape[0] != 2 * nmodes:
        raise ValueError("planes of shape %s do not match taps %s"
                         % (tuple(P.shape), tuple(wx.shape)))
    if nout > _MAX_OUT:
        raise ValueError("the filter kernel takes at most %d output modes" % _MAX_OUT)
    L = P.shape[-1]
    if L < ntaps:
        raise ValueError("capture shorter than the filter")
    lib = _build.library()
    if lib.qtt_apply_filter_smem(nmodes, nout, ntaps, os) > _SMEM_LIMIT:
        raise ValueError("filter too long for one CTA's shared memory")
    Lout = (L - ntaps) // os + 1
    w = torch.stack([wx.real, wx.imag]).contiguous()   # (2, nout, nmodes, ntaps)
    out = torch.empty((2 * nout, Lout), dtype=torch.float32, device=P.device)
    outd = None
    Ld = 0
    if dec is not None:
        Ld = -(-Lout // dec)
        outd = torch.empty((2 * nout, Ld), dtype=torch.float32, device=P.device)
    rc = lib.qtt_apply_filter(P.data_ptr(), nmodes, L, w.data_ptr(), nout, ntaps, os, Lout,
                              out.data_ptr(), dec or 1, Ld,
                              None if outd is None else outd.data_ptr(), _build.stream_of(P))
    _build.check(rc, "apply_filter_cuda")
    apply_filter_cuda.launches += 1
    return out if dec is None else (out, outd)


apply_filter_cuda.launches = 0


def apply_filter(P, os, wx, dec=None):
    """Strided MIMO filter: the plain version on CPU tensors, kernel B2 on CUDA.

    With ``dec`` it also returns the stride-``dec`` side output; ``dec``
    must divide the reference kernel's phase group (:func:`check_dec`).
    """
    if dec is not None:
        check_dec(os, wx.shape[-1], wx.shape[0], dec)
    fn = apply_filter_plain if P.device.type == "cpu" else apply_filter_cuda
    return fn(P, os, wx, dec)
