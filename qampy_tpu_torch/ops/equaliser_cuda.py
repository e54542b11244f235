"""Kernels B1 (block-LMS trainer), B2 (strided MIMO filter) and B9 (per-symbol LMS trainer).

Each kernel has three functions here: ``*_cuda`` launches the CUDA kernel
of ``csrc/equaliser.cu`` (and raises on anything but contiguous CUDA
tensors), ``*_plain`` is its plain PyTorch version, and the bare name
dispatches on the device of the input: the plain version for a CPU tensor,
the kernel for a CUDA tensor. ``*_cuda.launches`` counts kernel launches;
each ``*_cuda`` runs inside the host span ``qtt.B<k>`` of its kernel
(``profiling.spanned``), recorded while a ``torch.profiler`` records.

B1 replaces ``qampy_tpu/ops/equaliser_pallas.py:train_equaliser_block_pallas``,
B9 ``train_equaliser_pallas`` and B2 ``apply_filter_pallas_planes``, in two
entries: the whole-capture filter of the blind chain and the frame-batched
filter of the pilot chain (``apply_filter_frames``). The source note in the
.cu file says what bounds each on the card and how its design answers that.
The trainers B1 and B9 are bound by the latency of a chain of dependent
steps: ``chain_latencies`` (``csrc/probe.cu``) measures the latencies that
their chain bounds are reckoned from, and ``div_check`` holds B9's
straight-line division against ``__fdiv_rn``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops._build import KernelLimit
from qampy_tpu_torch.ops.equaliser import (BLOCK_METHODS, DECISION_BLOCK_METHODS,
                                           SEQ_KERNEL_METHODS, apply_filter_planes,
                                           check_pilot_side, planes_errfn, spec_rows, step_sizes,
                                           train_seq_planes)
from qampy_tpu_torch.ops.equaliser import apply_filter_frames_planes as apply_filter_frames_plain
from qampy_tpu_torch.ops.equaliser import train_block_planes as train_block_plain
from qampy_tpu_torch.profiling import spanned

# csrc/equaliser.cu: Method
_METHOD_CODE = {"mcma": 0, "mddma": 1, "cma": 2, "sgncma": 2, "rde": 3, "sbd": 4, "dd": 5}
_MAX_OUT = 2                     # csrc/equaliser.cu kMaxOut
_MAX_CODES = 64                  # csrc/equaliser.cu kMaxCodes: longest [codes, partitions] row
_MAX_SEQ_K = 128                 # csrc/equaliser.cu kSeqTapsPerLane * 32: nmodes * ntaps of B9
_SMEM_LIMIT = 227 * 1024         # shared memory one CTA may use on Hopper
_BLOCK_THREADS = 256             # csrc/equaliser.cu kBlockThreads
_RING = 3                        # csrc/equaliser.cu kRing
_MAX_SLICES = 32                 # csrc/equaliser.cu kMaxSlices
_MAX_BATCH = 65535               # B1's batch rows: the grid's y extent


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

def method_code(method, takes=BLOCK_METHODS):
    """The trainer kernels' code of ``method``, which must be one of ``takes``."""
    if method not in takes:
        raise NotImplementedError("trainer kernel method %r: the kernel takes %s; backends "
                                  "'block' and 'seq' take every method" % (method, takes))
    return _METHOD_CODE[method]


def _codebook_len(rows):
    """Entries of the per-output [codes, partitions] rows, which the kernels hold at most 64 of."""
    k = len(rows[0])
    if k > _MAX_CODES:
        raise KernelLimit("rde codebook row of %d entries: the trainer kernels hold %d "
                          "(_MAX_CODES); take backend 'block' or 'seq'" % (k, _MAX_CODES))
    return k


def _block_batch(P, wx):
    """The batch rows B of a B1 launch.

    Planes (2n, L) are one row, (B, 2n, L) B rows; taps (nout, n, t) are
    shared by the rows, (B, nout, n, t) one set per row.
    """
    if (P.dim() not in (2, 3) or wx.dim() not in (3, P.dim() + 1)
            or P.shape[-2] != 2 * wx.shape[-2]):
        raise ValueError("planes of shape %s do not match taps %s"
                         % (tuple(P.shape), tuple(wx.shape)))
    nbatch = P.shape[0] if P.dim() == 3 else 1
    if wx.dim() == 4 and wx.shape[0] != nbatch:
        raise ValueError("taps of %d batch rows for planes of %d" % (wx.shape[0], nbatch))
    if nbatch < 1 or nbatch > _MAX_BATCH:
        raise KernelLimit("the trainer kernel takes 1 to %d batch rows (_MAX_BATCH), got %d; "
                          "take backend 'block'" % (_MAX_BATCH, nbatch))
    return nbatch


def block_launch_shape(P, TrSyms, os, wx, block_size):
    """(S, nblocks) of a B1 launch; ``KernelLimit`` for what the kernel does not take.

    P: (2*nmodes, L) planes, or (B, 2*nmodes, L) with a batch axis; wx:
    (nout, nmodes, ntaps) taps, or (B, nout, nmodes, ntaps), one row each.
    Arguments that no backend takes (planes that do not match the taps, a
    capture shorter than the training) raise a plain ValueError. Looks at
    shapes only, so it holds for tensors on any device. The
    kernel's block S is the algorithm's (``block_size``, or ``TrSyms`` if
    that is shorter), a multiple of 32 up to 1024; its CTA has a fixed
    number of threads whatever S is.
    """
    _block_batch(P, wx)
    nout, nmodes, ntaps = wx.shape[-3:]
    if nout > _MAX_OUT:
        raise KernelLimit("the trainer kernel takes at most %d output modes (_MAX_OUT), got %d; "
                          "take backend 'block' or 'seq'" % (_MAX_OUT, nout))
    if int(os) < 1:
        raise ValueError("oversampling %r" % (os,))
    S = min(int(block_size), int(TrSyms))
    if S < 32 or S % 32 or S > 1024:
        raise KernelLimit("block size %d: the kernel takes a multiple of 32 up to 1024; take "
                          "backend 'block' for any block size" % S)
    nblocks = int(TrSyms) // S
    L = P.shape[-1]
    if L < (nblocks * S - 1) * os + ntaps:
        raise ValueError("capture of %d samples is shorter than the %d training "
                         "windows need" % (L, (nblocks * S - 1) * os + ntaps))
    return S, nblocks


def block_smem_bytes(nmodes, ntaps, os, S, npts=0):
    """Shared-memory bytes of one B1 CTA: ``block_layout`` of csrc/equaliser.cu on the host.

    ``npts``: points of a general alphabet (three floats each). The launcher
    holds this against ``qtt_train_block_smem`` of the built library.
    """
    segq = (S * os + ntaps + 8 + 3) & ~3
    ntw = (ntaps + 2 + 3) & ~3
    items = nmodes * ((ntaps + 3) // 4) if os == 2 else nmodes * ntaps
    nsl = min(1 if items >= _BLOCK_THREADS else _BLOCK_THREADS // items, _MAX_SLICES)
    per = -(-S // nsl)
    per += per & 1
    nsl = -(-S // per)
    ring = _RING * 2 * nmodes * segq
    taps = 2 * nmodes * ntw
    parts = 2 * nsl * nmodes * ntw
    errors = 2 * S + 2 * S + 4
    barriers = 2 * _RING + 2
    return 4 * (ring + taps + parts + errors + barriers + 3 * npts)


def check_block_launch(P, TrSyms, os, wx, block_size, spec):
    """(S, nblocks, shared-memory bytes) of a B1 launch, or KernelLimit: the launcher's own rules.

    Everything :func:`train_block_cuda` refuses apart from the tensors'
    device and type, decided on the host from shapes and the spec alone, so
    that ``backend="auto"`` can ask before it routes (``block_kernel_takes``).
    """
    S, nblocks = block_launch_shape(P, TrSyms, os, wx, block_size)
    method_code(spec.method)
    nout, nmodes, ntaps = wx.shape[-3:]
    npts = 0
    if spec.method == "rde":
        _codebook_len(spec_rows(spec, nout))
    elif (spec.method in DECISION_BLOCK_METHODS
          and phops.grid_decision_info(spec.consts)[0] == "gen"):
        npts = phops.gen_points(spec.consts).shape[0]
    smem = block_smem_bytes(nmodes, ntaps, int(os), S, npts)
    if smem > _SMEM_LIMIT:
        raise KernelLimit("the trainer kernel needs %d bytes of shared memory for %d taps and "
                          "blocks of %d, a CTA has %d; take a shorter block or backend 'block'"
                          % (smem, ntaps, S, _SMEM_LIMIT))
    return S, nblocks, smem


def _decision_args(spec, device, points):
    """(kind code, d0, g0..g3, table pointer, npts, table) of a decision method's launch.

    The constants of ``ops.phase.grid_consts`` in the alphabet's units; a
    general alphabet has its (M, 3) table instead (``points`` if the caller
    holds it on the card).
    """
    gc = phops.grid_consts(spec.consts, spec.method)
    table = phops.points_tensor(spec.consts, device, points)
    return (gc.code, gc.d0, *gc.g, None if table is None else table.data_ptr(),
            0 if table is None else table.shape[0], table)


@spanned("qtt.B1")
def train_block_cuda(P, TrSyms, Niter, os, mu, wx, spec, adaptive=False, block_size=32,
                     points=None):
    """Launch kernel B1; same contract as :func:`train_block_plain`.

    P: (2*nmodes, L) float32 CUDA planes, or (B, 2*nmodes, L): B batch rows
    in one launch, one CTA per (row, output mode); wx: (nout, nmodes, ntaps)
    complex64 taps on the same device, shared by the rows, or (B, nout,
    nmodes, ntaps), one set per row; ``spec`` an ``ErrSpec``, shared by the
    rows; ``points`` a general alphabet's table on the card for sbd, mddma
    and dd (``ops.phase.points_tensor``; copied from the host if not
    given). Returns (err (nout, Niter*Ts) complex64, taps, mu (nout,)
    float32), each with the leading batch axis of ``P`` if it has one. A
    row's result does not depend on the other rows.
    """
    _build.require_cuda("train_block_cuda", P, dtype=torch.float32)
    _build.require_cuda("train_block_cuda", wx, dtype=torch.complex64,
                        contiguous=False)
    if wx.device != P.device:
        raise ValueError("train_block_cuda: taps and planes lie on different devices")
    S, nblocks, smem = check_block_launch(P, TrSyms, os, wx, block_size, spec)
    nbatch = _block_batch(P, wx)
    nout, nmodes, ntaps = wx.shape[-3:]
    lead = P.shape[:-2]
    Ts = nblocks * S
    L = P.shape[-1]
    code = method_code(spec.method)
    c = [0.0] * 4
    dargs = (0, 1.0, 0.0, 0.0, 0.0, 0.0, None, 0, None)
    codes, ncodes = None, 0
    if spec.method == "mcma":
        c = [x for pair in spec_rows(spec, nout) for x in pair] + [0.0] * (4 - 2 * nout)
    elif spec.method == "cma":
        c = [x for r in spec_rows(spec, nout) for x in (r, 0.0)] + [0.0] * (4 - 2 * nout)
    elif spec.method == "rde":
        codes = torch.tensor(spec_rows(spec, nout), dtype=torch.float32, device=P.device)
        ncodes = codes.shape[-1]
    else:
        dargs = _decision_args(spec, P.device, points)
    lib = _build.library()
    if lib.qtt_train_block_smem(nmodes, nout, ntaps, os, S, dargs[7]) != smem:
        raise RuntimeError("block_smem_bytes and csrc/equaliser.cu block_layout disagree")
    K = nmodes * ntaps

    def rows(x):
        return x.reshape(*wx.shape[:-2], K).expand(*lead, nout, K).clone(
            memory_format=torch.contiguous_format)
    wr, wi = rows(wx.real), rows(wx.imag)
    mu_t = torch.full((*lead, nout), mu, dtype=torch.float32, device=P.device)
    err_r = torch.empty((*lead, nout, int(Niter) * Ts), dtype=torch.float32, device=P.device)
    err_i = torch.empty_like(err_r)
    rc = lib.qtt_train_block(P.data_ptr(), nmodes, L, wr.data_ptr(), wi.data_ptr(),
                             mu_t.data_ptr(), err_r.data_ptr(), err_i.data_ptr(), nout,
                             nbatch, ntaps, os, S, nblocks, int(Niter), code,
                             *c, *dargs[:8], None if codes is None else codes.data_ptr(),
                             ncodes, int(bool(adaptive)), _build.stream_of(P))
    _build.check(rc, "train_block_cuda")
    train_block_cuda.launches += 1
    return (torch.complex(err_r, err_i),
            torch.complex(wr, wi).reshape(*lead, nout, nmodes, ntaps), mu_t)


train_block_cuda.launches = 0


def train_block(P, TrSyms, Niter, os, mu, wx, spec, adaptive=False, block_size=32, points=None):
    """Block-LMS training: the plain version on CPU tensors, kernel B1 on CUDA.

    ``points``: see :func:`train_block_cuda`; the plain version reads the host table.
    """
    if P.device.type == "cpu":
        return train_block_plain(P, TrSyms, Niter, os, mu, wx, spec, adaptive, block_size)
    return train_block_cuda(P, TrSyms, Niter, os, mu, wx, spec, adaptive, block_size, points)


# ---------------------------------------------------------------------------
# B9: per-symbol LMS trainer
# ---------------------------------------------------------------------------

def _seq_symbols(symbols, method, nout, device):
    """The (nout, k) complex64 rows of ``symbols`` on ``device``, checked against ``method``."""
    method_code(method, SEQ_KERNEL_METHODS)
    syms = torch.as_tensor(symbols, device=device).to(torch.complex64)
    if syms.dim() != 2 or syms.shape[0] != nout:
        raise ValueError("symbols of shape %s for %d output modes" % (tuple(syms.shape), nout))
    return syms


def train_seq_plain(P, TrSyms, Niter, os, mu, wx, symbols, method, adaptive=False):
    """Plain version of kernel B9: ``train_seq_planes`` for the kernel's methods.

    P: (2*nmodes, L) float32 planes; wx: (nout, nmodes, ntaps) complex64;
    symbols: (nout, k) per-mode rows (host array or tensor). Returns (err
    (nout, Niter*TrSyms) complex64, taps, mu (nout,) float32).
    """
    syms = _seq_symbols(symbols, method, wx.shape[0], P.device)
    return train_seq_planes(P, TrSyms, Niter, os, mu, wx.to(torch.complex64),
                            planes_errfn(method, syms), adaptive)


def seq_launch_shape(P, TrSyms, os, wx):
    """K = nmodes * ntaps of a B9 launch; ``KernelLimit`` for what the kernel does not take.

    Looks at shapes only. The kernel has an instance per taps per lane,
    ceil(K / 32) from 1 to 4, so K may not exceed 128.
    """
    _, nmodes, ntaps = wx.shape
    if P.dim() != 2 or P.shape[0] != 2 * nmodes:
        raise ValueError("planes of shape %s do not match taps %s"
                         % (tuple(P.shape), tuple(wx.shape)))
    K = nmodes * ntaps
    if K < 1 or K > _MAX_SEQ_K:
        raise KernelLimit("the per-symbol trainer kernel holds %d taps per output mode "
                          "(_MAX_SEQ_K), got %d x %d; take backend 'seq', or 'cuda_block'"
                          % (_MAX_SEQ_K, nmodes, ntaps))
    if int(os) < 1:
        raise ValueError("oversampling %r" % (os,))
    if int(TrSyms) < 1 or P.shape[-1] < (int(TrSyms) - 1) * int(os) + ntaps:
        raise ValueError("capture of %d samples is shorter than the %d training "
                         "windows need" % (P.shape[-1], (int(TrSyms) - 1) * int(os) + ntaps))
    return K


@spanned("qtt.B9")
def train_seq_cuda(P, TrSyms, Niter, os, mu, wx, symbols, method, adaptive=False):
    """Launch kernel B9; same contract as :func:`train_seq_plain`.

    Unlike the reference's kernel, which returns zeros for it
    (equaliser_pallas.py:17-18, 163), the error trace is the real one, as
    ``train_equaliser_seq`` returns it. ``mu`` is a float or the (nout,)
    steps an earlier launch returned: with a fixed step a training cut into
    launches that hand taps and steps on equals the whole one bit for bit
    (the adaptive rule also keeps the previous error, which starts anew).
    """
    _build.require_cuda("train_seq_cuda", P, dtype=torch.float32)
    _build.require_cuda("train_seq_cuda", wx, dtype=torch.complex64, contiguous=False)
    if wx.device != P.device:
        raise ValueError("train_seq_cuda: taps and planes lie on different devices")
    nout, nmodes, ntaps = wx.shape
    K = seq_launch_shape(P, TrSyms, os, wx)
    TrSyms, Niter, os = int(TrSyms), int(Niter), int(os)
    L = P.shape[-1]
    syms = _seq_symbols(symbols, method, nout, P.device)
    # (2, nout, k) float32: the real parts, then the imaginary parts
    sym_planes = torch.stack([syms.real, syms.imag]).contiguous()
    k = syms.shape[-1]
    if k > _MAX_CODES:
        raise KernelLimit("symbols row of %d entries: the trainer kernels hold %d (_MAX_CODES); "
                          "take backend 'seq' or 'block'" % (k, _MAX_CODES))
    wr = wx.real.reshape(nout, K).clone(memory_format=torch.contiguous_format)
    wi = wx.imag.reshape(nout, K).clone(memory_format=torch.contiguous_format)
    mu_t = step_sizes(mu, nout, P.device)
    err_r = torch.empty((nout, Niter * TrSyms), dtype=torch.float32, device=P.device)
    err_i = torch.empty_like(err_r)
    rc = _build.library().qtt_train_seq(
        P.data_ptr(), nmodes, L, wr.data_ptr(), wi.data_ptr(), mu_t.data_ptr(),
        err_r.data_ptr(), err_i.data_ptr(), sym_planes.data_ptr(), k, nout, ntaps, os, TrSyms,
        Niter, method_code(method, SEQ_KERNEL_METHODS), int(bool(adaptive)),
        _build.stream_of(P))
    _build.check(rc, "train_seq_cuda")
    train_seq_cuda.launches += 1
    return (torch.complex(err_r, err_i), torch.complex(wr, wi).reshape(nout, nmodes, ntaps),
            mu_t)


train_seq_cuda.launches = 0


def train_seq(P, TrSyms, Niter, os, mu, wx, symbols, method, adaptive=False):
    """Per-symbol LMS training: the plain version on CPU tensors, kernel B9 on CUDA."""
    fn = train_seq_plain if P.device.type == "cpu" else train_seq_cuda
    return fn(P, TrSyms, Niter, os, mu, wx, symbols, method, adaptive)


# ---------------------------------------------------------------------------
# what bounds the trainers: the card's latencies, and B9's division
# ---------------------------------------------------------------------------

LATENCY_KEYS = ("fadd", "ffma", "shuffle_add", "lookup_add", "shared_load", "barrier")


def chain_latencies(device, threads=256, iters=4096):
    """The latencies that bound B1 and B9, measured on ``device`` by ``csrc/probe.cu``.

    Returns a dict: cycles per dependent repetition of a float add, a fused
    multiply-add, a shuffle and add (one butterfly step), rde's register
    lookup and an add (ballot, popc, shuffle, add), a shared-memory load and a CTA barrier
    of ``threads`` threads; ``ghz`` (the SM clock while it ran); and, with
    all ``threads`` at work, SM cycles per warp-wide 16-byte shared-memory
    load (``lds128_per_sm``) and per warp-wide FFMA (``ffma_per_sm``).
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("chain_latencies measures a CUDA card: got %s" % device)
    lib = _build.library()
    out = torch.zeros(lib.qtt_probe_values(), dtype=torch.float32, device=device)
    arg = torch.tensor([1e-3, 1.0, 7.0], dtype=torch.float32, device=device)
    _build.check(lib.qtt_probe_latency(out.data_ptr(), arg.data_ptr(), int(iters), int(threads),
                                       _build.stream_of(out)), "chain_latencies")
    vals = out.tolist()
    return dict(zip(LATENCY_KEYS, vals), ghz=vals[6], lds128_per_sm=vals[8], ffma_per_sm=vals[9])


def div_check(a, b):
    """How many quotients a / b B9's straight-line division rounds unlike ``__fdiv_rn``."""
    _build.require_cuda("div_check", a, b, dtype=torch.float32)
    if a.shape != b.shape:
        raise ValueError("div_check: operands of shapes %s and %s" % (tuple(a.shape),
                                                                     tuple(b.shape)))
    differ = torch.zeros(1, dtype=torch.int32, device=a.device)
    _build.check(_build.library().qtt_div_check(a.data_ptr(), b.data_ptr(), a.numel(),
                                                differ.data_ptr(), _build.stream_of(a)),
                 "div_check")
    return int(differ)


# ---------------------------------------------------------------------------
# B2: strided MIMO filter with a decimated side output
# ---------------------------------------------------------------------------

def apply_filter_plain(P, os, wx, dec=None):
    """Plain filter: (2*nout, Lout) planes, plus out[:, ::dec] when ``dec`` is given."""
    out = apply_filter_planes(P, os, wx)
    if dec is None:
        return out
    return out, out[:, ::dec].contiguous()


#: csrc/equaliser.cu: threads of a CTA per output mode, taps per step, the outputs per thread
#: that each entry's plan takes (in order: it shrinks the run while the grid has fewer than
#: ``FILTER_MIN_CTAS`` CTAs), and the largest grid
FILTER_THREADS, FILTER_CHUNK, FILTER_MIN_CTAS = 128, 4, 264
FILTER_FRAME_RUNS, FILTER_PLANES_RUNS = (10, 6, 2), (6, 2)
_MAX_GRID = 2 ** 31 - 1


class FilterPlan(NamedTuple):
    """A B2 launch (csrc/equaliser.cu ``FilterPlan``), of either entry.

    ``run``: consecutive outputs per thread; ``tile``: outputs per CTA and
    output mode; ``chunk``: taps per step (the tap table is zero-padded to a
    multiple); ``threads``: of a CTA, ``FILTER_THREADS`` per output mode that
    a frame CTA computes (its group, one launch each); ``seg``: staged
    samples per plane and window (a frame window is staged from its 16-byte
    aligned start, seg + 4 samples; two whose aligned starts lie less than
    ``seg`` apart are staged as one union); ``smem``: shared-memory bytes of
    a CTA; ``ctas``: CTAs of the grid (of every group's launch).
    """
    run: int
    tile: int
    chunk: int
    threads: int
    seg: int
    smem: int
    ctas: int


def _plan_at(nmodes, nout, group, ntaps, os, Lout, nframes, run):
    """The plan at a given run and group of output modes per frame CTA (csrc ``filter_plan_at``)."""
    tile = FILTER_THREADS * run
    ntp = -(-ntaps // FILTER_CHUNK) * FILTER_CHUNK
    seg = (tile * os + ntp + 3) & ~3
    # a frame CTA stages each output mode's window from its 16-byte aligned start: a row
    # holds group windows of seg + 4
    x = 2 * nmodes * (group * (seg + 4) if nframes > 0 else seg)
    smem = 4 * (max(x, 2 * group * tile) + ntp * nmodes * group * 2)
    rows = nframes * -(-nout // group) if nframes > 0 else 1
    return FilterPlan(run, tile, FILTER_CHUNK, FILTER_THREADS * (group if nframes > 0 else 1),
                      seg, smem, rows * -(-Lout // tile))


def filter_plan(nmodes, nout, ntaps, os, Lout, nframes=0):
    """The :class:`FilterPlan` of B2 on the host; ``nframes`` = 0: the planes entry.

    The run is the first of the entry's (``FILTER_FRAME_RUNS`` or
    ``FILTER_PLANES_RUNS``: the planes entry, whose threads sum two output
    modes, needs 168 registers at runs of 10, and was measured slower there)
    whose CTA fits the shared memory, shortened while the grid has fewer
    than ``FILTER_MIN_CTAS`` CTAs, so that short rows still fill the card. A
    frame CTA computes a group of two output modes (one for the last of an
    odd ``nout``), or of one where two fit at no run. A CTA stages ``seg`` =
    tile * os + the padded taps, rounded up to 4, samples of each of the 2 *
    nmodes planes (the frame entry room for a window of seg + 4 per output
    mode of its group), the tap table, and shares the staging with its
    output tile. A plan whose ``smem`` passes 227 KB is refused by the
    launchers, which hold it against ``qtt_filter_plan`` of the built library.
    """
    frames = nframes > 0
    runs = FILTER_FRAME_RUNS if frames else FILTER_PLANES_RUNS
    groups = ((2, 1) if nout > 1 else (1,)) if frames else (nout,)
    for group in groups:
        def at(k):
            return _plan_at(nmodes, nout, group, ntaps, os, Lout, nframes, runs[k])
        k = 0
        while k < len(runs) - 1 and at(k).smem > _SMEM_LIMIT:
            k += 1
        plan = at(k)
        if plan.smem > _SMEM_LIMIT:
            continue
        while k < len(runs) - 1 and plan.ctas < FILTER_MIN_CTAS:
            k += 1
            plan = at(k)
        return plan
    return plan


def check_filter_plan(nmodes, nout, ntaps, os, Lout, nframes=0, what="B2"):
    """The :class:`FilterPlan` of a launch, or ``KernelLimit`` if it fits no CTA or grid.

    Decided on the host from the shapes alone, so a chain can ask when it is
    built for the card.
    """
    plan = filter_plan(nmodes, nout, ntaps, os, Lout, nframes)
    if plan.smem > _SMEM_LIMIT:
        raise KernelLimit("%s: filter too long for one CTA's shared memory (%d bytes for %d taps, "
                          "a CTA has %d)" % (what, plan.smem, ntaps, _SMEM_LIMIT))
    if plan.ctas > _MAX_GRID:
        raise KernelLimit("%s: %d CTAs, a grid takes at most %d" % (what, plan.ctas, _MAX_GRID))
    return plan


def _checked_plan(lib, what, nmodes, nout, ntaps, os, Lout, nframes=0):
    """The plan of a launch, refused if it does not fit a CTA or a grid, held against the card's."""
    plan = check_filter_plan(nmodes, nout, ntaps, os, Lout, nframes, what)
    built = (ctypes.c_longlong * len(plan))()
    lib.qtt_filter_plan(nmodes, nout, ntaps, os, Lout, nframes, ctypes.addressof(built))
    if tuple(built) != plan:
        raise RuntimeError("filter_plan and csrc/equaliser.cu filter_plan disagree: %s, %s"
                           % (plan, tuple(built)))
    return plan


@spanned("qtt.B2")
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
        raise ValueError("the filter kernel takes at most %d output modes per launch (_MAX_OUT), "
                         "got %d; ops.equaliser.apply_filter filters them two at a time"
                         % (_MAX_OUT, nout))
    L = P.shape[-1]
    if L < ntaps:
        raise ValueError("capture shorter than the filter")
    os = int(os)
    Lout = (L - ntaps) // os + 1
    lib = _build.library()
    _checked_plan(lib, "apply_filter_cuda", nmodes, nout, ntaps, os, Lout)
    w = torch.view_as_real(wx.resolve_conj().contiguous())   # no copy for contiguous taps
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


# ---------------------------------------------------------------------------
# B2, frame entry: the filter over many frame windows in one launch
# ---------------------------------------------------------------------------

@spanned("qtt.B2")
def apply_filter_frames_cuda(P, os, wx, offs, frame_len, pilots=None):
    """Launch the frame entry of kernel B2; same contract as :func:`apply_filter_frames_plain`.

    offs: (nout, nframes) int64 window starts on the card (they are read
    there, never on the host). Returns (2, nout, nframes, frame_len), and
    with ``pilots`` = (poff, pstride, npil) also the (2, nout, nframes, npil)
    side output of the outputs k = poff + p*pstride, which each thread stores
    from its run's registers. One CTA per (frame, tile) holds a
    group of two output modes, one launch per group (see :func:`filter_plan`;
    the pilot chain's two modes are one launch); any number of output modes
    and frames is taken up to a grid of 2^31 - 1 CTAs.
    """
    _build.require_cuda("apply_filter_frames_cuda", P, dtype=torch.float32)
    _build.require_cuda("apply_filter_frames_cuda", offs, dtype=torch.int64)
    _build.require_cuda("apply_filter_frames_cuda", wx, dtype=torch.complex64,
                        contiguous=False)
    if len({P.device, wx.device, offs.device}) > 1:
        raise ValueError("apply_filter_frames_cuda: tensors lie on different devices")
    nout, nmodes, ntaps = wx.shape
    if P.dim() != 2 or P.shape[0] != 2 * nmodes:
        raise ValueError("planes of shape %s do not match taps %s"
                         % (tuple(P.shape), tuple(wx.shape)))
    if offs.dim() != 2 or offs.shape[0] != nout:
        raise ValueError("offsets of shape %s: expected (%d, nframes)" % (tuple(offs.shape), nout))
    nframes = offs.shape[1]
    lib = _build.library()
    plan = _checked_plan(lib, "apply_filter_frames_cuda", nmodes, nout, ntaps, int(os),
                         int(frame_len), nframes)
    w = torch.view_as_real(wx.resolve_conj().contiguous())   # no copy for contiguous taps
    out = torch.empty((2, nout, nframes, frame_len), dtype=torch.float32, device=P.device)
    poff, pstride, npil = 0, 1, 0
    side = None
    if pilots is not None:
        poff, pstride, npil = check_pilot_side(pilots, frame_len)
        side = torch.empty((2, nout, nframes, npil), dtype=torch.float32, device=P.device)
    rc = lib.qtt_apply_filter_frames(P.data_ptr(), nmodes, P.shape[-1], w.data_ptr(),
                                     offs.data_ptr(), nout, nframes, ntaps, int(os),
                                     int(frame_len), out.data_ptr(), poff, pstride, npil,
                                     None if side is None else side.data_ptr(),
                                     _build.stream_of(P))
    _build.check(rc, "apply_filter_frames_cuda")
    apply_filter_frames_cuda.launches += -(-nout // (plan.threads // FILTER_THREADS))
    return out if side is None else (out, side)


apply_filter_frames_cuda.launches = 0


def apply_filter_frames(P, os, wx, offs, frame_len, pilots=None):
    """Frame-batched MIMO filter: the plain version on CPU tensors, kernel B2 on CUDA.

    With ``pilots`` = (poff, pstride, npil) it also returns the pilot side output.
    """
    fn = apply_filter_frames_plain if P.device.type == "cpu" else apply_filter_frames_cuda
    return fn(P, os, wx, offs, frame_len, pilots)
