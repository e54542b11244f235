"""The blind RX chain (counterpart of ``qampy_tpu/ops/chain.py``).

``make_rx_chain`` returns an :class:`RxChain` module running the reference's
blind receiver on float32 [Re rows; Im rows] planes. Every mode starts with

1. two adaptive block-LMS trainings on the TrSyms prefix (MCMA, then MDDMA),
   with the CMA singularity guard between them (kernel B1);
2. the strided MIMO filter over the whole capture (kernel B2);

and then recovers the carrier phase in one of four ways:

- ``decimated[K]``: the blind phase search on the filter's stride-K side
  output (B3), the decimated pi/2 unwrap and per-block (a, b) coefficients
  (B10, :func:`decimated_derotation_inputs`), and the full-rate
  piecewise-linear derotation (B4);
- ``single`` (the reference's default): the search over all bps_angles on
  every sample (B3), its phase -pi/4 + (pi/2/A) idx, then the pi/2 unwrap
  and derotation (B7);
- ``twostage``/``twostage32``: a coarse search over max(A/4, 16) (or
  max(A/2, 16)) angles with half-window 60 (B3), the fine search over 8
  per-sample offsets with half-window bps_N (B8), then B7;
- ``twostage-dec``: the coarse search over max(A/4, 16) angles with
  half-window bps_N on the filter's stride-8 side output (B3), its phase
  held over the 8 samples of each step, the fine search over 8 offsets at
  full rate (B8), then B7.

A ``decimated[K]`` whose K does not divide the filter's phase group falls
back to ``single`` with the reference's warning; a ``twostage-dec`` whose
group 8 does not divide, or on a general alphabet, takes ``twostage``, as
the reference does. The route switches of the reference follow its
branches (:class:`RxChain` has the table): ``pallas=False`` runs the
reference's XLA algorithm on the port's kernels, ``fuse_derot=False`` its
unfused derotation, ``bps_win="bf16"`` its bf16 window sums in tiles of
``bps_tile``. On CPU tensors each kernel runs its plain PyTorch version; on
CUDA tensors the kernels run, with no fallback. The two trainings take the
methods of kernel B1 (cma, sgncma, mcma, rde, sbd, mddma, dd); another
method raises ``NotImplementedError``.

The constellation is M-QAM (square, or cross for an odd number of bits) or
any host alphabet given as ``symbols=``: whatever ``ops.phase.detect_grid``
classifies, a general alphabet ("gen") up to 256 points, as in the
reference. The decision stages and the searches decide on that alphabet.
For a gen alphabet of more than 24 points the twostage and decimated modes
first ask two host probes (``coarse_grid_for_alphabet``, ``fine_grid_ok``)
whether a fitted uniform grid may stand in for the alphabet in the coarse
search, and in the fine (or the decimated mode's only) search too; the
trainer always decides on the true alphabet. ``backend_info`` says which
decision each search took.

Two divergences from the reference, both toward float32: the filter sums
in float32 (the reference chain contracts in bf16), and ``bps_win``
defaults to "f32" (the reference's default is "bf16"; every recorded time,
gate and CPU comparison of the port is float32, and "bf16" is taken).

While a ``torch.profiler`` records, each entry call is one host span
``qtt.rx.<entry>`` holding its stages' spans in order (``qtt.rx.train``,
``qtt.rx.filter``, ``qtt.rx.search``, then ``qtt.rx.glue`` in decimated or
``qtt.rx.fine`` in the two-stage modes, ``qtt.rx.derotate``) and, inside
them, the kernel launchers' ``qtt.B<k>`` (``profiling.span``). In the
two-stage modes ``qtt.rx.search`` holds the coarse search (B3) alone and
``qtt.rx.fine`` the coarse phase built from its indices and the fine search
(B8).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.equaliser_cuda import apply_filter, check_dec, train_block
from qampy_tpu_torch.ops.phase import grid_decision_info
from qampy_tpu_torch.ops.phase_cuda import (bps_fine, bps_search, interp_rotate, rotate,
                                            unwrap_derotate, unwrap_slopes)
from qampy_tpu_torch.profiling import span, spanned
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.utils import resolve_device

#: the coarse stage's half-window of the two-stage search (reference chain.py:410-416)
TWOSTAGE_N1 = 60
#: per-sample offsets of the fine stage (reference chain.py:414)
TWOSTAGE_B = 8

__all__ = ["RxChain", "make_rx_chain", "pallas_eligibility", "decimated_derotation_inputs",
           "cma_singularity_guard"]

_HALF_PI = float(np.float32(np.pi / 2))


def pallas_eligibility(grid, methods, block_size=None, bps_tile=None):
    """Whether the chain's CUDA kernels take this: (ok, reasons tuple).

    The reference's name (``qampy_tpu/ops/chain.py:34``), which asks the
    same of its Pallas kernels. This asks the launch rules the port already
    has, on the host, and adds none:

    - the constellation: ``grid_decision_info`` of an ``ops.phase.detect_grid``
      spec; B1, B3 and B8 decide on a square, cross or rectangular grid and
      on a general alphabet of up to ``ops.phase.MAX_GEN_POINTS`` points;
    - the methods: those B1 trains (``ops.equaliser.BLOCK_METHODS``);
    - ``block_size``: B1's block, as its launcher takes it
      (``equaliser_cuda.block_launch_shape``: a multiple of 32 up to 1024);
    - ``bps_tile``: the tile of the bf16 window sums, a multiple of 128 as in
      the reference (B3 and B8 tile their float32 searches by their own
      launch plans, ``phase_cuda.bps_plan``, whatever the caller's tile).

    Where the rules differ from the reference's: a general alphabet (a ring,
    a warped grid) is eligible here and not there, and a block of 32 or 64 is
    eligible here and not there (its 128-lane rule). Unlike the reference, an
    ineligible chain does not fall back: on the card the chain raises where a
    kernel refuses.
    """
    from qampy_tpu_torch.ops._build import KernelLimit
    from qampy_tpu_torch.ops.equaliser_cuda import block_launch_shape
    reasons = []
    kind = grid_decision_info(grid)[0]
    if kind == "none":
        reasons.append("constellation of fewer than two points")
    elif kind == "gen" and len(phops.gen_points(grid)) > phops.MAX_GEN_POINTS:
        reasons.append("general alphabet of %d points: the kernels search at most %d"
                       % (len(phops.gen_points(grid)), phops.MAX_GEN_POINTS))
    bad = [m for m in methods if m not in eqops.BLOCK_METHODS]
    if bad:
        reasons.append("method(s) %s not trained by the block trainer kernel (%s)"
                       % (bad, ", ".join(eqops.BLOCK_METHODS)))
    if block_size is not None:
        S, ntaps = int(block_size), 17
        like_P = torch.empty((4, 2 * S + ntaps), device="meta")
        like_w = torch.empty((2, 2, ntaps), dtype=torch.complex64, device="meta")
        try:
            block_launch_shape(like_P, S, 2, like_w, S)
        except KernelLimit as e:
            reasons.append(str(e))
    if bps_tile is not None and bps_tile % 128 != 0:
        reasons.append("bps_tile=%d is not a multiple of 128" % bps_tile)
    return not reasons, tuple(reasons)


def decimated_derotation_inputs(eqr, eqi, idxd, lo_a, step_a, dec):
    """The glue between the phase search and the derotation (chain.py:349-369).

    idxd: (nmodes, Ld) int32 best-angle indices on the decimated grid. The
    decimated phase lo_a + step_a*idx gets a pi/2 unwrap (floor(x+0.5)
    jump counts, summed in int32); block j of dec full-rate samples then
    takes a = phu[j], b = (phu[j+1] - phu[j])/dec, with the last slope 0
    (``phase_cuda.unwrap_slopes``: kernel B10 on CUDA, its plain version on
    the CPU). The (nmodes, Lout) filter planes, Ld = ceil(Lout/dec), go to
    the derotation as they came: its last block may be partial.
    Returns (eqr, eqi, a, b).
    """
    a, b = unwrap_slopes(idxd, lo_a, step_a, dec)
    return eqr, eqi, a, b


def cma_singularity_guard(w):
    """Re-initialise tap row 1 orthogonal to row 0 when both rows converged onto one source.

    The CMA polarisation-demux singularity guard between the two trainings
    (reference chain.py:255-270, Liu et al. OFC'09): when the stage-1 rows
    of the dual-pol taps ``w`` (2, 2, Ntaps) are nearly parallel, row 1
    becomes conj(w[0][::-1, ::-1]) and stage 2 retrains it. A tensor
    select, with no host round trip.
    """
    f0, f1 = w[0].reshape(-1), w[1].reshape(-1)
    inner = torch.abs(torch.vdot(f0, f1))
    n01 = torch.sqrt(torch.sum(torch.abs(f0) ** 2) * torch.sum(torch.abs(f1) ** 2))
    orth = torch.conj_physical(w[0].flip(0, 1))[None]
    return torch.where(inner > 0.9 * n01, torch.cat([w[:1], orth]), w)


class RxChain(nn.Module):
    """Blind dual-pol receiver in one of the carrier-recovery modes of the module docstring.

    Build it with :func:`make_rx_chain`. Entries, as in the reference:
    ``forward(E)`` (complex in and out), ``planes(P)`` ((outr, outi) from
    stacked float32 planes), ``with_taps``/``planes_with_taps`` (also return
    the frozen taps) and ``tracking``/``tracking_planes`` (demodulate with
    given taps, skipping both trainings). ``mode`` is "decimated" (with
    stride ``dec``), "single", "twostage" or "twostage-dec" (stride 8);
    ``bps_cos``/``bps_sin`` hold the angle tables of the one B3 search a
    call runs (the coarse grid in the two-stage modes, whose fine offsets
    are ``fine_cos``/``fine_sin``). ``grid`` is the constellation's grid
    spec, on which the trainer decides; ``search_grid`` and ``fine_grid``
    are what B3 and B8 search (``grid``, or a general alphabet's fitted
    grid); ``gen_points`` is a general alphabet's table on the chain's
    device, registered when a stage reads it; ``backend_info`` reports the
    decisions as the reference does.

    The reference's route switches, branch by branch (its chain.py:198-440);
    "kernels" is the reference's Pallas branch, ``pallas=None`` or True here
    (on CPU tensors the plain twins run it, the reference's interpret mode):

    ==============  =================================  ===================================
    mode            pallas None/True (kernels)         pallas False (the XLA algorithm)
    ==============  =================================  ===================================
    decimated[K]    B2 with the stride-K side output,  warns, runs single
                    B3 (tile min(bps_tile, 8192)),
                    B10, B4
    single          B2, B3 (tile bps_tile), unwrap     B2, B3 in float32, then the
                    and derotation                     unfused unwrap and B6
    twostage[32]    B2, B3 (N1 = 60), B8, unwrap and   B2, then ``ops.phase.bps_twostage``
                    derotation (both tiles bps_tile)   (N1 = 60: B3, B8 in float32, its
                                                       unwrap, B6)
    twostage-dec    B2 with the stride-8 side output,  as twostage
                    B3 there (A/4 angles, bps_N, tile
                    min(bps_tile, 8192)), the phase
                    held 8 samples, B8 (tile
                    bps_tile), unwrap and derotation
    ==============  =================================  ===================================

    "unwrap and derotation" is B7 with ``fuse_derot=True`` and, with
    ``fuse_derot=False``, the reference's unfused ``_derotate``: its own
    pi/2 unwrap (floor(d / (pi/2) + 0.5) jumps, summed in float32), then the
    rotation by B6. ``bps_win="bf16"`` sums B3's and B8's windows in bf16 on
    the kernels' branch, in the reference's order over tiles of the table's
    tile (``ops.phase.bf16_window_sums``); the XLA branch sums in float32.
    On a general alphabet the windows stay float32 unless the fitted grid
    passes both probes (reference chain.py:136-172), and ``twostage-dec``
    takes ``twostage``. ``bps_tile`` is a multiple of 128 above every
    window 2N it tiles; with bf16 windows 2N is at most 128.
    """

    def __init__(self, M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3,
                 bps_angles=64, bps_N=14, block_size=256, TrSyms=None,
                 bps_mode="single", pallas=None, bps_tile=16384, bps_win="f32",
                 fuse_derot=True, symbols=None):
        super().__init__()
        if len(methods) != 2:
            raise ValueError("the chain trains two stages, got methods=%r" % (methods,))
        if bps_win not in ("f32", "bf16"):
            raise ValueError("bps_win is 'f32' or 'bf16', got %r" % (bps_win,))
        dtype = np.complex64
        if symbols is not None:
            # the blind constants come from the alphabet's own moments (reference
            # chain.py:112-125)
            const = np.asarray(symbols).astype(dtype).reshape(-1)
            rows = [eqops.generate_symbols_for_eq_from_alphabet(m, const, dtype)
                    if m in eqops.BLOCK_METHODS else None for m in methods]
            rows = [None if r is None else np.tile(r, (2, 1)) if r.shape[0] == 1 else r
                    for r in rows]
        else:
            const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
            rows = [eqops._reshape_symbols(None, m, M, dtype, 2)
                    if m in eqops.BLOCK_METHODS else None for m in methods]
        self.const = const
        self.grid = phops.detect_grid(const)
        kind = grid_decision_info(self.grid)[0]
        if kind == "none":
            raise ValueError("the chain needs a constellation of at least two points, got %d"
                             % const.size)
        if kind == "gen" and const.size > phops.MAX_GEN_POINTS:
            raise ValueError("a general alphabet of %d points: the chain's kernels search at "
                             "most %d (ops.phase.MAX_GEN_POINTS), as the reference's do"
                             % (const.size, phops.MAX_GEN_POINTS))
        self.specs = tuple(eqops.err_spec(m, r) for m, r in zip(methods, rows))
        self.Ntaps, self.os, self.mu = int(Ntaps), int(os), float(mu)
        self.bps_N, self.block_size, self.TrSyms = int(bps_N), int(block_size), TrSyms
        self.pallas, self.fuse_derot = True if pallas is None else bool(pallas), bool(fuse_derot)
        self.bps_tile = int(bps_tile)
        self.mode, self.dec = self._resolve_mode(bps_mode, kind)
        twostage = self.mode in ("twostage", "twostage-dec")
        A = bps_angles
        if twostage:
            A = max(bps_angles // (2 if bps_mode.endswith("32") else 4), 16)
        self.A = A
        self.search_N = TWOSTAGE_N1 if self.mode == "twostage" else self.bps_N
        # a general alphabet's fitted grid, where the host probes accept it (reference
        # chain.py:150-172), by the mode's name: probed at the coarse angle count of a
        # two-stage mode and at the full count in decimated, whose one search has the fine
        # stage's role; the probes also decide the window type
        coarse_fit, self.fine_grid, win = None, self.grid, bps_win if kind != "gen" else "f32"
        if (kind == "gen" and bps_mode.startswith(("twostage", "decimated"))
                and const.size > 24):
            div = 1 if bps_mode.startswith("decimated") else 2 if bps_mode.endswith("32") else 4
            a0 = max(bps_angles // div, 16)
            coarse_fit = phops.coarse_grid_for_alphabet(const, Mtestangles=a0)
            if coarse_fit is not None and phops.fine_grid_ok(const, coarse_fit, Mtestangles=a0):
                self.fine_grid, win = coarse_fit, bps_win
        self.bps_win = win if self.pallas else "f32"
        if self.mode == "twostage":
            self.search_grid = self.grid if coarse_fit is None else coarse_fit
        else:
            self.search_grid = self.fine_grid if self.mode == "decimated" else self.grid
        # the tiles of the kernels' branch (reference chain.py:347, 384, 412, 436)
        self.search_tile = (min(self.bps_tile, 8192) if self.dec is not None else self.bps_tile)
        self._check_tiles(bps_tile)
        self.backend_info = {
            "pallas": self.pallas, "grid_kind": kind, "bps_mode": bps_mode,
            "mode": self.mode, "methods": tuple(methods), "bps_win": self.bps_win,
            "fuse_derot": self.fuse_derot,
            "gen_bps_coarse": "fitted" if coarse_fit is not None else "exact",
            "gen_bps_fine": "fitted" if self.fine_grid is not self.grid else "exact"}
        angles = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
        self.step_a, self.lo_a = float(np.pi / 2 / A), float(-np.pi / 4)
        cos_h, sin_h = phops.bps_tables(angles, self.search_grid)
        self.register_buffer("w0", torch.as_tensor(eqops._init_taps(Ntaps, 2, 2, dtype)))
        self.register_buffer("bps_cos", torch.as_tensor(cos_h))
        self.register_buffer("bps_sin", torch.as_tensor(sin_h))
        if twostage:
            cd, sd, self.fine_d0, self.fine_step = phops.fine_tables(A, TWOSTAGE_B,
                                                                     self.fine_grid)
            self.register_buffer("fine_cos", torch.as_tensor(cd))
            self.register_buffer("fine_sin", torch.as_tensor(sd))
        # the table of the alphabet's points, if the trainer's decision or a search reads it:
        # put on the card once, here, so that no dispatch copies from the host
        searched = [self.search_grid] + ([self.fine_grid] if twostage else [])
        reads = kind == "gen" and (any(g is self.grid for g in searched)
                                   or any(s.method in eqops.DECISION_BLOCK_METHODS
                                          for s in self.specs))
        self.register_buffer("gen_points",
                             torch.as_tensor(phops.gen_points(self.grid)) if reads else None)

    def _resolve_mode(self, bps_mode, kind):
        """(mode, stride of the filter's side output or None) of a ``bps_mode`` name.

        The reference's dispatch (chain.py:280-292, 326-440): a decimated
        mode needs the kernels' filter with a phase group that the stride
        divides, and warns and runs ``single`` without it; ``twostage-dec``
        needs the same for 8 and an analytic grid, and runs ``twostage``
        without them.
        """
        if bps_mode == "twostage-dec":
            ok = self.pallas and kind != "gen" and self._dec_refused(8) is None
            return ("twostage-dec", 8) if ok else ("twostage", None)
        if bps_mode.startswith("twostage"):
            return "twostage", None
        if bps_mode == "single":
            return "single", None
        if not bps_mode.startswith("decimated"):
            raise ValueError("unknown bps_mode %r: 'single', 'twostage', 'twostage32', "
                             "'twostage-dec' or 'decimated[K]'" % (bps_mode,))
        dec = int(bps_mode[len("decimated"):] or 8)
        if dec < 1:
            raise ValueError("bps_mode=%r: the decimation stride must be positive" % (bps_mode,))
        why = ("pallas=False filters without a side output" if not self.pallas
               else self._dec_refused(dec))
        if why is not None:
            warnings.warn("bps_mode=%r needs a phase group divisible by the stride (%s); "
                          "falling back to the single-grid BPS" % (bps_mode, why), stacklevel=4)
            return "single", None
        return "decimated", dec

    def _dec_refused(self, dec):
        """Why the filter has no stride-``dec`` side output here (None where it has one)."""
        try:
            check_dec(self.os, self.Ntaps, 2, dec)
        except ValueError as e:
            return str(e)
        return None

    def _check_tiles(self, bps_tile):
        """Refuse a ``bps_tile`` the kernels' branch does not tile, as the reference's asserts
        (phase_pallas.py:245-246, 522): a multiple of 128 above each window 2N, and 2N <= 128
        with bf16 windows."""
        if self.bps_tile < 128 or self.bps_tile % 128:
            raise ValueError("bps_tile=%r is not a positive multiple of 128" % (bps_tile,))
        if not self.pallas:
            return
        tiles = [(self.search_tile, self.search_N)]
        if self.mode in ("twostage", "twostage-dec"):
            tiles.append((self.bps_tile, self.bps_N))
        for T, N in tiles:
            if self.bps_win == "bf16":
                phops.check_bf16_tile(N, T)
            elif 2 * N >= T:
                raise ValueError("bps_tile=%d: the window 2N=%d must fit in one tile"
                                 % (bps_tile, 2 * N))

    def _bf16(self, T):
        """The ``bf16_tile`` argument of a search at tile T: T with bf16 windows, else None."""
        return T if self.bps_win == "bf16" else None

    # -- stages -------------------------------------------------------------

    def train_taps(self, P):
        """Both blind trainings on the TrSyms prefix: the frozen (nmodes, nmodes, Ntaps) taps."""
        nmodes = P.shape[0] // 2
        trs = (P.shape[-1] - self.Ntaps) // self.os if self.TrSyms is None else self.TrSyms
        s1, s2 = self.specs
        _, w1, _ = train_block(P, trs, 1, self.os, self.mu, self.w0[:nmodes, :nmodes], s1,
                               adaptive=True, block_size=self.block_size, points=self.gen_points)
        if nmodes == 2:
            w1 = cma_singularity_guard(w1)
        _, w2, _ = train_block(P, trs, 1, self.os, self.mu, w1, s2,
                               adaptive=True, block_size=self.block_size, points=self.gen_points)
        return w2

    def equalise(self, P, w):
        """Filter the capture: (full-rate planes, stride-dec planes or None).

        The side output exists in decimated and twostage-dec."""
        if self.dec is None:
            return apply_filter(P, self.os, w), None
        return apply_filter(P, self.os, w, self.dec)

    def phase_search(self, x):
        """B3's best-angle indices (nmodes, L) on planes ``x`` (the decimated ones in decimated
        and twostage-dec).

        Over the chain's angle table with half-window ``search_N``, tiled at
        ``search_tile`` with bf16 windows.
        """
        no = x.shape[0] // 2
        return bps_search(x[:no], x[no:], self.bps_cos, self.bps_sin, self.search_grid,
                          self.search_N, self.gen_points, self._bf16(self.search_tile))

    def derotate(self, eqp, idxd):
        """Unwrap the decimated phase and derotate the full-rate planes: (outr, outi)."""
        no = eqp.shape[0] // 2
        with span("qtt.rx.glue"):
            er, ei, a, b = decimated_derotation_inputs(eqp[:no], eqp[no:], idxd, self.lo_a,
                                                       self.step_a, self.dec)
        with span("qtt.rx.derotate"):
            return interp_rotate(er, ei, a, b, self.dec, sign=1)

    def carrier_phase(self, eqp, decp=None):
        """The per-sample phase (nmodes, L) of the single and two-stage modes, before the unwrap.

        single: lo + step idx of B3's indices (reference chain.py:441);
        twostage: B3 on the coarse grid, then B8 (chain.py:412-418);
        twostage-dec: B3 on the side output ``decp``, its phase held over the
        stride, then B8 (chain.py:377-395). The two-stage modes are
        :meth:`phase_search`, then :meth:`fine_phase`.
        """
        idx = self.phase_search(eqp if decp is None else decp)
        if self.mode == "single":
            return self.lo_a + self.step_a * idx.to(torch.float32)
        return self.fine_phase(eqp, idx)

    def fine_phase(self, eqp, idx1):
        """The two-stage modes' per-sample phase (nmodes, L) before the unwrap, from the coarse
        search's indices ``idx1`` (:meth:`phase_search`).

        The coarse phase lo + step idx1 (held over the stride in twostage-dec,
        reference chain.py:377-395), then B8 around it over the fine offsets
        with half-window bps_N (chain.py:412-418).
        """
        no = eqp.shape[0] // 2
        ph1 = self.lo_a + self.step_a * idx1.to(torch.float32)
        if self.mode == "twostage-dec":
            ph1 = ph1[:, :, None].expand(-1, -1, self.dec).reshape(no, -1)[:, :eqp.shape[-1]]
        return bps_fine(eqp[:no], eqp[no:], ph1.contiguous(), self.fine_cos, self.fine_sin,
                        self.fine_grid, self.bps_N, self.fine_d0, self.fine_step,
                        self.gen_points, self._bf16(self.bps_tile))

    def unwrap_derotate(self, eqp, ph):
        """pi/2-unwrap the per-sample phase, derotate the full-rate planes: (outr, outi).

        B7 on the kernels' branch with ``fuse_derot``; else the reference's
        unfused ``_derotate`` (:meth:`unwrap_unfused`, then B6).
        """
        no = eqp.shape[0] // 2
        if self.pallas and self.fuse_derot:
            return unwrap_derotate(eqp[:no], eqp[no:], ph)
        return rotate(eqp[:no], eqp[no:], self.unwrap_unfused(ph), 1)

    @staticmethod
    def unwrap_unfused(ph):
        """The reference's unfused pi/2 unwrap (chain.py:204-215): u = ph + offs.

        offs is the float32 prefix sum of a_i = -(pi/2) floor(d_i / (pi/2) +
        0.5), d_i = ph_i - ph_{i-1}, a_0 = 0, each op rounded on its own
        (scanned in blocks, ``ops.phase.row_cumsum``).
        """
        d = ph[:, 1:] - ph[:, :-1]
        a = -_HALF_PI * torch.floor(d / _HALF_PI + 0.5)
        return ph + phops.row_cumsum(F.pad(a, (1, 0)))

    def _fwd(self, P, w=None):
        if P.is_complex() or P.dim() != 2 or P.shape[0] % 2:
            raise ValueError("expected stacked float32 [Re rows; Im rows] planes, got %s %s"
                             % (P.dtype, tuple(P.shape)))
        P = P.to(torch.float32).contiguous()
        w2 = w
        if w is None:
            with span("qtt.rx.train"):
                w2 = self.train_taps(P)
        with span("qtt.rx.filter"):
            eqp, decp = self.equalise(P, w2)
        if self.mode == "decimated":
            with span("qtt.rx.search"):
                idxd = self.phase_search(decp)
            return self.derotate(eqp, idxd), w2
        if self.mode == "twostage" and not self.pallas:
            # the reference's XLA two-stage path (chain.py:419-427): ops.phase.bps_twostage,
            # whose one call also derotates
            no = eqp.shape[0] // 2
            with span("qtt.rx.search"):
                out, _ = phops.bps_twostage(torch.complex(eqp[:no], eqp[no:]), self.A,
                                            self.const, self.bps_N, B=TWOSTAGE_B,
                                            N1=TWOSTAGE_N1)
            return (out.real.contiguous(), out.imag.contiguous()), w2
        if self.mode == "single":
            with span("qtt.rx.search"):
                ph = self.carrier_phase(eqp)
        else:
            with span("qtt.rx.search"):
                idx1 = self.phase_search(eqp if decp is None else decp)
            with span("qtt.rx.fine"):
                ph = self.fine_phase(eqp, idx1)
        with span("qtt.rx.derotate"):
            return self.unwrap_derotate(eqp, ph), w2

    # -- entries --------------------------------------------------------------

    @staticmethod
    def _stack(P, Pi):
        return P if Pi is None else torch.cat([P, Pi], dim=0)

    @spanned("qtt.rx.forward")
    def forward(self, E):
        """Complex (nmodes, L) capture at ``os`` samples/symbol in, recovered symbols out."""
        (outr, outi), _ = self._fwd(eqops.planes(E))
        return torch.complex(outr, outi)

    @spanned("qtt.rx.planes")
    def planes(self, P, Pi=None):
        """Planes entry: (2*nmodes, L) float32 [Re; Im] (or a (pr, pi) pair) -> (outr, outi)."""
        return self._fwd(self._stack(P, Pi))[0]

    @spanned("qtt.rx.with_taps")
    def with_taps(self, E):
        """``forward`` that also returns the frozen (nmodes, nmodes, Ntaps) taps."""
        (outr, outi), w = self._fwd(eqops.planes(E))
        return torch.complex(outr, outi), w

    @spanned("qtt.rx.planes_with_taps")
    def planes_with_taps(self, P, Pi=None):
        """``planes`` that also returns the frozen taps."""
        return self._fwd(self._stack(P, Pi))

    @spanned("qtt.rx.tracking")
    def tracking(self, E, wxy):
        """Warm-start entry: demodulate with given taps, skipping both trainings."""
        (outr, outi), _ = self._fwd(eqops.planes(E), wxy)
        return torch.complex(outr, outi)

    @spanned("qtt.rx.tracking_planes")
    def tracking_planes(self, P, wxy, Pi=None):
        """Planes twin of :meth:`tracking`."""
        return self._fwd(self._stack(P, Pi), wxy)[0]


def make_rx_chain(M=64, Ntaps=17, os=2, methods=("mcma", "mddma"), mu=1.9e-3,
                  bps_angles=64, bps_N=14, block_size=256, TrSyms=None,
                  bps_mode="single", pallas=None, bps_tile=16384, bps_win="f32",
                  fuse_derot=True, symbols=None, device=None):
    """Build the blind RX chain on ``device`` (see :class:`RxChain`).

    ``device=None`` is the card, and raises on a machine without one; pass
    ``device="cpu"`` for the CPU.

    Parameters follow the reference's ``make_rx_chain``, its route switches
    ``pallas``, ``bps_tile``, ``bps_win`` and ``fuse_derot`` included (the
    table of :class:`RxChain`). Two defaults differ: ``pallas=None`` takes
    the kernels' branch on every device (the reference's takes it off the
    CPU), and ``bps_win`` is "f32" (the reference's is "bf16").
    """
    return RxChain(M=M, Ntaps=Ntaps, os=os, methods=methods, mu=mu,
                   bps_angles=bps_angles, bps_N=bps_N, block_size=block_size,
                   TrSyms=TrSyms, bps_mode=bps_mode, pallas=pallas, bps_tile=bps_tile,
                   bps_win=bps_win, fuse_derot=fuse_derot,
                   symbols=symbols).to(resolve_device(device))
