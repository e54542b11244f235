"""Blind phase search: host grid logic and the plain PyTorch search.

Counterpart of ``qampy_tpu/ops/phase.py``: the numpy grid classification
(phase.py:30-128) that picks the analytic nearest-point decision, and the
plain form of the BPS index search (``bps_idx``/``_select_angle_index``,
phase.py:283-333) that the CUDA kernel in ``ops/phase_cuda.py`` is held
against, with the two-stage search's fine offsets and distances
(phase_pallas.py:447-478, 551-593). The distance to the nearest point has
the reference's four forms (``_make_dist_fn``, phase_pallas.py:88-158):
square and rectangular grids decide per axis, cross QAM takes the closer of
two rectangle clamps, and a general alphabet of up to 256 points searches
its points. The host probes that let a general alphabet's search run on a
fitted uniform grid (phase.py:131-231) are here too.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qampy_tpu_torch.ops._build import KernelLimit

#: most points of a general alphabet that the searches take (reference chain.py:182)
MAX_GEN_POINTS = 256


def detect_square_grid(symbols):
    """Detect a uniform full square grid constellation (host-side).

    Returns a hashable (delta, lo, n) tuple when ``symbols`` is the full
    product of n uniformly spaced real levels with itself (square QAM), else
    None.
    """
    s = np.asarray(symbols)
    if s.ndim != 1 or s.size < 4:
        return None
    re = np.unique(np.round(s.real, 6))
    im = np.unique(np.round(s.imag, 6))
    if re.size * im.size != s.size or re.size != im.size or re.size < 2:
        return None
    d = np.diff(re)
    if not (np.allclose(d, d[0], rtol=1e-3) and np.allclose(np.diff(im), d[0], rtol=1e-3)
            and np.allclose(re, im, rtol=1e-3)):
        return None
    return (float(d[0]), float(re[0]), int(re.size))


def _uniform_levels(vals):
    """(levels, spacing) when ``vals`` are uniformly spaced, else None."""
    if vals.size < 2:
        return None
    d = np.diff(vals)
    if not np.allclose(d, d[0], rtol=1e-3):
        return None
    return vals, float(d[0])


def detect_grid(symbols):
    """Classify a constellation for the analytic nearest-point decision.

    Returns ``(d, lo, n)`` for a full square grid, ``("x", d, lo, n, c)``
    for cross QAM (n x n grid minus c x c corners), ``("r", d, lor, nr,
    loi, ni)`` for a full rectangular grid, else ``("gen", sr, si)`` with
    the raw points.
    """
    sq = detect_square_grid(symbols)
    if sq is not None:
        return sq
    s = np.asarray(symbols)
    if s.ndim != 1 or s.size < 2:
        return None
    gen = ("gen", tuple(float(x) for x in s.real),
           tuple(float(x) for x in s.imag))
    re = _uniform_levels(np.unique(np.round(s.real, 6)))
    im = _uniform_levels(np.unique(np.round(s.imag, 6)))
    if re is None or im is None or abs(re[1] - im[1]) > 1e-3 * abs(re[1]):
        return gen
    (rl, d), (il, _) = re, im
    nr, ni = rl.size, il.size
    if nr * ni == s.size:
        pts = {(round(float(z.real - rl[0]) / d), round(float(z.imag - il[0]) / d))
               for z in s}
        if len(pts) == s.size:
            return ("r", d, float(rl[0]), int(nr), float(il[0]), int(ni))
        return gen
    if nr == ni and np.allclose(rl, il, rtol=1e-3):
        n = nr
        pts = {(round(float(z.real - rl[0]) / d), round(float(z.imag - rl[0]) / d))
               for z in s}
        for c in range(1, n // 2):
            if s.size != n * n - 4 * c * c:
                continue
            corner = {(i, j) for i in range(n) for j in range(n)
                      if (i < c or i >= n - c) and (j < c or j >= n - c)}
            full = {(i, j) for i in range(n) for j in range(n)} - corner
            if pts == full:
                return ("x", d, float(rl[0]), int(n), int(c))
    return gen


def grid_decision_info(grid):
    """(kind, params) for a grid spec; kind in {sq, x, r, gen, none}."""
    if grid is None:
        return "none", None
    if isinstance(grid[0], str):
        return grid[0], grid[1:]
    return "sq", grid


def fit_uniform_grid(const, n=None):
    """Least-squares uniform square-grid fit of an arbitrary alphabet (reference phase.py:131-154).

    Returns the ``(d, lo, n)`` square-grid spec minimising the mean squared
    per-axis quantisation error of the alphabet's coordinates, by the
    reference's 61 x 41 parameter search.
    """
    const = np.asarray(const).reshape(-1)
    if n is None:
        n = int(np.ceil(np.sqrt(const.size)))
    x = np.concatenate([const.real, const.imag]).astype(np.float64)
    d0 = (x.max() - x.min()) / max(n - 1, 1)
    best = None
    for d in np.linspace(0.7 * d0, 1.3 * d0, 61):
        los = (x.min() - 0.3 * d + np.linspace(0, 0.6 * d, 41))[:, None]
        j = np.clip(np.round((x[None, :] - los) / d), 0, n - 1)
        err = np.mean((x[None, :] - (los + j * d)) ** 2, axis=1)
        k = int(np.argmin(err))
        if best is None or err[k] < best[0]:
            best = (float(err[k]), float(d), float(los[k, 0]))
    return best[1], best[2], int(n)


def _probe_metrics(const, grid_fit, L, angles, th_max, trials, snr_probe, seed):
    """Per trial, the argmin over ``angles`` of the true and of the fitted-grid mean distance.

    The probes' common body (reference phase.py:172-191, 209-228): L random
    points of the alphabet with noise of amplitude ``snr_probe``, turned by
    a random phase in [-th_max, th_max), rotated by every test angle.
    """
    d, lo, n = grid_fit
    rng = np.random.default_rng(seed)
    syms = const[rng.integers(0, const.size, L)]
    noise = snr_probe * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for _ in range(trials):
        th = rng.uniform(-th_max, th_max)
        z = (syms + noise) * np.exp(1j * th)
        zr = z[None, :] * np.exp(1j * angles)[:, None]
        dtrue = np.min(np.abs(zr[:, :, None] - const[None, None, :]) ** 2, axis=-1).mean(axis=1)
        qr = lo + d * np.clip(np.round((zr.real - lo) / d), 0, n - 1)
        qi = lo + d * np.clip(np.round((zr.imag - lo) / d), 0, n - 1)
        dfit = ((zr.real - qr) ** 2 + (zr.imag - qi) ** 2).mean(axis=1)
        yield int(np.argmin(dtrue)), int(np.argmin(dfit))


def coarse_grid_for_alphabet(const, Mtestangles=16, snr_probe=0.05, trials=32, seed=0):
    """A fitted uniform grid for a general alphabet's COARSE search, or None (phase.py:157-194).

    The coarse stage of the two-stage search needs a distance that tells
    the phases apart, not the exact nearest point. The fit is accepted when,
    over ``trials`` random true phases, the best of ``Mtestangles`` angles
    by the fitted grid lies within one angle (cyclically) of the best by
    the true alphabet in all trials but one; ring alphabets fail. Seeds and
    trial counts are the reference's, so both packages accept the same alphabets.
    """
    const = np.asarray(const).reshape(-1)
    fit = fit_uniform_grid(const)
    angles = np.linspace(-np.pi / 4, np.pi / 4, Mtestangles, endpoint=False)
    ok = 0
    for a_true, a_fit in _probe_metrics(const, fit, 2048, angles, np.pi / 4, trials, snr_probe,
                                        seed):
        diff = abs(a_true - a_fit)
        ok += min(diff, Mtestangles - diff) <= 1
    return fit if ok >= trials - 1 else None


def fine_grid_ok(const, grid_fit, Mtestangles=16, B=8, trials=16, snr_probe=0.05, seed=1):
    """Whether the fitted grid is accurate enough for the FINE search (phase.py:197-231).

    The fine stage sets the final phase: on 256 angles the fitted grid's
    best must lie within one fine step, pi/2 / (Mtestangles * B), of the
    true alphabet's in all trials but one.
    """
    const = np.asarray(const).reshape(-1)
    na = 256
    angles = np.linspace(-np.pi / 4, np.pi / 4, na, endpoint=False)
    res = (np.pi / 2) / na
    fine_step = (np.pi / 2) / (Mtestangles * B)
    ok = sum(abs(a_true - a_fit) * res <= fine_step
             for a_true, a_fit in _probe_metrics(const, grid_fit, 512, angles, np.pi / 8, trials,
                                                 snr_probe, seed))
    return bool(ok >= trials - 1)


#: csrc/grid.cuh GridKind: square and rectangular grids share the per-axis decision
KIND_CODE = {"sq": 0, "r": 0, "x": 1, "gen": 2}


class GridConsts(NamedTuple):
    """What a launch or a plain version needs of a grid spec (csrc/grid.cuh ``GridArgs``).

    The one mapping from a grid spec to constants, for the phase searches
    (reference ``_make_dist_fn``) and for the block trainer's decision
    (``_make_block_err_decision``) alike. ``kind``: "sq", "r", "x" or "gen";
    ``code`` its ``GridKind``. ``d0``: the level spacing (1 for gen). ``g``:
    four floats in the alphabet's units, (g0, g1) the lowest level of the
    real and of the imaginary axis, (g2, g3) the levels less one per axis
    for "sq" and "r" and (n-1, c) for "x"; zeros for gen. ``points``: for
    gen the (M, 3) float32 table of :func:`gen_points`, else None.
    """
    kind: str
    code: int
    d0: float
    g: tuple
    points: object

    @property
    def scale(self):
        """The factor the searches fold into their rotation tables: 1/d0, and 1 for gen."""
        return 1.0 / self.d0

    @property
    def scaled(self):
        """``g`` in units of the spacing, as the searches take it: (g0/d0, g1/d0, g2, g3)."""
        return (self.g[0] / self.d0, self.g[1] / self.d0, self.g[2], self.g[3])


def gen_points(grid):
    """The (M, 3) float32 table [2 re, 2 im, |s|^2] of a ("gen", sr, si) grid spec.

    Computed in float64 and rounded once, as the reference folds its Python
    floats into the trace (phase_pallas.py:151-157, equaliser_pallas.py:259).
    Both the phase searches and the block trainer's decision read this table.
    """
    kind, p = grid_decision_info(grid)
    if kind != "gen":
        raise ValueError("gen_points takes a general alphabet's grid spec, got kind %r" % kind)
    if len(p[0]) > MAX_GEN_POINTS:
        raise KernelLimit("a general alphabet of %d points: the searches and the block trainer's "
                          "decision take at most %d (MAX_GEN_POINTS); the 'seq' and 'block' "
                          "equaliser backends take any alphabet" % (len(p[0]), MAX_GEN_POINTS))
    return _gen_table(grid)


def _gen_table(grid):
    """:func:`gen_points` for an alphabet of any size: the plain searches take any."""
    sr, si = (np.asarray(x, dtype=np.float64) for x in grid[1:])
    return np.stack([2.0 * sr, 2.0 * si, sr ** 2 + si ** 2], axis=1).astype(np.float32)


def _table_scale(grid):
    """The scale the searches fold into their rotation tables (:attr:`GridConsts.scale`)."""
    return 1.0 if grid_decision_info(grid)[0] == "gen" else grid_consts(grid).scale


def grid_consts(grid, what="bps"):
    """The :class:`GridConsts` of a grid spec of any kind."""
    kind, p = grid_decision_info(grid)
    if kind == "sq":
        d0, lo, n = p
        g = (lo, lo, n - 1.0, n - 1.0)
    elif kind == "r":
        d0, lor, nr, loi, ni = p
        g = (lor, loi, nr - 1.0, ni - 1.0)
    elif kind == "x":
        d0, lo, n, c = p
        g = (lo, lo, n - 1.0, float(c))
    elif kind == "gen":
        return GridConsts(kind, KIND_CODE[kind], 1.0, (0.0,) * 4, gen_points(grid))
    else:
        raise ValueError("%s needs a constellation that detect_grid classifies, got %r"
                         % (what, grid))
    return GridConsts(kind, KIND_CODE[kind], d0, g, None)


def points_tensor(grid, device, points=None):
    """The gen table of ``grid`` for a kernel on ``device``, None for the analytic kinds.

    A chain registers the table as a buffer when it is built and hands it
    in as ``points``; a lone call copies it from the host.
    """
    if grid_decision_info(grid)[0] != "gen":
        return None
    if points is None:
        return torch.as_tensor(gen_points(grid), device=device)
    want = (len(grid[1]), 3)
    if tuple(points.shape) != want or points.dtype != torch.float32 or points.device != device:
        raise ValueError("the gen table of this alphabet is %s float32 on %s, got %s %s on %s"
                         % (want, device, tuple(points.shape), points.dtype, points.device))
    return points


def bps_tables(testangles, grid):
    """Rotation tables of the BPS search, pre-scaled for the grid (host numpy f32).

    The grid normalisation is folded into the tables, as in the reference
    kernel (phase_pallas.py:255-259), so the analytic searches work in units
    of the level spacing: rotate + normalise is four products. A general
    alphabet is searched in its own units (scale 1).
    """
    scale = _table_scale(grid)
    ang = np.asarray(testangles, dtype=np.float64).reshape(-1)
    return ((np.cos(ang) * scale).astype(np.float32),
            (np.sin(ang) * scale).astype(np.float32))


def bps_distances(er, ei, cos_t, sin_t, grid):
    """The search's distance of each rotated sample to the constellation.

    er/ei: (..., L) float32 planes; cos_t/sin_t: (A,) tables from
    :func:`bps_tables`. Returns (..., L, A): the squared distance in units
    of d0^2 for the analytic kinds, and for gen -max_k(2<z, s_k> - |s_k|^2),
    the squared distance less |z|^2, which is the same at every angle.
    """
    return _rotated_distances(er, ei, cos_t, sin_t, grid)


def _axis_distance(u, hi):
    """u - clamp(floor(u + 0.5), 0, hi): the offset from the nearest of the levels 0..hi."""
    return u - torch.clamp(torch.floor(u + 0.5), 0.0, hi)


def _rotated_distances(er, ei, ca, sa, grid):
    """Distance to the constellation of (er + j ei) rotated by the pre-scaled (ca, sa).

    ca/sa broadcast against (..., L, 1): one angle table for all samples, or
    one per sample. Every product and sum is rounded on its own, in the
    order of the reference's ``_make_dist_fn`` and of the kernels B3 and B8.
    """
    er = er.unsqueeze(-1)
    ei = ei.unsqueeze(-1)
    xr = er * ca - ei * sa
    xi = er * sa + ei * ca
    if grid_decision_info(grid)[0] == "gen":
        # point by point from the host table, so that no (L, A, M) tensor exists
        best = None
        for a, b, c in _gen_table(grid).tolist():
            t = xr * a
            t += xi * b
            t -= c
            best = t if best is None else torch.maximum(best, t, out=best)
        return best.neg_()
    gc = grid_consts(grid)
    g = gc.scaled
    if gc.code == KIND_CODE["r"]:
        fr = _axis_distance(xr - g[0], g[2])
        fi = _axis_distance(xi - g[1], g[3])
        return fr * fr + fi * fi
    # the cross is the union of two rectangles: the closer of the two clamps
    nm1, cc, ccm = g[2], g[3], g[2] - g[3]
    ur, ui = xr - g[0], xi - g[1]
    rx, ry = torch.floor(ur + 0.5), torch.floor(ui + 0.5)
    far, fai = ur - torch.clamp(rx, 0.0, nm1), ui - torch.clamp(ry, cc, ccm)
    fbr, fbi = ur - torch.clamp(rx, cc, ccm), ui - torch.clamp(ry, 0.0, nm1)
    return torch.minimum(far * far + fai * fai, fbr * fbr + fbi * fbi)


def _select_angle_index(x, N2):
    """Running-window sum argmin (reference pythran_dsp.py:26-42).

    x: (..., L, A) distances. For i in [N2, L): idx[i - N2//2] = argmin_a of
    sum(x[i-N2+1 : i+1, a]), the first index winning ties; all other
    positions are 0. Each window is summed from its own N2 float32 values.
    """
    L = x.shape[-2]
    idx = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    if L <= N2:
        return idx
    # windows start at s = 1 .. L-N2 (the window starting at 0 is never used)
    win = x[..., 1:, :].unfold(-2, N2, 1).sum(-1)     # (..., L-N2, A)
    idx[..., N2 - N2 // 2: L - N2 // 2] = torch.argmin(win, dim=-1).to(torch.int32)
    return idx


#: the previous tile's columns whose suffix sums complete a tile's first bf16 windows
BF16_LOOKBACK = 128


def check_bf16_tile(N, T):
    """Refuse a half-window N and tile T that the reference's bf16 windows do not take.

    ``_windowed_sums`` (phase_pallas.py:39-80) completes a tile's first 2N
    windows from one lane tile of the previous tile's columns, so 2N <= 128;
    the window fits a tile (2N < T), and T is a whole number of 128-lane tiles.
    """
    N, T = int(N), int(T)
    if N < 1 or 2 * N > BF16_LOOKBACK:
        raise ValueError("bf16 windows take half-windows 1 <= N <= %d, got N=%d"
                         % (BF16_LOOKBACK // 2, N))
    if T % 128 or 2 * N >= T:
        raise ValueError("bf16 windows take a tile T that is a multiple of 128 above 2N, got "
                         "T=%d for N=%d" % (T, N))


def _shift_cols(x, k):
    """x[..., c, :] <- x[..., c - k, :] along the tile axis (-2), zero in the first k columns."""
    return torch.nn.functional.pad(x[..., :x.shape[-2] - k, :], (0, 0, k, 0))


def bf16_window_sums(dist, N2, T):
    """The reference's bf16 window sums (``_windowed_sums``, phase_pallas.py:39-80).

    dist: (..., L, A) float32 distances. The row is cut into tiles of T
    columns. Each distance is rounded to bf16; the power-of-two running
    sums S_2w[c] = S_w[c] + S_w[c - w] (0 before the tile) are built by
    doubling, each add rounded to bf16; the window ending at column c is
    S_w1[c] + S_w2[c - w1] + ... over the binary components w1 > w2 > ... of
    N2, largest first (a term before the tile is 0); the first N2 columns
    then add the previous tile's tail C[127] - C[128 - N2 + c], C the
    doubling prefix sums of its last 128 distances (none for the first
    tile). Returns the (..., L, A) bfloat16 sums of the windows ending at
    each column; the reference reads them from column N2 on.
    """
    return _bf16_windows(dist, N2, T)[0]


def _bf16_windows(dist, N2, T):
    """:func:`bf16_window_sums` and, per column, C[127] of the tail it adds (0 where none)."""
    lead, (L, A) = dist.shape[:-2], dist.shape[-2:]
    pad = (-L) % T
    d = torch.nn.functional.pad(dist, (0, 0, 0, pad)).to(torch.bfloat16)
    d = d.reshape(*lead, (L + pad) // T, T, A)
    bits = [1 << b for b in range(N2.bit_length()) if N2 >> b & 1]
    sums, s, w = {1: d}, d, 1
    while w < bits[-1]:
        s = s + _shift_cols(s, w)
        w *= 2
        sums[w] = s
    win, off = None, 0
    for w in reversed(bits):
        term = sums[w] if off == 0 else _shift_cols(sums[w], off)
        win = term if win is None else win + term
        off += w
    c, sh = d[..., T - BF16_LOOKBACK:, :], 1
    while sh < BF16_LOOKBACK:
        c = c + _shift_cols(c, sh)
        sh *= 2
    tail = c[..., BF16_LOOKBACK - 1:, :] - c[..., BF16_LOOKBACK - N2:, :]   # (..., nt, N2, A)
    tail = torch.nn.functional.pad(tail[..., :-1, :, :], (0, 0, 0, 0, 1, 0))   # tile t's: t - 1's
    win = torch.cat([win[..., :N2, :] + tail, win[..., N2:, :]], dim=-2)
    total = c[..., :-1, BF16_LOOKBACK - 1:, :]
    total = torch.nn.functional.pad(total.expand(*total.shape[:-2], N2, A), (0, 0, 0, T - N2, 1, 0))
    return tuple(x.reshape(*lead, L + pad, A)[..., :L, :] for x in (win, total))


def _select_angle_index_bf16(x, N2, T):
    """:func:`_select_angle_index` over :func:`bf16_window_sums` at tile T (phase_pallas.py:337-343).

    The argmin over the angles compares the bf16 sums as float32, the first
    index winning ties; position i - N2//2 takes the window ending at i, for
    i in [N2, L); the rest are 0.
    """
    L = x.shape[-2]
    idx = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    if L <= N2:
        return idx
    raw = torch.argmin(bf16_window_sums(x, N2, T)[..., N2:, :].float(), dim=-1)
    idx[..., N2 - N2 // 2: L - N2 // 2] = raw.to(torch.int32)
    return idx


def select_angle_index(x, N, bf16_tile=None):
    """The best-angle index of each 2N window of distances x (..., L, A): int32 (..., L).

    ``bf16_tile=None`` sums each window in float32 (:func:`_select_angle_index`);
    an int T sums the windows in bf16 in the reference's order over tiles of
    T (:func:`_select_angle_index_bf16`, after :func:`check_bf16_tile`).
    """
    if bf16_tile is None:
        return _select_angle_index(x, 2 * N)
    check_bf16_tile(N, bf16_tile)
    return _select_angle_index_bf16(x, 2 * N, int(bf16_tile))


def bps_idx_planes(er, ei, cos_t, sin_t, grid, N, bf16_tile=None):
    """Plain BPS index search on float32 planes: int32 (..., L).

    Positions [N, L-N) hold the best angle index of the 2N window around
    them, the rest are 0 (same edge semantics as ops.phase.bps_idx).
    ``bf16_tile``: the window sums' type, see :func:`select_angle_index`.
    """
    return select_angle_index(bps_distances(er, ei, cos_t, sin_t, grid), N, bf16_tile)


def fine_tables(Mtestangles, B, grid):
    """The fine stage's offsets of the two-stage BPS (phase_pallas.py:551-554, 585-593).

    B offsets delta_b = bvals_b / (B * Mtestangles) * pi/2, bvals =
    linspace(-B/2, B/2, B), span one step of the Mtestangles coarse grid.
    Returns (cos_h, sin_h, d0f, ddf): cos/sin(delta_b) times the grid's
    table scale as host float32 (computed in float64, as the reference
    does), and the affine map of the offset index, delta_b = d0f + ddf * b,
    as float32 values.
    """
    scale = _table_scale(grid)
    bvals = np.linspace(-B / 2, B / 2, B)
    deltas = bvals / (B * Mtestangles) * np.pi / 2
    ddf = deltas[1] - deltas[0] if B > 1 else 0.0
    return ((np.cos(deltas) * scale).astype(np.float32),
            (np.sin(deltas) * scale).astype(np.float32),
            float(np.float32(deltas[0])), float(np.float32(ddf)))


def bps_fine_distances(er, ei, ph1, cd, sd, grid):
    """The distances of :func:`bps_distances` at the per-sample angles ph1 + delta_b.

    er/ei/ph1: (..., L) float32; cd/sd: (B,) tables from :func:`fine_tables`.
    The angle comes from the angle-addition form, each product rounded on
    its own: c = cos(ph1) cd - sin(ph1) sd, s = sin(ph1) cd + cos(ph1) sd
    (phase_pallas.py:467-470). Returns (..., L, B).
    """
    c1 = torch.cos(ph1).unsqueeze(-1)
    s1 = torch.sin(ph1).unsqueeze(-1)
    return _rotated_distances(er, ei, c1 * cd - s1 * sd, s1 * cd + c1 * sd, grid)


def _window_near_ties(dist, N, rel):
    """Positions [N, L-N) whose two best 2N-window sums (float64) lie within ``rel``.

    ``rel`` is relative to the best window's sum of magnitudes, the scale of
    a float32 sum's rounding: for the squared distances of the analytic
    kinds that is the best sum itself; a general alphabet's score distances
    carry each sample's -|z|^2, are mostly negative and nearly cancel.
    """
    d = dist.double()[..., 1:, :].unfold(-2, 2 * N, 1)
    best2 = torch.topk(d.sum(-1), 2, dim=-1, largest=False)
    scale = d.abs().sum(-1).gather(-1, best2.indices[..., :1])[..., 0]
    mask = torch.zeros(dist.shape[:-1], dtype=torch.bool, device=dist.device)
    mask[..., N: dist.shape[-2] - N] = best2.values[..., 1] - best2.values[..., 0] <= rel * scale
    return mask


def bf16_near_ties(dist, N, T, ulps=1):
    """Positions [N, L-N) whose bf16 window decision another bf16 summation may flip.

    dist: (..., L, A) float32 distances. A position is excused where the two
    best of its :func:`bf16_window_sums` lie within ``ulps`` units in the last
    place of bf16 at the larger of the best sum and, in a tile's first 2N
    columns, the previous tile's prefix total C[127] that its tail is taken
    from (the tail C[127] - C[i] carries that total's rounding): a summation
    that keeps more precision anywhere (XLA on the CPU may), or a distance
    an ulp off in float32, moves a bf16 sum by about that much, and an exact
    tie goes to the first angle. Returns a bool mask of dist.shape[:-1].
    """
    check_bf16_tile(N, T)
    N2 = 2 * N
    L = dist.shape[-2]
    mask = torch.zeros(dist.shape[:-1], dtype=torch.bool, device=dist.device)
    if L <= N2:
        return mask
    win, total = (x[..., N2:, :].float() for x in _bf16_windows(dist, N2, int(T)))
    best2 = torch.topk(win, 2, dim=-1, largest=False).values
    scale = torch.maximum(best2[..., 0].abs(), total.abs().amax(dim=-1))
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    mask[..., N: L - N] = best2[..., 1] - best2[..., 0] <= ulps * ulp
    return mask


def bps_near_ties(er, ei, cos_t, sin_t, grid, N, rel=1e-5):
    """Positions whose two best window sums lie within ``rel`` of each other.

    The sums are taken in float64. Two float32 implementations that sum a
    window in different orders may pick either angle at such a position,
    so a comparison of two BPS searches excuses exactly these positions.
    Returns a bool mask of the shape of ``er``.
    """
    return _window_near_ties(bps_distances(er, ei, cos_t, sin_t, grid), N, rel)


def bps_fine_near_ties(er, ei, ph1, cd, sd, grid, N, rel=1e-5):
    """:func:`bps_near_ties` for the fine stage's per-sample angles ph1 + delta_b.

    An ulp of cos/sin(ph1) moves the distances by ~1e-7 relative, so it can
    flip the argmin only at these positions.
    """
    return _window_near_ties(bps_fine_distances(er, ei, ph1, cd, sd, grid), N, rel)


def bps_idx(E, testangles, symbols, N, grid=None):
    """Blind phase search index (reference pythran_dsp.py:47-85).

    E: (..., L) complex; testangles: (A,) or (1, A) shared host angle grid;
    symbols: the constellation (used to detect the grid when ``grid`` is
    None). Returns int32 (..., L).
    """
    if grid is None:
        grid = detect_grid(np.asarray(symbols).reshape(-1))
    cos_h, sin_h = bps_tables(testangles, grid)
    cos_t = torch.as_tensor(cos_h, device=E.device)
    sin_t = torch.as_tensor(sin_h, device=E.device)
    return bps_idx_planes(E.real.float(), E.imag.float(), cos_t, sin_t, grid, N)


# ---------------------------------------------------------------------------
# frequency offset (reference ops/phase.py:516-540)
# ---------------------------------------------------------------------------

#: 2*pi rounded to float32, the constant the reference's float32 phases are formed with
TWO_PI = float(np.float32(2 * np.pi))
_PERIOD = TWO_PI                         # jnp.unwrap promotes its period to float32
_INTERVAL = _PERIOD / 2                  # exact: halving a float32


def time_axis(L, device):
    """t = 1, ..., L in float32, rounded as ``jnp.arange(1, L + 1, dtype=float32)`` rounds it.

    That is float32(i) + 1 for i = 0, ..., L-1, each rounded. Past 2^24 it
    is not the float32 cast of the integer i + 1: the two differ at
    3,801,088 of the 31,981,568 samples of the pilot bench's capture.
    """
    return torch.arange(int(L), dtype=torch.int64, device=device).to(torch.float32) + 1.0


def derotate(sig, ph):
    """sig * exp(-1j ph) for a complex ``sig``, products taken on the real and imaginary parts."""
    c, s = torch.cos(ph), torch.sin(ph)
    return torch.complex(sig.real * c + sig.imag * s, sig.imag * c - sig.real * s)


def find_freq_offset(sig, os=1, average_over_modes=True, fft_size=2 ** 16):
    """Blind FOE: the peak of the spectrum of sig^4 (reference ops/phase.py:516-526).

    sig: complex (nmodes, L) or (L,) tensor. The spectrum is ``fft_size``
    points (rounded up to a power of 2) of the fourth power, the frequency
    axis the reference's float32 ``fftfreq(fft_size, 1/os) / 4``. Returns
    the (nmodes, 1) offsets in cycles per sample times ``os``, each the mean
    over the modes with ``average_over_modes``.
    """
    sig = torch.atleast_2d(torch.as_tensor(sig))
    n = int(2 ** np.ceil(np.log2(fft_size)))
    s2 = sig * sig
    spec = torch.fft.fft(s2 * s2, n, dim=-1).abs().pow(2)
    k = torch.cat([torch.arange(0, (n - 1) // 2 + 1), torch.arange(-(n // 2), 0)])
    fvec = (k.to(torch.float32) / np.float32(n / os)) / 4
    fo = fvec.to(sig.device)[torch.argmax(spec, dim=-1)][:, None]
    if average_over_modes:
        fo = fo.mean() * torch.ones_like(fo)
    return fo


def comp_freq_offset(sig, freq_offset, os=1):
    """Derotate a frequency offset (reference ops/phase.py:529-540).

    sig * exp(-1j * 2 pi t fo / os), t = 1, ..., L in float32 (rounded as
    the reference's ``jnp.arange``), ``freq_offset`` one value or one per
    mode. The phase is ((2 pi t) fo) / os in float32, in that order.
    """
    sig = torch.as_tensor(sig)
    sig2 = torch.atleast_2d(sig)
    fo = torch.as_tensor(freq_offset, device=sig.device).to(torch.float32).reshape(-1, 1)
    lin = ((TWO_PI * time_axis(sig2.shape[-1], sig.device))[None, :] * fo) / os
    out = derotate(sig2, lin)
    return out.reshape(sig.shape[-1]) if sig.dim() == 1 else out


# ---------------------------------------------------------------------------
# the tensor-level drivers (reference ops/phase.py:336-513)
# ---------------------------------------------------------------------------

def to_device(a, device):
    """A host array on ``device`` without synchronising the host: a pinned, non-blocking copy."""
    t = torch.as_tensor(np.asarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def search_grid(symbols):
    """:func:`detect_grid` of an alphabet, and the raw points where it classifies none.

    ``symbols``: best a host array; a card tensor is read back.
    """
    s = np.asarray(symbols.cpu() if torch.is_tensor(symbols) else symbols).reshape(-1)
    grid = detect_grid(s)
    if grid is None:
        grid = ("gen", tuple(float(x) for x in s.real), tuple(float(x) for x in s.imag))
    return grid


def use_kernels(grid, method, device):
    """Whether a search runs the kernels B3, B8 and B6 (reference ``_use_pallas_bps``, :345-364).

    ``method="pallas"`` runs them (on CPU tensors their plain versions),
    ``"pyt"`` or any other name takes the plain tensor path, and None runs
    them on the card where the reference takes Pallas on its accelerator:
    an analytic grid, or a general alphabet of at most ``MAX_GEN_POINTS``.
    Decided from the alphabet alone, before any launch.
    """
    if method == "pallas":
        return True
    if method is not None or device.type == "cpu":
        return False
    kind, p = grid_decision_info(grid)
    return kind != "gen" or len(p[0]) <= MAX_GEN_POINTS


def unwrap(p, dim=-1):
    """``jnp.unwrap(p, axis=dim)`` for float32 phases (period 2*pi), in its arithmetic.

    A step d is corrected by ((d + pi) mod 2*pi) - pi - d unless |d| < pi,
    with the mod taken with the divisor's sign as ``jnp.remainder`` does. A
    step of exactly +pi keeps +pi and one of exactly -pi keeps -pi (the
    reference's tie rule), so neither is corrected. As jnp.unwrap(4 ph) / 4
    in the BPS drivers it keeps a phase step of exactly +-pi/4, where the
    floor rule of B7 (``phase_cuda.quarter_unwrap``) counts a jump at +pi/4.
    """
    n = p.shape[dim]
    if n == 0:
        return p
    dd = torch.diff(p, dim=dim)
    r = torch.fmod(dd + _INTERVAL, _PERIOD)
    ddmod = torch.where(r < 0, r + _PERIOD, r) - _INTERVAL
    ddmod = torch.where((ddmod == -_INTERVAL) & (dd > 0), _INTERVAL, ddmod)
    corr = torch.where(dd.abs() < _INTERVAL, 0.0, ddmod - dd)
    csum = torch.movedim(row_cumsum(torch.movedim(corr, dim, -1)), -1, dim)
    return torch.cat([p.narrow(dim, 0, 1), p.narrow(dim, 1, n - 1) + csum], dim=dim)


#: rows at least this long are scanned in blocks (see :func:`row_cumsum`)
LONG_ROW = 2 ** 16
SCAN_BLOCK = 1024


def row_cumsum(x):
    """``torch.cumsum(x, -1)``; a row of at least ``LONG_ROW`` values is scanned in two levels.

    On the card a scan along the last axis of a few long rows runs a few
    threads per row (1.46 ms for 2 x 2^20 float32 on the H100), and a row
    scanned alone (one device-wide scan) sums in an order that changes
    from run to run. So a long row is cut into blocks of ``SCAN_BLOCK``:
    each block is scanned, the blocks' totals are scanned, and each block
    adds the sum of the blocks before it. Every sum has a fixed order, the
    same on every device.
    """
    L = x.shape[-1]
    if L < LONG_ROW:
        return torch.cumsum(x, dim=-1)
    nb = -(-L // SCAN_BLOCK)
    xb = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - L)).reshape(
        x.shape[:-1] + (nb, SCAN_BLOCK))
    inner = torch.cumsum(xb, dim=-1)
    before = torch.nn.functional.pad(torch.cumsum(inner[..., :-1, -1], dim=-1), (1, 0))
    return (inner + before[..., None]).reshape(x.shape[:-1] + (nb * SCAN_BLOCK,))[..., :L]


def _planes(E):
    """A complex (nmodes, L) or (L,) signal as contiguous float32 (nmodes, L) planes."""
    Ew = torch.atleast_2d(E)
    return Ew.real.float().contiguous(), Ew.imag.float().contiguous()


def _rotated(E, er, ei, ph, kernels):
    """E exp(+j ph) by B6 (``kernels``) or its plain version, shaped as E."""
    from qampy_tpu_torch.ops import phase_cuda
    outr, outi = (phase_cuda.rotate if kernels else phase_cuda.rotate_plain)(er, ei, ph, 1)
    out = torch.complex(outr, outi)
    if E.dim() == 1:
        return out.reshape(-1), ph.reshape(-1)
    return out, ph


def select_angles(angles, idx):
    """The chosen angle per sample (reference :336-342, pythran_dsp.py:137-153).

    angles: (1, A) shared or (L, A) per sample; idx: (L,) indices.
    """
    angles = torch.as_tensor(angles)
    idx = torch.as_tensor(idx, device=angles.device).long()
    if angles.shape[0] > 1:
        return angles[torch.arange(angles.shape[0], device=angles.device), idx[:angles.shape[0]]]
    return angles[0][idx]


def bps(E, Mtestangles, symbols, N, method=None, **kwargs):
    """Blind phase search after Pfau et al. (reference :367-397): (E derotated, phase).

    E: complex (nmodes, L) or (L,); ``symbols`` the alphabet, best a host
    array (a card tensor is read back). ``Mtestangles`` angles over
    [-pi/4, pi/4) in float32; the best angle of each 2N window is searched
    by B3 (or its plain version, see :func:`use_kernels`), its index taken
    to the phase -pi/4 + (pi/2/A) idx, the phase at [N, L-N) unwrapped by
    :func:`unwrap` (4 ph) / 4 while the first and last N keep index 0's
    -pi/4, and E turned by exp(+j ph) by B6. Outputs of E's dimension.
    Other keyword arguments are taken and ignored, as by the reference.
    """
    from qampy_tpu_torch.ops import phase_cuda
    E = torch.as_tensor(E)
    er, ei = _planes(E)
    grid = search_grid(symbols)
    kernels = use_kernels(grid, method, er.device)
    angles = np.linspace(-np.pi / 4, np.pi / 4, Mtestangles, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (to_device(t, er.device) for t in bps_tables(angles, grid))
    if kernels:
        points = to_device(gen_points(grid), er.device) if grid[0] == "gen" else None
        idx = phase_cuda.bps_search(er, ei, cos_t, sin_t, grid, N, points)
    else:
        idx = bps_idx_planes(er, ei, cos_t, sin_t, grid, N)
    ph = (-np.pi / 4) + (np.pi / 2 / Mtestangles) * idx.to(torch.float32)
    mid = slice(N, -N)
    ph[:, mid] = unwrap(ph[:, mid] * 4) / 4
    return _rotated(E, er, ei, ph, kernels)


def bps_twostage(E, Mtestangles, symbols, N, B=4, method=None, N1=None, **kwargs):
    """Two-stage BPS: a coarse search, then B offsets around each angle (reference :400-444).

    The coarse stage searches ``Mtestangles`` angles with half-window N1
    (N where None, as in the reference), the fine stage B offsets spanning
    one coarse step with half-window N: B3 then B8 (``phase_cuda.bps_twostage``)
    or their plain versions. The whole phase is unwrapped by
    :func:`unwrap` (4 ph) / 4 and E turned by exp(+j ph) by B6.
    """
    from qampy_tpu_torch.ops import phase_cuda
    E = torch.as_tensor(E)
    er, ei = _planes(E)
    grid = search_grid(symbols)
    kernels = use_kernels(grid, method, er.device)
    dev = er.device
    coarse = np.linspace(-np.pi / 4, np.pi / 4, Mtestangles, endpoint=False, dtype=np.float32)
    cos1, sin1 = (to_device(t, dev) for t in bps_tables(coarse, grid))
    cd_h, sd_h, d0f, ddf = fine_tables(Mtestangles, B, grid)
    cd, sd = to_device(cd_h, dev), to_device(sd_h, dev)
    n1 = N if N1 is None else N1
    if kernels:
        points = to_device(gen_points(grid), dev) if grid[0] == "gen" else None
        phf = phase_cuda.bps_twostage(er, ei, cos1, sin1, n1, cd, sd, grid, N, d0f, ddf,
                                      points=points)
    else:
        idx1 = bps_idx_planes(er, ei, cos1, sin1, grid, n1)
        ph1 = -np.pi / 4 + np.pi / 2 / Mtestangles * idx1.to(torch.float32)
        phf = phase_cuda.bps_fine_plain(er, ei, ph1, cd, sd, grid, N, d0f, ddf)
    return _rotated(E, er, ei, unwrap(phf * 4) / 4, kernels)


def _window_sums(x, N):
    """sum(x[..., l:l+N]) for l = 0 .. L-N: a cumulative sum in float64, each sum rounded once.

    The reference sums each (L-N+1, N) ``segment_axis`` window directly;
    that view of 2 x 2^20 samples at N = 41 would hold 688 MB.
    """
    c = row_cumsum(x.to(torch.complex128))
    c = torch.nn.functional.pad(c, (1, 0))
    return (c[..., N:] - c[..., :-N]).to(x.dtype)


def ipow(x, n):
    """x ** n for an integer n >= 1 by XLA's ``integer_pow``: squarings, products in its order."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def viterbiviterbi(E, N, M):
    """Viterbi-Viterbi blind phase recovery for M-PSK (reference :447-465): (E derotated, phase).

    The phase of the N-sample sum of exp(j angle E)^M, unwrapped, less pi
    and over M; E out at [lo, hi) derotated by it and zero elsewhere (lo =
    (N-1)/2 for odd N, N/2 - 1 for even, hi = L - lo - (1 if N even)).
    """
    E = torch.as_tensor(E)
    E2d = torch.atleast_2d(E)
    L = E2d.shape[-1]
    E_raised = ipow(torch.polar(torch.ones_like(E2d.real), torch.angle(E2d)), int(M))
    phase_est = (unwrap(torch.angle(_window_sums(E_raised, N))) - np.pi) / M
    lo, hi = ((N - 1) // 2, L - (N - 1) // 2) if N % 2 else (N // 2 - 1, L - N // 2)
    Eout = torch.zeros_like(E2d)
    Eout[:, lo:hi] = E2d[:, lo:hi] * torch.polar(torch.ones_like(phase_est), -phase_est)
    if E.dim() == 1:
        return Eout.reshape(-1), phase_est.reshape(-1)
    return Eout, phase_est


def partition_16qam(E):
    """Partition 16-QAM into the middle ring and the inner and outer rings (reference :468-476).

    Returns (class1, class2) masks: class 1 the samples below the inner or
    above the outer threshold, from the blind S0 with gamma 1/1.32.
    """
    from qampy_tpu_torch.core.metrics import cal_s0
    E = torch.as_tensor(E)
    S0 = cal_s0(E, 1.32)
    inner = (torch.sqrt(S0 / 5) + torch.sqrt(S0)) / 2.
    outer = (torch.sqrt(9 * S0 / 5) + torch.sqrt(S0)) / 2.
    Ea = E.abs()
    class1 = (Ea < inner) | (Ea > outer)
    return class1, ~class1


def phase_partition_16qam(E, Nblock):
    """16-QAM QPSK-partitioning phase recovery (reference :479-513): (E derotated, phase).

    Per block of Nblock samples, S1 sums the fourth powers of class 1; each
    class-2 sample adds whichever of S1 - (e exp(+-j dphi))^4 has the smaller
    real part (the first on a tie); the block's phase is the angle of the
    total. The L - Lb samples after the last whole block repeat its phase;
    the row is unwrapped, over 4, less pi/4.
    """
    E = torch.as_tensor(E)
    E2d = torch.atleast_2d(E)
    dphi = np.pi / 4 + np.arctan(1 / 3)
    modes, L = E2d.shape
    nblocks = L // Nblock
    Lb = nblocks * Nblock
    rows = []
    for e in E2d:
        c1, c2 = partition_16qam(e)
        zero = torch.zeros((), dtype=e.dtype, device=e.device)
        Sx = torch.where(c2, ipow(e * complex(np.exp(1.j * dphi)), 4), zero)
        So = torch.where(c2, ipow(e * complex(np.exp(-1.j * dphi)), 4), zero)
        S1 = torch.where(c1, ipow(e, 4), zero)
        S1_sum = S1[:Lb].reshape(nblocks, Nblock).sum(-1, keepdim=True)
        ax = S1_sum - Sx[:Lb].reshape(nblocks, Nblock)
        ao = S1_sum - So[:Lb].reshape(nblocks, Nblock)
        pick = torch.where(ax.real <= ao.real, ax, ao)
        sx = torch.where(c2[:Lb].reshape(nblocks, Nblock), pick, zero)
        phi_blk = torch.angle(S1_sum[:, 0] + sx.sum(-1))
        phi_est = torch.cat([phi_blk.repeat_interleave(Nblock), phi_blk[-1:].expand(L - Lb)])
        rows.append(unwrap(phi_est) / 4 - np.pi / 4)
    phi_out = torch.stack(rows)
    out = E2d * torch.polar(torch.ones_like(phi_out), -phi_out)
    if E.dim() == 1:
        return out.reshape(-1), phi_out.reshape(-1)
    return out, phi_out


# the reference keeps the names of QAMpy's per-backend searches (bps_af for
# ArrayFire, bps_pyx for Cython) as aliases of its one search; so does the port
bps_af = bps
bps_pyx = bps
