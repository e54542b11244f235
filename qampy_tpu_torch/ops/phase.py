"""Blind phase search: host grid logic and the plain PyTorch search.

Counterpart of ``qampy_tpu/ops/phase.py``: the numpy grid classification
(phase.py:30-128) that picks the analytic nearest-point decision, and the
plain form of the BPS index search (``bps_idx``/``_select_angle_index``,
phase.py:283-333) that the CUDA kernel in ``ops/phase_cuda.py`` is held
against. Only square grids are implemented; cross, rectangular and general
alphabets are ROADMAP item A4.
"""
from __future__ import annotations

import numpy as np
import torch


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


def square_grid(grid, what):
    """The ``(d0, lo, n)`` of a square grid spec; other kinds are not ported yet."""
    kind, p = grid_decision_info(grid)
    if kind != "sq":
        raise NotImplementedError(
            "%s: only square-grid constellations are ported; grid kind %r "
            "(cross, rectangular or general alphabet) is ROADMAP item A4"
            % (what, kind))
    return p


def bps_tables(testangles, grid):
    """Rotation tables of the BPS search, pre-scaled by 1/d0 (host numpy f32).

    The grid normalisation is folded into the tables, as in the reference
    kernel (phase_pallas.py:255-259), so the search works in units of the
    level spacing: rotate + normalise is four products.
    """
    d0 = square_grid(grid, "bps")[0]
    ang = np.asarray(testangles, dtype=np.float64).reshape(-1)
    return ((np.cos(ang) / d0).astype(np.float32),
            (np.sin(ang) / d0).astype(np.float32))


def bps_distances(er, ei, cos_t, sin_t, grid):
    """Squared distance (units of d0^2) of each rotated sample to the grid.

    er/ei: (..., L) float32 planes; cos_t/sin_t: (A,) tables from
    :func:`bps_tables`. Returns (..., L, A). Per axis the nearest level is
    floor(u + 0.5) clamped to [0, n-1] (phase_pallas.py:109-119).
    """
    d0, lo, n = square_grid(grid, "bps")
    c0 = lo / d0
    er = er.unsqueeze(-1)
    ei = ei.unsqueeze(-1)
    xr = er * cos_t - ei * sin_t
    xi = er * sin_t + ei * cos_t
    ur = xr - c0
    ui = xi - c0
    fr = ur - torch.clamp(torch.floor(ur + 0.5), 0.0, n - 1.0)
    fi = ui - torch.clamp(torch.floor(ui + 0.5), 0.0, n - 1.0)
    return fr * fr + fi * fi


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


def bps_idx_planes(er, ei, cos_t, sin_t, grid, N):
    """Plain BPS index search on float32 planes: int32 (..., L).

    Positions [N, L-N) hold the best angle index of the 2N window around
    them, the rest are 0 (same edge semantics as ops.phase.bps_idx).
    """
    return _select_angle_index(bps_distances(er, ei, cos_t, sin_t, grid), 2 * N)


def bps_near_ties(er, ei, cos_t, sin_t, grid, N, rel=1e-5):
    """Positions whose two best window sums lie within ``rel`` of each other.

    The sums are taken in float64. Two float32 implementations that sum a
    window in different orders may pick either angle at such a position,
    so a comparison of two BPS searches excuses exactly these positions.
    Returns a bool mask of the shape of ``er``.
    """
    d = bps_distances(er, ei, cos_t, sin_t, grid).double()
    win = d[..., 1:, :].unfold(-2, 2 * N, 1).sum(-1)
    best2 = torch.topk(win, 2, dim=-1, largest=False).values
    mask = torch.zeros(er.shape, dtype=torch.bool, device=er.device)
    mask[..., N: er.shape[-1] - N] = best2[..., 1] - best2[..., 0] <= rel * best2[..., 0]
    return mask


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
