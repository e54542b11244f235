"""Plain reference of the blind two-stage receiver, in float32 torch with TF32 off.

The same semantics as the program's ``RxChain`` in its ``twostage`` mode on a
square grid, written out from QAMpy v0.5.1's two-stage blind phase search
(``qampy/core/phaserecovery.py:222-288``, ``bps_twostage``) and imported from
nowhere in the program. The trainings and the filter are those of the decimated
receiver's reference (``reference/blind.py``); then, per mode:

1. the coarse search over ``max(bps_angles // 4, 16)`` angles in [-pi/4, pi/4)
   on every filtered sample: per angle the squared distance to the nearest
   grid point, summed over the 2 * N1-sample window, the first least sum
   winning; its phase ph1 = -pi/4 + (pi/2 / A1) idx1;
2. the fine search over the B offsets b / (B A1) pi/2, b = linspace(-B/2,
   B/2, B), around ph1 on every sample: the same distance at each sample's own
   angle ph1 + offset, summed over the 2 * bps_N-sample window; the phase of
   the first least sum's offset b, as (ph1 + offset_0) + (offset_1 -
   offset_0) b;
3. the pi/2 unwrap of that phase and the derotation by exp(+j u).

Departures from QAMpy, each the program's:

- the coarse window's half-width is N1 = 60, not bps_N (the chain's wide
  coarse window, which keeps the coarse stage from slipping);
- positions outside [N, L - N) of a search take index 0 (QAMpy's running
  sum leaves them at index 0 too, but pads the edge windows);
- the unwrap counts the quarter turns of each step as floor(d (2/pi) + 0.5),
  2/pi rounded to float32, and sums them in int32 (QAMpy: ``np.unwrap(4 ph)
  / 4``, which differs only where a step lies within rounding of pi/4);
- the fine phase is the evenly spaced offsets' affine map of b, where QAMpy
  gathers ph1 + offset_b: the two differ by an ulp, and where a mode has
  failed to acquire, its phase steps by exactly pi/4 often enough that an
  ulp decides the unwrap's count (a quarter-turn slip of the rest of the row);
- every sum and product is float32 (QAMpy's searches run in the capture's
  type, complex128 where the capture is).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import blind

#: the coarse search's half-window (the chain's N1) and the fine search's offsets
N1 = 60
B = 8
INV_HALF_PI = float(np.float32(2 / np.pi))


def coarse_angles(bps_angles):
    """The coarse search's angle count: a quarter of ``bps_angles``, at least 16."""
    return max(int(bps_angles) // 4, 16)


def fine_offsets(A1, nb=B):
    """The fine search's offsets (float64): b / (nb A1) pi/2, b = linspace(-nb/2, nb/2, nb)."""
    return np.linspace(-nb / 2, nb / 2, nb) / (nb * A1) * np.pi / 2


def distances(xr, xi, cos_a, sin_a, g):
    """Squared distance, in units of d0^2, of each sample rotated by each angle to the grid.

    xr, xi: (L,) planes of one mode; cos_a, sin_a: (A,) or (L, A) cosines and sines of the
    angles. Returns (L, A).
    """
    d0, lo, n = g
    xr, xi = xr[:, None], xi[:, None]
    u = (xr * cos_a - xi * sin_a) / d0 - lo / d0
    v = (xr * sin_a + xi * cos_a) / d0 - lo / d0
    fu = u - torch.clamp(torch.floor(u + 0.5), 0.0, n - 1.0)
    fv = v - torch.clamp(torch.floor(v + 0.5), 0.0, n - 1.0)
    return fu * fu + fv * fv


def first_least(dist, N):
    """Index (L,) of the first least 2N-window sum of ``dist`` (L, A) at each position p in
    [N, L - N), the window holding samples p - N + 1 .. p + N; 0 elsewhere."""
    L = dist.shape[0]
    idx = torch.zeros(L, dtype=torch.int64, device=dist.device)
    if L <= 2 * N:
        return idx
    win = dist[1: L - 2 * N + 1].clone()
    for k in range(1, 2 * N):
        win += dist[1 + k: L - 2 * N + 1 + k]
    idx[N: L - N] = torch.argmin(win, dim=-1)
    return idx


def coarse(xr, xi, g, A1, N):
    """The coarse indices (L,) of one mode over A1 angles in [-pi/4, pi/4)."""
    ang = torch.as_tensor(np.linspace(-np.pi / 4, np.pi / 4, A1, endpoint=False),
                          dtype=torch.float32, device=xr.device)
    return first_least(distances(xr, xi, torch.cos(ang), torch.sin(ang), g), N)


def coarse_phase(idx1, A1):
    """ph1 = -pi/4 + (pi/2 / A1) idx1, float32."""
    return float(-np.pi / 4) + float(np.pi / 2 / A1) * idx1.to(torch.float32)


def fine(xr, xi, ph1, g, A1, N):
    """(indices, phase) of one mode's fine search around the coarse phase ph1 (L,).

    The phase of offset index b is (ph1 + delta_0) + step b, float32, the offsets being
    evenly spaced; the searched angles are ph1 + delta_b."""
    off = fine_offsets(A1)
    ang = ph1[:, None] + torch.as_tensor(off, dtype=torch.float32, device=xr.device)
    idx = first_least(distances(xr, xi, torch.cos(ang), torch.sin(ang), g), N)
    d0, step = float(np.float32(off[0])), float(np.float32(off[1] - off[0]))
    return idx, (ph1 + d0) + step * idx.to(torch.float32)


def unwrap(ph):
    """u = ph - (pi/2) M, M the int32 prefix sum of floor((ph_i - ph_{i-1}) (2/pi) + 0.5)."""
    m = torch.floor((ph[1:] - ph[:-1]) * INV_HALF_PI + 0.5).to(torch.int32)
    M = torch.cumsum(torch.nn.functional.pad(m, (1, 0)), dim=0, dtype=torch.int32)
    return ph - blind.HALF_PI * M.to(torch.float32)


def phases(eq, cfg):
    """The fine phase before the unwrap (nmodes, L) of the filter planes eq (2*nmodes, L)."""
    g, A1 = blind.grid(cfg["const"]), cfg["coarse_angles"]
    nm = eq.shape[0] // 2
    out = []
    for m in range(nm):
        i1 = coarse(eq[m], eq[nm + m], g, A1, cfg["N1"])
        out.append(fine(eq[m], eq[nm + m], coarse_phase(i1, A1), g, A1, cfg["bps_N"])[1])
    return torch.stack(out)


def derotate(eq, ph):
    """(er + j ei) exp(+j u), u the unwrapped phase (nmodes, L): (outr, outi)."""
    nm = eq.shape[0] // 2
    u = torch.stack([unwrap(p) for p in ph])
    c, s = torch.cos(u), torch.sin(u)
    er, ei = eq[:nm], eq[nm:]
    return er * c - ei * s, er * s + ei * c


def demodulate(P, cfg, w=None):
    """The receiver on planes P: ((outr, outi), taps). ``w`` skips the trainings."""
    w = blind.blind_taps(P, cfg) if w is None else w
    eq = blind.fir(P, w, cfg["os"])
    return derotate(eq, phases(eq, cfg)), w


def reference_config(chain, const):
    """The reference's settings from a configuration's ``chain`` entry."""
    if chain["bps_mode"] != "twostage":
        raise ValueError("the two-stage reference runs bps_mode 'twostage', got %r"
                         % chain["bps_mode"])
    return dict(const=const, Ntaps=chain["Ntaps"], os=chain["os"], mu=chain["mu"],
                TrSyms=chain["TrSyms"], block_size=chain["block_size"],
                coarse_angles=coarse_angles(chain["bps_angles"]), N1=N1, bps_N=chain["bps_N"])
