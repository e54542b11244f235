"""Plain reference of the blind decimated receiver, in float32 torch with TF32 off.

The same semantics as the program's ``RxChain`` in its ``decimated[K]`` mode on
a square grid, written out from the algorithm and imported from nowhere in the
program:

1. block-LMS training on the first ``TrSyms`` symbols, MCMA then MDDMA, each
   with the aggregated adaptive step (1/mu grows by the squared previous error
   at every sign flip), the CMA singularity guard between them;
2. the strided 2x2 MIMO FIR over the capture, its every K-th output kept;
3. the blind phase search over ``bps_angles`` angles in [-pi/4, pi/4) on the
   kept outputs: per angle the squared distance to the nearest grid point,
   summed over the 2N-sample window, the first least sum winning;
4. the pi/2 unwrap of the decimated phase and per-block slopes;
5. the full-rate piecewise-linear derotation.

It takes only the capture and the configuration: the taps it uses are its own
training's, or the ones handed to ``demodulate`` by the caller.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HALF_PI = float(np.float32(np.pi / 2))


def no_tf32():
    """Sum every float32 product in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def grid(const):
    """(d0, lo, n) of a square grid given as a host complex array."""
    lv = np.unique(np.round(np.asarray(const).real.astype(np.float64), 6))
    return float(lv[1] - lv[0]), float(lv[0]), int(lv.size)


def mcma_radii(const):
    c = np.asarray(const).astype(np.complex128)
    return (float(np.mean(c.real ** 4) / np.mean(c.real ** 2)),
            float(np.mean(c.imag ** 4) / np.mean(c.imag ** 2)))


def decide(z, g):
    d0, lo, n = g
    return lo + d0 * torch.clamp(torch.floor((z - lo) / d0 + 0.5), 0.0, n - 1.0)


def mcma_error(const):
    rr, ri = mcma_radii(const)
    return lambda zr, zi: ((rr - zr * zr) * zr, (ri - zi * zi) * zi)


def mddma_error(const):
    g = grid(const)

    def err(zr, zi):
        dr, di = decide(zr, g), decide(zi, g)
        return (dr * dr - zr * zr) * zr, (di * di - zi * zi) * zi
    return err


def cma_error(R):
    def err(zr, zi):
        d = R - (zr * zr + zi * zi)
        return d * zr, d * zi
    return err


def training_windows(P, Ts, os, ntaps):
    """(Xr, Xi), each (..., nmodes*ntaps, Ts): X[m*ntaps + t, s] = E[m, s*os + t]."""
    U = P.unfold(-1, ntaps, os)[..., :Ts, :]
    X = U.transpose(-1, -2).reshape(*P.shape[:-2], P.shape[-2] * ntaps, Ts)
    K = P.shape[-2] // 2 * ntaps
    return X[..., :K, :], X[..., K:, :]


def train(P, w, err, TrSyms, os, mu, S, niter=1):
    """Adaptive block-LMS passes over TrSyms symbols in blocks of S: (taps, errors).

    P: (..., 2*nmodes, L) float32 (or float64) planes, any batch axes; w:
    (nout, nmodes, ntaps) complex initial taps shared by the batch; the
    training runs in P's type. Per block, with the
    taps frozen: z = W X, the error, W += mu err X^H; then 1/mu grows by the
    previous sample's squared error wherever the error's sign flips on either
    axis (not at a pass's first sample). Returns the taps (..., nout, nmodes,
    ntaps) and the errors (..., nout, niter * blocks * S) complex64.
    """
    nout, nmodes, ntaps = w.shape
    batch, K = P.shape[:-2], nmodes * ntaps
    S = min(int(S), int(TrSyms))
    nblocks = int(TrSyms) // S
    Xr, Xi = training_windows(P, nblocks * S, os, ntaps)
    wr = w.real.reshape(nout, K).to(P.dtype).expand(*batch, nout, K).clone()
    wi = w.imag.reshape(nout, K).to(P.dtype).expand(*batch, nout, K).clone()
    mu_c = torch.full((*batch, nout, 1), mu, dtype=P.dtype, device=P.device)
    prev_r = torch.zeros((*batch, nout, 1), dtype=P.dtype, device=P.device)
    prev_i = torch.zeros_like(prev_r)
    errs = []
    for b in range(int(niter) * nblocks):
        blk = b % nblocks
        xr, xi = Xr[..., blk * S:(blk + 1) * S], Xi[..., blk * S:(blk + 1) * S]
        xrt, xit = xr.transpose(-1, -2), xi.transpose(-1, -2)
        zr = wr @ xr - wi @ xi
        zi = wr @ xi + wi @ xr
        er, ei = err(zr, zi)
        errs.append(torch.complex(er, ei))
        gr, gi = er * mu_c, ei * mu_c
        wr, wi = wr + (gr @ xrt + gi @ xit), wi + (gi @ xrt - gr @ xit)
        pr = torch.cat([prev_r, er[..., :S - 1]], dim=-1)
        pi = torch.cat([prev_i, ei[..., :S - 1]], dim=-1)
        flip = ~((er * pr > 0) & (ei * pi > 0))
        if blk == 0:
            flip[..., 0] = False             # no previous error before a pass's first sample
        mu_c = 1.0 / (1.0 / mu_c + torch.where(flip, pr * pr + pi * pi, 0.0).sum(-1, keepdim=True))
        prev_r, prev_i = er[..., S - 1:], ei[..., S - 1:]
    taps = torch.complex(wr, wi).reshape(*batch, nout, nmodes, ntaps)
    return taps, torch.cat(errs, dim=-1)


def guard(w):
    """Row 1 re-initialised orthogonal to row 0 where both rows converged onto one source."""
    f0, f1 = w[0].reshape(-1), w[1].reshape(-1)
    inner = torch.abs(torch.vdot(f0, f1))
    n01 = torch.sqrt(torch.sum(torch.abs(f0) ** 2) * torch.sum(torch.abs(f1) ** 2))
    if float(inner) > 0.9 * float(n01):
        return torch.stack([w[0], torch.conj(w[0].flip(0, 1))])
    return w


def rounding_step(P, seed, n):
    """The first ``n`` samples of the float32 planes P, moved by about one float32 rounding
    step, in float64: each sample times 1 + 2^-24 g, g standard normal drawn from ``seed``.
    A training whose outcome on P hangs on rounding can land elsewhere from such a copy."""
    x = P[..., :n].double()
    gen = torch.Generator(device=P.device).manual_seed(int(seed))
    g = torch.randn(x.shape, generator=gen, device=P.device, dtype=torch.float64)
    return x * (1 + g * 2.0 ** -24)


def training_prefix(cfg):
    """The samples the trainings read: TrSyms symbols at os samples each, and the taps."""
    return cfg["TrSyms"] * cfg["os"] + cfg["Ntaps"]


def centre_taps(nmodes, ntaps, device):
    w = torch.zeros((nmodes, nmodes, ntaps), dtype=torch.complex64, device=device)
    for i in range(nmodes):
        w[i, i, ntaps // 2] = 1
    return w


def blind_taps(P, cfg):
    """Both trainings with the guard between them: (nmodes, nmodes, Ntaps) taps."""
    const = np.asarray(cfg["const"])
    nmodes, ntaps = P.shape[0] // 2, cfg["Ntaps"]
    args = (cfg["TrSyms"], cfg["os"], cfg["mu"], cfg["block_size"])
    w, _ = train(P, centre_taps(nmodes, ntaps, P.device), mcma_error(const), *args)
    if nmodes == 2:
        w = guard(w)
    return train(P, w, mddma_error(const), *args)[0]


def fir(P, w, os):
    """(2*nout, Lout) planes: out[j, l] = sum_{m,t} E[m, l*os + t] w[j, m, t], one product at
    a time in float32."""
    nout, nmodes, ntaps = w.shape
    Lout = (P.shape[-1] - ntaps) // os + 1
    wr, wi = w.real.float(), w.imag.float()
    out = torch.zeros((2 * nout, Lout), dtype=torch.float32, device=P.device)
    for t in range(ntaps):
        xr = P[:nmodes, t: t + (Lout - 1) * os + 1: os]
        xi = P[nmodes:, t: t + (Lout - 1) * os + 1: os]
        for j in range(nout):
            for m in range(nmodes):
                out[j] += xr[m] * wr[j, m, t] - xi[m] * wi[j, m, t]
                out[nout + j] += xr[m] * wi[j, m, t] + xi[m] * wr[j, m, t]
    return out


def search(x, const, A, N):
    """Best-angle index (nmodes, L) of the 2N windows of the planes x (2*nmodes, L).

    Position p in [N, L - N) takes the window of samples p - N + 1 .. p + N;
    the others are 0.
    """
    d0, lo, n = grid(const)
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32).astype(np.float64)
    cos_t = torch.as_tensor((np.cos(ang) / d0).astype(np.float32), device=x.device)
    sin_t = torch.as_tensor((np.sin(ang) / d0).astype(np.float32), device=x.device)
    nm, L = x.shape[0] // 2, x.shape[-1]
    idx = torch.zeros((nm, L), dtype=torch.int64, device=x.device)
    for m in range(nm):
        xr, xi = x[m][:, None], x[nm + m][:, None]
        u = xr * cos_t - xi * sin_t - lo / d0
        v = xr * sin_t + xi * cos_t - lo / d0
        fu = u - torch.clamp(torch.floor(u + 0.5), 0.0, n - 1.0)
        fv = v - torch.clamp(torch.floor(v + 0.5), 0.0, n - 1.0)
        dist = fu * fu + fv * fv                                   # (L, A)
        win = dist[1: L - 2 * N + 1].clone()
        for k in range(1, 2 * N):
            win += dist[1 + k: L - 2 * N + 1 + k]
        idx[m, N: L - N] = torch.argmin(win, dim=-1)
    return idx


def derotate(eq, idx, A, dec):
    """The full-rate derotation of the filter planes eq by the unwrapped decimated phase."""
    nm, Lout = eq.shape[0] // 2, eq.shape[-1]
    phd = float(-np.pi / 4) + float(np.pi / 2 / A) * idx.to(torch.float32)
    corr = -HALF_PI * torch.floor((phd[:, 1:] - phd[:, :-1]) / HALF_PI + 0.5)
    phu = phd + torch.cumsum(F.pad(corr, (1, 0)), dim=-1)
    b = F.pad(phu[:, 1:] - phu[:, :-1], (0, 1)) / dec
    frac = (torch.arange(phu.shape[-1] * dec, device=eq.device) % dec).to(torch.float32)
    ph = (phu.repeat_interleave(dec, dim=-1) + b.repeat_interleave(dec, dim=-1) * frac)[:, :Lout]
    c, s = torch.cos(ph), torch.sin(ph)
    er, ei = eq[:nm], eq[nm:]
    return er * c - ei * s, er * s + ei * c


def demodulate(P, cfg, w=None):
    """The receiver on planes P: ((outr, outi), taps). ``w`` skips the trainings."""
    w = blind_taps(P, cfg) if w is None else w
    eq = fir(P, w, cfg["os"])
    dec = cfg["dec"]
    idx = search(eq[:, ::dec], cfg["const"], cfg["bps_angles"], cfg["bps_N"])
    return derotate(eq, idx, cfg["bps_angles"], dec), w


def reference_config(chain, const):
    """The reference's settings from a configuration's ``chain`` entry."""
    mode = chain["bps_mode"]
    if not mode.startswith("decimated"):
        raise ValueError("the blind reference runs the decimated mode, got %r" % mode)
    return dict(const=const, Ntaps=chain["Ntaps"], os=chain["os"], mu=chain["mu"],
                TrSyms=chain["TrSyms"], block_size=chain["block_size"],
                bps_angles=chain["bps_angles"], bps_N=chain["bps_N"],
                dec=int(mode[len("decimated"):] or 8))

