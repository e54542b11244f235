"""Time-sharded receivers on a :class:`~qampy_tpu_torch.parallel.mesh.Mesh` (counterpart of
``qampy_tpu/parallel/sharded.py``).

Each rank holds one contiguous time slice of the capture and runs the same
program on it (``torch.distributed``, one process a rank). The FIR filter
needs the first ntaps-1 samples of the right neighbour, the blind phase
search N samples of each neighbour, the decimated derotation the right
neighbour's first phase: each comes from a gather over the mesh (see
``parallel/mesh.py``). The pi/2 unwrap is made exact across shards from the
gathered first and last phases of every shard; the equaliser trains data
parallel, each rank on its own shard, with the taps averaged over the mesh
after each round.

Boundary semantics are circular (the first and last ranks exchange
wrap-around halos), as in the reference. Three divergences from it: the
left halo of the phase search is the left neighbour's last N samples (the
reference composes its two halo exchanges so that each shard's left halo
is its own first N samples, ``sharded.py:101, 160-161``); on the last rank
the last block's interpolation slope is 0, as the single-card chain has it
(``qampy_tpu/ops/chain.py:359``), where the reference's wraps around to the
capture's first phase (``sharded.py:177-180``) and corrupts up to dec-1
trailing symbols; and the window sums of the search are float32, where the
reference's Pallas path sums them in bf16. On CPU tensors the kernels run
their plain versions; on CUDA tensors the kernels run, with no fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from qampy_tpu_torch.ops import equaliser as eqops
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter, check_block_launch, check_dec,
                                                check_filter_plan, train_block)
from qampy_tpu_torch.ops.phase import TWO_PI, grid_decision_info, to_device, unwrap
from qampy_tpu_torch.ops.phase_cuda import bps_search, interp_rotate, rotate
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.utils import as_tensor

__all__ = ["ShardedRxChain", "make_sharded_rx_chain", "ShardedPilotRx", "make_sharded_pilot_rx",
           "shard_signal", "replicate_signal", "fetch_global"]

#: samples of a shard decided at a time for the EVM on a general alphabet (its decision
#: scores every point; a grid's decides per sample in one pass)
_EVM_CHUNK = 2 ** 18


def _apply_filter_local(P_loc, os, wxy, mesh, dec=None):
    """Filter a shard's (2n, Lloc) planes with a right halo so that the outputs tile exactly.

    The halo is the right neighbour's first ntaps-1 samples, the look-ahead
    of the shard's last output (the reference fetches ntaps-1+os, whose
    last os samples no output reads): B2 then gives Lloc // os outputs, and
    with ``dec`` its stride-``dec`` side output, both as contiguous planes.
    """
    Pe = mesh.halo_from_right(P_loc, wxy.shape[-1] - 1)
    return apply_filter(Pe, os, wxy, dec)


def _shard_offsets(loc, mesh):
    """(size, ...) multiples of 2 pi that continue each shard's local unwrap from the last.

    From the gathered first and last samples of every shard: the jump from
    the (already offset) end of shard d-1 to the start of shard d, rounded
    to a multiple of 2 pi (half to even, as ``jnp.round``), carried left to
    right over the ranks on the device.
    """
    ends = mesh.all_gather(torch.stack([loc[..., 0], loc[..., -1]]))
    offs = [torch.zeros_like(ends[0, 0])]
    for d in range(1, mesh.size):
        jump = ends[d - 1, 1] + offs[d - 1] - ends[d, 0]
        offs.append(torch.round(jump / TWO_PI) * TWO_PI)
    return torch.stack(offs)


def _unwrap_across_shards(ph4, mesh):
    """Global unwrap of a sharded phase (values times 4): (unwrapped shard, offsets).

    The shard's own unwrap by the ``jnp.unwrap`` rule (``ops.phase.unwrap``),
    plus this rank's row of :func:`_shard_offsets`.
    """
    loc = unwrap(ph4)
    offs = _shard_offsets(loc, mesh)
    return loc + offs[mesh.rank][..., None], offs


def _bps_local(eqp, mesh, chain):
    """The ``single`` carrier recovery of a shard's filtered planes: ((outr, outi), ph, offsets).

    N-sample halos on both sides, B3 over every angle on the halo'd planes,
    the index mapped to its phase, the cross-shard unwrap of 4 ph, and B6
    turning the shard by exp(+j ph).
    """
    N, no = chain.bps_N, eqp.shape[0] // 2
    Pe = mesh.halos(eqp, N)
    idx = bps_search(Pe[:no], Pe[no:], chain.bps_cos, chain.bps_sin, chain.grid, N, chain.points)
    ph = chain.lo_a + chain.step_a * idx[:, N:N + eqp.shape[-1]].to(torch.float32)
    ph4, offs = _unwrap_across_shards(ph * 4, mesh)
    ph = ph4 / 4
    return rotate(eqp[:no], eqp[no:], ph, sign=1), ph, offs


def _slopes(phu, mesh, dec):
    """Per-block slopes (phu[j+1] - phu[j]) / dec, the last from the right neighbour's first
    phase; 0 on the last rank, whose last block has no successor."""
    nxt = mesh.halo_from_right(phu, 1)[:, -1:]
    if mesh.rank == mesh.size - 1:
        nxt = phu[:, -1:]
    return (torch.cat([phu[:, 1:], nxt], dim=-1) - phu) / dec


def _bps_local_decimated(P_loc, w, mesh, chain):
    """The ``decimated[K]`` carrier recovery of a shard: ((outr, outi), phu, offsets).

    1. B2 with its stride-``dec`` side output on the right-haloed shard;
    2. halos of N decimated samples (N*dec symbols of context), then B3 on
       the decimated planes;
    3. the exact cross-shard unwrap of the decimated phase;
    4. the slopes (:func:`_slopes`), then B4 derotates at dx = dec.
    """
    N, dec, os = chain.bps_N, chain.dec, chain.os
    Lout = P_loc.shape[-1] // os
    if Lout % dec:
        raise ValueError("a shard of %d symbols: the decimated mode needs a multiple of the "
                         "stride %d per rank" % (Lout, dec))
    eqp, decp = _apply_filter_local(P_loc, os, w, mesh, dec)
    no = eqp.shape[0] // 2
    De = mesh.halos(decp, N)
    idxd = bps_search(De[:no], De[no:], chain.bps_cos, chain.bps_sin, chain.grid, N,
                      chain.points)
    phd = chain.lo_a + chain.step_a * idxd[:, N:N + decp.shape[-1]].to(torch.float32)
    ph4, offs = _unwrap_across_shards(phd * 4, mesh)
    phu = ph4 / 4
    b = _slopes(phu, mesh, dec)
    return interp_rotate(eqp[:no], eqp[no:], phu, b, dec, sign=1), phu, offs


def _train_parallel(P_loc, os, mu, w0, spec, Niter, TrSyms_loc, adaptive, rounds, block_size,
                    mesh, points=None):
    """Data-parallel block LMS: each rank trains on its own shard from the shared taps (B1).

    After each round the taps are turned to rank 0's phase (a CMA-family
    training leaves each shard's taps at the carrier phase of its own time
    block, and averaging taps of unaligned phases is destructive) and
    averaged over the mesh. Rank 0's taps come by ``broadcast``.
    """
    w = w0
    for _ in range(rounds):
        _, w_new, _ = train_block(P_loc, TrSyms_loc, Niter, os, mu, w, spec, adaptive,
                                  block_size, points)
        w_ref = mesh.broadcast(w_new, 0)
        inner = torch.sum(w_new * torch.conj(w_ref), dim=(-2, -1), keepdim=True)
        phase = inner / torch.clamp(torch.abs(inner), min=1e-12)
        w = mesh.mean(w_new * torch.conj(phase))
    return w


class ShardedRxChain:
    """The blind receiver over a mesh; build it with :func:`make_sharded_rx_chain`.

    ``chain(E_loc)`` takes this rank's shard, complex (nmodes, Lloc) or
    float32 [Re; Im] planes (2 nmodes, Lloc) on ``mesh.device``, and returns
    (Eout_loc complex (nmodes, Lloc // os), its phase (per symbol in
    ``single``, per block of ``dec`` in ``decimated``), the global EVM
    against the nearest points). ``train_taps``, ``demod`` and ``tracking``
    split it as ``RxChain`` does. ``offsets`` holds the cross-shard unwrap's
    offsets of the last call, (size, nmodes).
    """

    def __init__(self, mesh, os, mu1, mu2, M, Ntaps, methods, TrSyms_loc, Niter, bps_angles,
                 bps_N, rounds, block_size, adaptive, symbols, bps_mode):
        if len(methods) != 2:
            raise ValueError("the chain trains two stages, got methods=%r" % (methods,))
        dtype = np.complex64
        if symbols is not None:
            const = np.asarray(symbols).astype(dtype).reshape(-1)
            rows = [np.tile(eqops.generate_symbols_for_eq_from_alphabet(m, const, dtype), (2, 1))
                    for m in methods]
        else:
            const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(dtype)
            rows = [eqops._reshape_symbols(None, m, M, dtype, 2) for m in methods]
        self.grid = phops.detect_grid(const)
        kind = grid_decision_info(self.grid)[0]
        if kind == "none":
            raise ValueError("the chain needs a constellation of at least two points")
        if kind == "gen" and const.size > phops.MAX_GEN_POINTS:
            raise ValueError("a general alphabet of %d points: the kernels search at most %d"
                             % (const.size, phops.MAX_GEN_POINTS))
        self.specs = tuple(eqops.err_spec(m, r) for m, r in zip(methods, rows))
        self.mesh = mesh
        self.os, self.Ntaps, self.mu = int(os), int(Ntaps), (float(mu1), float(mu2))
        self.TrSyms_loc, self.Niter, self.rounds = TrSyms_loc, int(Niter), int(rounds)
        self.bps_N, self.block_size, self.adaptive = int(bps_N), int(block_size), bool(adaptive)
        if bps_mode == "single":
            self.dec = None
        elif bps_mode.startswith("decimated"):
            self.dec = int(bps_mode[len("decimated"):] or 8)
            check_dec(self.os, self.Ntaps, 2, self.dec)
        else:
            raise ValueError("bps_mode %r: the sharded chain runs 'single' or 'decimated[K]'"
                             % (bps_mode,))
        A = int(bps_angles)
        angles = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
        self.step_a, self.lo_a = float(np.pi / 2 / A), float(-np.pi / 4)
        dev = mesh.device
        cos_h, sin_h = phops.bps_tables(angles, self.grid)
        self.bps_cos, self.bps_sin = to_device(cos_h, dev), to_device(sin_h, dev)
        self.w0 = torch.as_tensor(eqops._init_taps(Ntaps, 2, 2, dtype), device=dev)
        self.decide = eqops.grid_decision(self.grid, dev)
        self.points = to_device(phops.gen_points(self.grid), dev) if kind == "gen" else None
        self.offsets = None
        self.backend_info = {"methods": tuple(methods), "bps_mode": bps_mode, "grid_kind": kind,
                             "ranks": mesh.size, "backend": mesh.backend, "device": str(dev)}
        if dev.type == "cuda":
            self.check_launch()

    def check_launch(self):
        """Ask B1's and B2's launch rules on the host for a dual-pol capture; ``KernelLimit``
        names the limit.

        B1 for both stages at the training's block, B2 for the taps (its
        shared memory does not depend on the shard's length).
        """
        trs = self.TrSyms_loc or self.block_size
        like_P = torch.empty((4, trs * self.os + self.Ntaps), device="meta")
        like_w = torch.empty((2, 2, self.Ntaps), dtype=torch.complex64, device="meta")
        for spec in self.specs:
            check_block_launch(like_P, trs, self.os, like_w, self.block_size, spec)
        check_filter_plan(2, 2, self.Ntaps, self.os, 1)

    def _planes(self, E_loc):
        P = eqops.planes(E_loc) if E_loc.is_complex() else E_loc.to(torch.float32)
        if P.dim() != 2 or P.shape[0] % 2 or P.device != self.mesh.device:
            raise ValueError("expected a shard (nmodes, L) complex or (2 nmodes, L) planes on %s, "
                             "got %s %s on %s" % (self.mesh.device, P.dtype, tuple(P.shape),
                                                  P.device))
        return P.contiguous()

    def train_taps(self, P):
        """Both data-parallel trainings: the (nmodes, nmodes, Ntaps) taps, equal on every rank."""
        n = P.shape[0] // 2
        trs = (self.TrSyms_loc if self.TrSyms_loc is not None
               else (P.shape[-1] - self.Ntaps) // self.os)
        w = self.w0[:n, :n]
        for spec, mu in zip(self.specs, self.mu):
            w = _train_parallel(P, self.os, mu, w, spec, self.Niter, trs, self.adaptive,
                                self.rounds, self.block_size, self.mesh, self.points)
        return w

    def demod(self, P, w):
        """Filter and recover the carrier of the shard with taps ``w``: ((outr, outi), ph)."""
        if self.dec is None:
            out, ph, self.offsets = _bps_local(_apply_filter_local(P, self.os, w, self.mesh),
                                               self.mesh, self)
        else:
            out, ph, self.offsets = _bps_local_decimated(P, w, self.mesh, self)
        return out, ph

    def evm(self, outr, outi):
        """The global EVM of the recovered planes against their nearest points (one gather).

        Decided as the trainers decide (``ops.equaliser.grid_decision``: per
        axis on a square or rectangular grid, the nearest point elsewhere),
        which is the reference's ``decision_idx`` but at exact ties.
        """
        sq = torch.zeros((), dtype=torch.float32, device=outr.device)
        chunk = _EVM_CHUNK if self.points is not None else outr.numel()
        for zr, zi in zip(outr.reshape(-1).split(chunk), outi.reshape(-1).split(chunk)):
            dr, di = self.decide(zr, zi)
            sq = sq + torch.sum((zr - dr) ** 2 + (zi - di) ** 2)
        tot = self.mesh.sum(torch.stack([sq, torch.full_like(sq, outr.numel())]))
        return torch.sqrt(tot[0] / tot[1])

    def __call__(self, E_loc):
        P = self._planes(E_loc)
        (outr, outi), ph = self.demod(P, self.train_taps(P))
        return torch.complex(outr, outi), ph, self.evm(outr, outi)

    def tracking(self, E_loc, w):
        """Demodulate the shard with given taps, skipping the trainings: (Eout_loc, ph)."""
        (outr, outi), ph = self.demod(self._planes(E_loc), w)
        return torch.complex(outr, outi), ph


def make_sharded_rx_chain(mesh, os, mu1, mu2, M, Ntaps, methods=("cma", "rde"), TrSyms_loc=None,
                          Niter=1, bps_angles=32, bps_N=16, rounds=2, block_size=64,
                          adaptive=True, pallas=None, bps_tile=2048, symbols=None,
                          bps_mode="single"):
    """Build the blind receiver over ``mesh`` (see :class:`ShardedRxChain`).

    Parameters follow the reference's ``make_sharded_rx_chain``: two
    data-parallel block-LMS trainings (kernel B1; ``rounds`` rounds of
    ``Niter`` passes over ``TrSyms_loc`` symbols of each shard, the whole
    shard if None), the halo'd filter (B2) and the phase search (B3) in
    ``single`` (B6 derotates) or ``decimated[K]`` (B4 derotates), on M-QAM
    or any alphabet given as ``symbols``. ``pallas`` and ``bps_tile`` are
    taken and ignored: the port has one set of kernels, and runs
    ``decimated`` whatever ``pallas`` says (the reference only on its Pallas
    path). Nothing degrades: on the card B1's and B2's launch rules are
    asked here and raise ``KernelLimit``.
    """
    return ShardedRxChain(mesh, os, mu1, mu2, M, Ntaps, methods, TrSyms_loc, Niter, bps_angles,
                          bps_N, rounds, block_size, adaptive, symbols, bps_mode)


def shard_signal(E, mesh):
    """This rank's contiguous time slice of the (..., L) array ``E``, on ``mesh.device``.

    Every rank holds the same ``E`` (a host array, or a tensor); L must
    divide into ``mesh.size`` equal shards.
    """
    E = as_tensor(E)
    L = E.shape[-1]
    if L % mesh.size:
        raise ValueError("%d samples do not divide into %d shards" % (L, mesh.size))
    n = L // mesh.size
    return E[..., mesh.rank * n:(mesh.rank + 1) * n].contiguous().to(mesh.device)


def replicate_signal(E, mesh):
    """The whole array ``E`` on ``mesh.device``, the same on every rank."""
    return as_tensor(E).contiguous().to(mesh.device)


def fetch_global(x, mesh):
    """A host numpy copy of the whole array whose rank-d shard is ``x`` on rank d.

    The shards (of one shape) are gathered on every rank and joined along
    the last axis in rank order.
    """
    buf = torch.movedim(mesh.all_gather(x), 0, -2)
    return buf.reshape(*x.shape[:-1], mesh.size * x.shape[-1]).cpu().numpy()


class ShardedPilotRx:
    """The frame-parallel pilot receiver; build it with :func:`make_sharded_pilot_rx`.

    Rank d demodulates frames [d k, (d+1) k) of a capture replicated on every
    rank. Its pilot chain is built over those frames (the chain keeps the
    frames' origins in its ``bases``), so the acquired state of the prefix
    (frame sync, alignment, pilot training) is that of the single-card
    chain, computed on every rank (``shard_prefix=False``) or spread over
    the ranks (``shard_prefix=True``: ``PilotRxChain.prefix_sharded``).
    ``rx(E)`` returns (this rank's payload, complex (nmodes, k * payload
    symbols a frame), shift, sync_corr).
    """

    def __init__(self, mesh, chain, frames_per_device, shard_prefix):
        self.mesh, self.chain = mesh, chain
        self.frames_per_device, self.shard_prefix = int(frames_per_device), bool(shard_prefix)
        self.backend_info = {"ranks": mesh.size, "frames_per_device": self.frames_per_device,
                             "shard_prefix": self.shard_prefix, "eq_trainer": chain.eq_trainer}

    def prefix(self, E):
        """The acquired state (taps, shift, mode_order, sync_corr), equal on every rank."""
        P = self.chain._planes(E.real, E.imag)
        if self.shard_prefix:
            return self.chain.prefix_sharded(P, self.mesh)[:4]
        return self.chain.prefix(P)[:4]

    def __call__(self, E):
        if not self.shard_prefix:
            data, info = self.chain.forward(E)
            return data, info["shift"], info["sync_corr"]
        taps, shift, mode_order, sync_corr = self.prefix(E)
        return self.tracking(E, taps, shift, mode_order), shift, sync_corr

    def tracking(self, E, taps, shift, mode_order):
        """Steady-state serving: this rank's frames with the state of an earlier call."""
        return self.chain.tracking(E, taps, shift, mode_order)[0]


def make_sharded_pilot_rx(mesh, pilot_seq, ph_pilots, frame_len, pilot_ins_rat, frames_per_device,
                          shard_prefix=False, **chain_kwargs):
    """Build the frame-parallel pilot receiver over ``mesh`` (see :class:`ShardedPilotRx`).

    ``chain_kwargs`` go to ``make_pilot_rx_chain`` (not ``frames`` and
    ``device``, which the mesh sets). With ``shard_prefix`` the trainer
    defaults to ``eq_trainer="ls"``, as in the reference; it needs
    ``mesh.size >= nmodes`` and ``foe_comp=False``.
    """
    k = int(frames_per_device)
    if shard_prefix:
        chain_kwargs.setdefault("eq_trainer", "ls")
    frames = tuple(range(mesh.rank * k, (mesh.rank + 1) * k))
    chain = make_pilot_rx_chain(pilot_seq, ph_pilots, frame_len, pilot_ins_rat, frames=frames,
                                device=mesh.device, **chain_kwargs)
    if shard_prefix:
        chain.check_prefix_sharded(mesh)
    return ShardedPilotRx(mesh, chain, k, shard_prefix)
