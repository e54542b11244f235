"""The bf16 window sums of the phase searches (B3, B8) against the JAX package's.

The reference sums the BPS windows in bf16 with ``win_dtype=jnp.bfloat16``
(``_windowed_sums``, qampy_tpu/ops/phase_pallas.py:39-80): in tiles of T
samples, power-of-two running sums by doubling, the binary components of 2N
largest first, the tile's first 2N windows completed from the previous
tile's suffix sums. The port's plain twins (``ops.phase.bf16_window_sums``)
model that order with ``torch.bfloat16`` tensors; the CUDA kernels equal them
bit for bit on the card (tests/test_torch_cuda.py, chip_smoke.py). Here the
twins run against ``bps_idx_pallas`` and ``bps_fine_pallas`` in interpret
mode, on a square grid (64-QAM), a cross (32-QAM) and a general alphabet's
fitted grid (warped 64-QAM, the fitted grid its probes accept at 16 angles),
at two tile widths.

XLA on the CPU may keep excess precision in a chain of bf16 operations, and
fuses a*b + c into an FMA in the distances. Indices are therefore compared
exactly except at near-ties: positions whose two best bf16 window sums lie
within one bf16 unit in the last place of the best sum, or, in a tile's
first 2N columns, of the previous tile's prefix total that the tail is a
difference of (``ops.phase.bf16_near_ties``, ``ulps=1``). The share of
positions so excused is bounded per grid by ``EXCUSED_MAX``: measured at
N=14, 10-12 % on 64-QAM and cross 32 at T=2048 (16-17 % at T=384, whose
tails cover 7 % of the columns) and 33-37 % on the warped alphabet, whose
samples lie off the fitted grid, so the windows sum larger distances; at
N=60 (16 angles) 1-3 %; in B8, whose 8 offsets span one coarse step, 26-30 %
and 60-61 % (``EXCUSED_MAX_FINE``). The reference and the twin part at 4-81
of the 32,768 positions of a case, every one of them excused.

One bf16 unit at the decision cannot tell the reference's order from
another bf16 summation, so the twin's order is pinned on its own: its sums
equal, bit for bit at every column and angle, a numpy model of the
reference's order (bf16 rounding written as bit arithmetic, the doubling
trees, the components largest first and the tails), for B3's and B8's
distances at N=14 and N=60 on a row of six tiles; the model equals the
scalar tree written out at sampled columns. A twin that sums in float32,
or adds the components smallest first, fails every case. The tails are a
difference of two bf16 prefix sums over 128 columns, whose rounding is that
of the prefix total: the tile's first 2N columns are excused at that scale,
98 % of them at T=256, and are also held on their own at T=256.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qampy_tpu.ops import phase as jph
from qampy_tpu.ops.phase_pallas import bps_fine_pallas, bps_idx_pallas
from qampy_tpu_torch import workload
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.phase_cuda import bps_fine_plain
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam

L = 2 ** 14
TILES = [2048, 384]          # the chain's test tile, and one that cuts a row into 43 tiles
EXCUSED_MAX = {"square64": 0.2, "cross32": 0.2, "fitted_w64": 0.4}
EXCUSED_MAX_FINE = {"square64": 0.35, "cross32": 0.35, "fitted_w64": 0.7}


def _qam(M):
    return (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)


def _grids():
    w64 = workload.warped_qam(64)
    return {"square64": (_qam(64), tph.detect_grid(_qam(64)), jph.detect_grid(_qam(64))),
            "cross32": (_qam(32), tph.detect_grid(_qam(32)), jph.detect_grid(_qam(32))),
            "fitted_w64": (w64, tph.coarse_grid_for_alphabet(w64, Mtestangles=16),
                           jph.coarse_grid_for_alphabet(w64, Mtestangles=16))}


GRIDS = _grids()


def _planes(const, seed, snr_db=22):
    """Two modes of the alphabet with a random-walk carrier phase and AWGN, as float32 planes."""
    rng = np.random.default_rng(seed)
    syms = const[rng.integers(0, len(const), size=(2, L))]
    ph = np.cumsum(rng.normal(scale=0.01, size=(2, L)), axis=-1)
    noise = 10 ** (-snr_db / 20) / np.sqrt(2) * (rng.standard_normal((2, L))
                                                 + 1j * rng.standard_normal((2, L)))
    z = (syms * np.exp(1j * ph) + noise).astype(np.complex64)
    return np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)


def _tables(A, grid):
    angles = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos_h, sin_h = tph.bps_tables(angles, grid)
    return angles, torch.as_tensor(cos_h), torch.as_tensor(sin_h)


def _b3(name, A, N, T, seed):
    """(port indices, reference indices, near-tie mask) of B3 with bf16 windows."""
    const, grid, jgrid = GRIDS[name]
    er, ei = _planes(const, seed)
    angles, cos_t, sin_t = _tables(A, grid)
    ter, tei = torch.as_tensor(er), torch.as_tensor(ei)
    got = tph.bps_idx_planes(ter, tei, cos_t, sin_t, grid, N, bf16_tile=T).numpy()
    ref = np.asarray(bps_idx_pallas(None, angles, jgrid, N, T=T, win_dtype=jnp.bfloat16,
                                    planes=(jnp.asarray(er), jnp.asarray(ei))))
    ties = tph.bf16_near_ties(tph.bps_distances(ter, tei, cos_t, sin_t, grid), N, T).numpy()
    return got, ref, ties


def _agree_off_ties(name, got, ref, ties):
    excused = float(ties.mean())
    assert excused <= EXCUSED_MAX[name], "%.3f of the positions are near-ties" % excused
    assert np.array_equal(got[~ties], ref[~ties])
    return excused


@pytest.mark.parametrize("T", TILES)
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_b3_bf16_twin_against_pallas(name, T):
    """64 angles, N=14 (the single search); the decimated searches use the same sums."""
    got, ref, ties = _b3(name, 64, 14, T, seed=11)
    _agree_off_ties(name, got, ref, ties)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_b3_bf16_wide_window(name):
    """16 angles, N=60: the two-stage coarse search, 2N = 120 of the 128 tail columns."""
    got, ref, ties = _b3(name, 16, 60, 2048, seed=12)
    _agree_off_ties(name, got, ref, ties)


@pytest.mark.parametrize("T", TILES)
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_b8_bf16_twin_against_pallas(name, T):
    """The fine stage around a coarse phase of 16 angles: 8 offsets, N=14."""
    const, grid, jgrid = GRIDS[name]
    er, ei = _planes(const, 21)
    A, B, N = 16, 8, 14
    _, cos_t, sin_t = _tables(A, grid)
    ter, tei = torch.as_tensor(er), torch.as_tensor(ei)
    idx1 = tph.bps_idx_planes(ter, tei, cos_t, sin_t, grid, 60, bf16_tile=T)
    ph1 = (-np.pi / 4 + np.pi / 2 / A * idx1.to(torch.float32)).contiguous()
    cd, sd, d0f, ddf = tph.fine_tables(A, B, grid)
    cd, sd = torch.as_tensor(cd), torch.as_tensor(sd)
    got = bps_fine_plain(ter, tei, ph1, cd, sd, grid, N, d0f, ddf, bf16_tile=T).numpy()
    ref = np.asarray(bps_fine_pallas(None, jnp.asarray(ph1.numpy()), A, B, jgrid, N, T=T,
                                     win_dtype=jnp.bfloat16,
                                     planes=(jnp.asarray(er), jnp.asarray(ei))))
    ties = tph.bf16_near_ties(tph.bps_fine_distances(ter, tei, ph1, cd, sd, grid), N,
                              T).numpy()
    # the phase is (ph1 + d0f) + ddf * idx: equal indices give phases within the FMA's rounding
    same = np.abs(got - ref) <= 2.0 ** -22
    assert float(ties.mean()) <= EXCUSED_MAX_FINE[name]
    assert same[~ties].all(), "%d positions off the near-ties differ" % (~same & ~ties).sum()


def _bf(x):
    """float32 -> bf16 -> float32, round to nearest even (numpy, independent of torch)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _tree(d, c, w, lo):
    """S_w at column c of a tile whose columns start at lo, zero before lo: the doubling tree."""
    if c < lo:
        return np.float32(0)
    if w == 1:
        return d[c]
    return _bf(_tree(d, c, w // 2, lo) + _tree(d, c - w // 2, w // 2, lo))


def _window(d, e, N2, T):
    """The reference's bf16 window ending at row column e, written out (phase_pallas.py:39-80)."""
    lo = e - e % T
    acc, off = None, 0
    for w in [1 << b for b in reversed(range(N2.bit_length())) if N2 >> b & 1]:
        term = _tree(d, e - off, w, lo) if e - off >= lo else np.float32(0)
        acc = term if acc is None else _bf(acc + term)
        off += w
    c = e - lo
    if c < N2 and lo >= T:
        blk = d[lo - 128:lo]
        C = [_tree(blk, i, 128, 0) for i in range(128)]
        acc = _bf(acc + _bf(C[127] - C[128 - N2 + c]))
    return acc


def _shift(x, k):
    """x moved k columns later along axis 0, zeros before (numpy)."""
    out = np.zeros_like(x)
    if k < x.shape[0]:
        out[k:] = x[:x.shape[0] - k]
    return out


def _windows(d, N2, T):
    """:func:`_window` at every column of a row d (L, A), vectorised over the columns of a tile
    and the angles: the doubling sums of each tile (zero before it), the components of N2
    largest first, and the previous tile's tail added to its first N2 columns."""
    d = _bf(d)
    bits = [1 << b for b in reversed(range(N2.bit_length())) if N2 >> b & 1]
    win = np.empty_like(d)
    for lo in range(0, d.shape[0], T):
        t = d[lo:lo + T]
        S, w = {1: t}, 1
        while w < bits[0]:
            S[2 * w] = _bf(S[w] + _shift(S[w], w))
            w *= 2
        acc, off = None, 0
        for w in bits:
            term = _shift(S[w], off)
            acc = term if acc is None else _bf(acc + term)
            off += w
        if lo >= T:
            C, sh = d[lo - 128:lo], 1
            while sh < 128:
                C = _bf(C + _shift(C, sh))
                sh *= 2
            n = min(N2, t.shape[0])
            acc[:n] = _bf(acc[:n] + _bf(C[127] - C[128 - N2:128 - N2 + n]))
        win[lo:lo + T] = acc
    return win


@pytest.mark.parametrize("N", [14, 60])
@pytest.mark.parametrize("stage", ["B3", "B8"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_twin_order_at_every_column(name, stage, N):
    """``bf16_window_sums`` equals the numpy model of the reference's order bit for bit at every
    column, every angle (B3: 64; B8: 8 offsets around a coarse phase) and both modes of a short
    row cut into 6 tiles (T=384, the last one short); the model equals the written-out scalar
    order at columns across the tiles, the tails included."""
    Ls, T = 2048, 384
    const, grid, _ = GRIDS[name]
    er, ei = (torch.as_tensor(np.ascontiguousarray(x[:, :Ls])) for x in _planes(const, 16))
    if stage == "B3":
        _, cos_t, sin_t = _tables(64, grid)
        dist = tph.bps_distances(er, ei, cos_t, sin_t, grid)
    else:
        A, B = 16, 8
        _, cos_t, sin_t = _tables(A, grid)
        idx1 = tph.bps_idx_planes(er, ei, cos_t, sin_t, grid, 60, bf16_tile=T)
        ph1 = (-np.pi / 4 + np.pi / 2 / A * idx1.to(torch.float32)).contiguous()
        cd, sd, _, _ = tph.fine_tables(A, B, grid)
        dist = tph.bps_fine_distances(er, ei, ph1, torch.as_tensor(cd), torch.as_tensor(sd),
                                      grid)
    win = tph.bf16_window_sums(dist, 2 * N, T).float().numpy()
    for m in range(2):
        model = _windows(dist[m].numpy(), 2 * N, T)
        bad = np.argwhere(win[m].view(np.uint32) != model.view(np.uint32))
        assert bad.size == 0, "mode %d: %d sums differ, first at (column, angle) %s" % (
            m, len(bad), tuple(bad[0]))
    d = _bf(dist[1, :, 3].numpy())
    for e in (2 * N, T - 1, T, T + 2 * N - 1, 3 * T + 5, 5 * T + 2 * N - 1, Ls - 1):
        assert model[e, 3] == _window(d, e, 2 * N, T), e


def test_tile_boundary_columns():
    """The first 2N windows of every tile read the previous tile's suffix sums: the columns
    [kT, kT + 2N) for k >= 1 at T=256, bit for bit against the written-out order, and their
    indices against the reference's (98.8 % agree there, every other position excused)."""
    T, N = 256, 14
    const, grid, _ = GRIDS["square64"]
    er, ei = (torch.as_tensor(x) for x in _planes(const, 13))
    _, cos_t, sin_t = _tables(64, grid)
    dist = tph.bps_distances(er, ei, cos_t, sin_t, grid)
    win = tph.bf16_window_sums(dist, 2 * N, T).float().numpy()
    d = _bf(dist[0, :, 5].numpy())                 # one row, one angle
    for e in [T, T + 1, T + 13, 2 * T + 27, 5 * T + 20, 7 * T + 2 * N - 1, 7 * T + 2 * N]:
        assert win[0, e, 5] == _window(d, e, 2 * N, T), e
    got, ref, ties = _b3("square64", 64, N, T, seed=13)
    ends = np.arange(L) + N                           # position j's window ends at j + N
    edge = (ends % T < 2 * N) & (ends >= T) & (np.arange(L) < L - N)
    edge = np.broadcast_to(edge, got.shape)
    assert edge.sum() == 2 * 2 * N * (L // T - 1)
    assert np.mean(got[edge] == ref[edge]) >= 0.98
    assert np.array_equal(got[edge & ~ties], ref[edge & ~ties])


def test_sums_depend_on_the_tile_and_float32_does_not():
    """bf16 sums change with T (the tails round differently); the float32 search has no T."""
    const, grid, _ = GRIDS["square64"]
    er, ei = (torch.as_tensor(x) for x in _planes(const, 14))
    _, cos_t, sin_t = _tables(64, grid)
    dist = tph.bps_distances(er, ei, cos_t, sin_t, grid)
    a, b = (tph.bf16_window_sums(dist, 28, T) for T in (2048, 384))
    assert a.dtype == torch.bfloat16 and not torch.equal(a[:, 2048:], b[:, 2048:])
    f = tph.bps_idx_planes(er, ei, cos_t, sin_t, grid, 14)
    assert torch.equal(f, tph.select_angle_index(dist, 14))


@pytest.mark.parametrize("N, T", [(0, 2048), (65, 2048), (14, 28), (14, 1000)])
def test_bf16_tile_limits(N, T):
    """As the reference asserts: 1 <= N, 2N <= 128, 2N < T, T a multiple of 128."""
    const, grid, _ = GRIDS["square64"]
    er, ei = (torch.as_tensor(x[:, :512]) for x in _planes(const, 15))
    _, cos_t, sin_t = _tables(16, grid)
    with pytest.raises(ValueError):
        tph.bps_idx_planes(er, ei, cos_t, sin_t, grid, N, bf16_tile=T)


@pytest.mark.parametrize("fine", [False, True])
def test_bf16_launch_plan(fine):
    """``phase_cuda.bf16_plan`` (mirrored by ``qtt_bps_bf16_plan``): runs of at most 8 in B3 and B8,
    halved for short rows by B3's rule; shared memory is the
    points, the staged samples, the chunk's distances, S_g and each component of 2N below g (W
    slots each), and per crossed reference-tile boundary the tail's 128 distances and its 2N
    slots."""
    from qampy_tpu_torch.ops import phase_cuda as tpc
    run = 8
    tile = 128 * run
    sample = 16 if fine else 8

    def smem(N, T, tables):
        W = tile + 2 * N - 1
        return sample * W + 8 * W + 8 * tables * W + 8 * (128 + 2 * N) * ((W - 1) // T + 1)
    p = tpc.bf16_plan(2, 2 ** 20, 60, 16384, fine=fine)
    assert (p.run, p.tile, p.chunk, p.ctas) == (run, tile, 4, 2 * 2 ** 20 // tile)
    assert p.smem == smem(60, 16384, 1)       # 120 = 64 + 32 + 16 + 8: S_8 alone
    assert tpc.bf16_plan(2, 2 ** 20, 14, 16384, fine=fine).smem == smem(14, 16384, 2)  # and S_4
    assert tpc.bf16_plan(2, 2 ** 20, 3, 256, fine=fine).smem == smem(3, 256, 2)    # S_4, S_2
    assert tpc.bf16_plan(2, 2 ** 20, 63, 256, fine=fine).smem == smem(63, 256, 3)  # S_8, S_4, S_2
    # short rows: B3's rule keeps 256 CTAs
    assert tpc.bf16_plan(2, 2 ** 17, 14, 8192, fine=fine).run == 8
    assert tpc.bf16_plan(2, 2 ** 16, 12, 8192, fine=fine).run == 4
    assert tpc.bf16_plan(2, 2 ** 13, 12, 8192, fine=fine).run == 1   # 128 CTAs of 128 positions
    gen = tpc.bf16_plan(2, 2 ** 20, 14, 256, npts=256, fine=fine)
    assert gen.smem - tpc.bf16_plan(2, 2 ** 20, 14, 256, fine=fine).smem == 16 * 256
    assert all(tpc.bf16_plan(2, 2 ** 20, N, T, npts=256, fine=fine).smem <= 227 * 1024
               for N in range(1, 65) for T in (256, 384, 16384))
