"""What B8's and B7's launchers decide before any build, and the order in which B8 sums.

The CUDA kernels B8 (``csrc/phase.cu`` ``bps_fine_kernel``) and B7
(``unwrap_kernel``) run only on a card (``tests/test_torch_cuda.py``). Here,
on the CPU, stand B8's launch plan (``ops/phase_cuda.py`` ``fine_plan``),
a float32 model of B8's arithmetic in its own order (B3's runs of sliding
window sums over the fine stage's distances, held against the plain fine
stage off near-ties), B7's plan (``unwrap_plan``: tiles per row, the
scratch) and the launchers' refusal of CPU tensors.
"""
import numpy as np
import pytest
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops import phase_cuda as tpc
from test_torch_bps_launch import _alphabet, _planes, kernel_order_indices, tie_rule

SMEM_LIMIT = 227 * 1024
FULL_RATE = (2, 2 ** 20)             # the per-sample chains' planes


def first_design_smem(B, N, npts):
    """The shared memory of B8's first design (one sample per thread, a (B, 256 + 2N - 1)
    table): what its launcher admitted."""
    return 4 * (B * (256 + 2 * N - 1) + 2 * B + 3 * npts)


def fine_order_phases(er, ei, ph1, cd, sd, grid, N, d0f, ddf, run):
    """B8's phases from the plain distances, window sums in the kernel's order (B3's model)."""
    zero = torch.zeros((1, 1), dtype=torch.float32)
    d_zero = tph.bps_fine_distances(zero, zero, zero, cd, sd, grid)[0, 0]
    idx = kernel_order_indices(tph.bps_fine_distances(er, ei, ph1, cd, sd, grid), d_zero, N, run)
    return (ph1 + d0f) + ddf * idx.to(torch.float32)


# ---------------------------------------------------------------------------
# B8's launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("npts", [0, 32, 64, 256])
def test_fine_plan_fits_every_window_the_first_design_took(npts):
    """The plan does not depend on B; B = 1 admitted the longest windows, up to N ~ 28,500."""
    n_max = max(N for N in range(0, 40000, 1) if first_design_smem(1, N, npts) <= SMEM_LIMIT)
    assert n_max > 28000
    for nmodes, L in (FULL_RATE, (2, 2 ** 16), (1, 1000)):
        for N in [*range(0, n_max, 97), *range(n_max - 64, n_max + 1)]:
            assert tpc.fine_plan(nmodes, L, N, npts).smem <= SMEM_LIMIT, (nmodes, L, N)
    # windows of thousands take slots of one offset
    assert tpc.fine_plan(*FULL_RATE, n_max, npts).chunk == 1
    assert tpc.fine_plan(*FULL_RATE, 3000, npts).chunk == tpc.BPS_CHUNK


def test_fine_plan_fills_the_card_at_full_rate():
    """2 x 2^20 samples: runs of 8 on every kind, at least 1024 CTAs."""
    p = tpc.fine_plan(*FULL_RATE, 14)
    # 1051 samples as float4, 1051 slots of 4 floats and one more every 8
    assert p == (8, 1024, 4, 16 * 1051 + 16 * (1051 + 131), 2048)
    g = tpc.fine_plan(*FULL_RATE, 14, 32)
    assert g == p._replace(smem=16 * 32 + p.smem)
    for N in (1, 14, 60):
        for npts in (0, 32, 256):
            assert tpc.fine_plan(*FULL_RATE, N, npts).ctas >= 1024


@pytest.mark.parametrize("nmodes, L, run", [(1, 1, 1), (1, 5000, 1), (2, 70000, 4),
                                            (2, 2 ** 18, 8), (4, 2 ** 20, 8)])
def test_fine_plan_runs_shrink_for_short_rows(nmodes, L, run):
    p = tpc.fine_plan(nmodes, L, 14)
    assert p.run == run and p.tile == 128 * run and p.ctas == nmodes * -(-L // p.tile)
    assert p.ctas >= tpc.BPS_MIN_CTAS or run == 1


def test_fine_plan_halves_the_run_before_narrowing_the_slots():
    """A window that does not fit at runs of 8 first takes shorter runs with 4-offset slots."""
    p = tpc.fine_plan(*FULL_RATE, 3400)
    assert p.chunk == tpc.BPS_CHUNK and p.run < 8 and p.smem <= SMEM_LIMIT
    assert tpc._fine_smem(8, tpc.BPS_CHUNK, 3400, 0) > SMEM_LIMIT


# ---------------------------------------------------------------------------
# B8's summation order against the plain fine stage
# ---------------------------------------------------------------------------

def _fine_three_ways(key, B, N, L, runs):
    const = _alphabet(key)
    grid = tph.detect_grid(const)
    er, ei = _planes(const, B + N + L, L)
    ang = np.linspace(-np.pi / 4, np.pi / 4, 16, endpoint=False, dtype=np.float32)
    cos1, sin1 = (torch.as_tensor(t) for t in tph.bps_tables(ang, grid))
    ph1 = -np.pi / 4 + np.pi / 32 * tph.bps_idx_planes(er, ei, cos1, sin1, grid, 60).float()
    cd, sd, d0f, ddf = (torch.as_tensor(t) if isinstance(t, np.ndarray) else t
                        for t in tph.fine_tables(16, B, grid))
    args = (er, ei, ph1, cd, sd, grid, N, d0f, ddf)
    want = tpc.bps_fine_plain(*args)
    ties = (tph.bps_fine_near_ties(*args[:7], tie_rule(grid)[0]) if L > 2 * N
            else torch.zeros_like(want, dtype=torch.bool))
    return [fine_order_phases(*args, run) for run in runs], want, ties, ph1, d0f


@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("key", ["sq64", "r", "x32", "apsk"])
def test_fine_order_equals_the_plain_stage_off_near_ties(key, B):
    """Run-reseeded sliding sums at runs of 4, 8 and 16 pick the plain stage's offset
    wherever its two best windows lie apart by more than the near-tie band."""
    got, want, ties, _, _ = _fine_three_ways(key, B, 14, 2 ** 13, (4, 8, 16))
    for g in got:
        assert g.shape == want.shape and g.dtype == torch.float32
        assert not bool(((g != want) & ~ties).any())
    assert float(ties.double().mean()) <= tie_rule(tph.detect_grid(_alphabet(key)))[1]


@pytest.mark.parametrize("N", [1, 2])
def test_fine_order_of_the_shortest_windows(N):
    """Windows of 2 and 4 samples on the 256-point alphabet, whose window magnitudes span two
    orders: each window is summed in full (a slide would carry an ulp of the largest value slid
    through, beyond the near-tie band of the window itself)."""
    got, want, ties, _, _ = _fine_three_ways("w256", 3, N, 2 ** 16 + 37, (4, 8))
    for g in got:
        assert not bool(((g != want) & ~ties).any())


@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("L, N", [(300, 14), (28, 14), (20, 14), (1000, 0), (517, 60), (3000, 1)])
def test_fine_order_at_the_row_edges(L, N, B):
    """Rows shorter than a tile, of at most 2N samples (the phase ph1 + d0f), N = 0 and 1."""
    (got,), want, ties, ph1, d0f = _fine_three_ways("sq64", B, N, L,
                                                    (tpc.fine_plan(2, L, N).run,))
    assert not bool(((got != want) & ~ties).any())
    if L <= 2 * N:
        assert torch.equal(got, ph1 + d0f)


# ---------------------------------------------------------------------------
# B7's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows, L, tiles", [(1, 1, 1), (2, 2045, 1), (2, 2046, 2), (5, 2048, 2),
                                            (2, 2 ** 20, 513), (3, 4 * 2048 - 3, 4)])
def test_unwrap_plan(rows, L, tiles):
    """Tiles of 2048 samples from up to 3 samples before the row (its first 16-byte aligned
    sample): every row of L samples is covered whatever its alignment; one ticket per row and
    one status word per tile."""
    p = tpc.unwrap_plan(rows, L)
    assert p == (tpc.UNWRAP_TILE, tiles, rows * tiles, rows + rows * tiles)
    assert p.tile == tpc.UNWRAP_ITEMS * tpc.UNWRAP_THREADS == 2048
    assert (p.tiles - 1) * p.tile < L + 3 <= p.tiles * p.tile


def test_unwrap_scratch_is_zeroed():
    s = tpc.unwrap_scratch(3, 5000, torch.device("cpu"))
    assert s.dtype == torch.int64 and s.shape == (tpc.unwrap_plan(3, 5000).scratch,)
    assert not bool(s.any())


# ---------------------------------------------------------------------------
# the launchers refuse the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything builds or loads the kernel library."""
    def library():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_build, "library", library)


def test_launchers_refuse_the_cpu_and_the_bare_names_are_plain(no_build):
    rng = np.random.default_rng(0)
    er, ei, ph = (torch.as_tensor(rng.standard_normal((2, 600)).astype(np.float32))
                  for _ in "rip")
    grid = (1.0, -3.5, 8)
    cd, sd, d0f, ddf = tph.fine_tables(16, 8, grid)
    cd, sd = torch.as_tensor(cd), torch.as_tensor(sd)
    with pytest.raises(ValueError, match="CUDA"):
        tpc.unwrap_derotate_cuda(er, ei, ph)
    with pytest.raises(ValueError, match="CUDA"):
        tpc.bps_fine_cuda(er, ei, ph, cd, sd, grid, 14, d0f, ddf)
    for a, b in zip(tpc.unwrap_derotate(er, ei, ph), tpc.unwrap_derotate_plain(er, ei, ph)):
        assert torch.equal(a, b)
    assert torch.equal(tpc.bps_fine(er, ei, ph, cd, sd, grid, 14, d0f, ddf),
                       tpc.bps_fine_plain(er, ei, ph, cd, sd, grid, 14, d0f, ddf))
