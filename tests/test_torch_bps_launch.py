"""What B3's launcher decides before any build, and the order in which B3 sums.

The CUDA kernel B3 (``csrc/phase.cu`` ``bps_kernel``) runs only on a card
(``tests/test_torch_cuda.py``). Here, on the CPU, stand its launch plan
(``ops/phase_cuda.py`` ``bps_plan``: tile, run, angle chunk, shared memory,
grid) and a float32 model of its arithmetic in its own order
(:func:`kernel_order_search`): the distances as the plain version forms
them, then per run of R positions the first window summed in full and the
next R - 1 slid. The model is held against the plain search, which sums
every window on its own, under ``chip_smoke.py``'s near-tie rules; the card
tests hold the kernel against the model bit for bit.
"""
import numpy as np
import pytest
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops import phase_cuda as tpc
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.workload import apsk_const, warped_qam

SMEM_LIMIT = 227 * 1024
FULL_RATE = (2, 2 ** 20)             # the per-sample chains' planes
DECIMATED = (2, 2 ** 16)             # decimated16's side output
FULL_WINDOW = 4                      # csrc/phase.cu kBpsFullWindow: windows not slid


def kernel_order_indices(d, d_zero, N, run):
    """B3's indices from the distances, summed in float32 in the kernel's order.

    d: (nmodes, L, A) distances of the row's samples (``bps_distances``);
    d_zero: (A,) those of a zero sample, which the kernel stages outside the
    row, so a run that starts before N sums them and slides them out. Runs
    start at multiples of ``run`` (a tile is ``BPS_THREADS`` runs); the first
    window of a run is summed from 0 one distance at a time, the next ones
    slide by s + (entering - leaving), but windows of at most 4 samples are
    each summed from 0; the first minimum over the angles wins.
    """
    nmodes, L, A = d.shape
    tile = tpc.BPS_THREADS * run
    ntiles = -(-L // tile)
    width = ntiles * tile + 2 * N - 1
    zeros = lambda n: d_zero.expand(nmodes, max(n, 0), A)
    # staged sample u of the row is sample u - (N - 1)
    d = torch.cat([zeros(N - 1), d[:, max(1 - N, 0):], zeros(width - (N - 1) - L)], dim=1)
    starts = torch.arange(0, ntiles * tile, run, device=d.device)
    s = torch.zeros((nmodes, starts.numel(), A), dtype=torch.float32, device=d.device)
    for n in range(2 * N):
        s = s + d[:, starts + n]
    idx = torch.empty((nmodes, starts.numel(), run), dtype=torch.int32, device=d.device)
    for r in range(run):
        if r and 2 * N <= FULL_WINDOW:
            s = torch.zeros_like(s)
            for n in range(2 * N):
                s = s + d[:, starts + r + n]
        elif r:
            s = s + (d[:, starts + r - 1 + 2 * N] - d[:, starts + r - 1])
        idx[:, :, r] = torch.argmin(s, dim=-1).to(torch.int32)
    idx = idx.reshape(nmodes, -1)[:, :L]
    j = torch.arange(L, device=d.device)
    return torch.where((j >= N) & (j < L - N), idx, 0)


def kernel_order_search(er, ei, cos_t, sin_t, grid, N, run):
    """:func:`kernel_order_indices` of (nmodes, L) planes."""
    zero = torch.zeros((1, 1), dtype=torch.float32, device=er.device)
    d_zero = tph.bps_distances(zero, zero, cos_t, sin_t, grid)[0, 0]
    return kernel_order_indices(tph.bps_distances(er, ei, cos_t, sin_t, grid), d_zero, N, run)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("npts", [0, 32, 64, 256])
def test_plan_fits_a_cta_for_every_half_window(npts):
    """Up to N = 128 and 256 points the CTA stays within 227 KB at every rate;
    the angles do not enter the plan at all."""
    for nmodes, L in (FULL_RATE, DECIMATED, (1, 1000)):
        worst = max(tpc.bps_plan(nmodes, L, N, npts).smem for N in range(129))
        assert worst <= SMEM_LIMIT
    # a general alphabet's runs are 8 long: 1279 samples, 1279 slots and one more every 8
    assert tpc.bps_plan(2, 2 ** 20, 128, 256).smem == 16 * 256 + 8 * 1279 + 16 * (1279 + 159)


def test_plan_fills_the_card_at_the_decimated_rate():
    """decimated16's 2 x 2^16 positions: tiles of at most 512, at least 256 CTAs."""
    for N in (12, 14, 60):
        p = tpc.bps_plan(*DECIMATED, N)
        assert p.tile <= 512 and p.ctas >= 256
        assert p == (4, 512, tpc.BPS_CHUNK, p.smem, 256)


def test_plan_tiles_are_long_at_full_rate():
    """At full rate a tile covers at least 16 N positions (halo recomputed <= 1/16 + ...)."""
    for N in range(129):
        p = tpc.bps_plan(*FULL_RATE, N)
        assert p.tile >= 16 * N and p.run == tpc.BPS_MAX_RUN and p.ctas == 1024
    p = tpc.bps_plan(*FULL_RATE, 14)
    # 2075 samples: float2 each, and 2075 slots of 4 floats with one more every 16
    assert p == (16, 2048, 4, 8 * 2075 + 16 * (2075 + 129), 1024)
    assert tpc.bps_plan(*FULL_RATE, 60).smem == 8 * 2167 + 16 * (2167 + 135)
    # runs of one position are not padded
    assert tpc.bps_plan(1, 100, 14).smem == 8 * 155 + 16 * 155


def test_plan_runs_of_a_general_alphabet():
    """A general alphabet's runs stop at 8 positions (its point loop wants more CTAs per SM),
    and halve from there as the square grid's do."""
    for N in (14, 60):
        assert tpc.bps_plan(*FULL_RATE, N, 64) == tpc.bps_plan(*FULL_RATE, N)._replace(
            run=8, tile=1024, ctas=2048, smem=tpc.bps_plan(*FULL_RATE, N, 64).smem)
    assert tpc.bps_plan(*FULL_RATE, 60, 64).tile >= 16 * 60
    assert tpc.bps_plan(*DECIMATED, 12, 64).run == 4 == tpc.bps_plan(*DECIMATED, 12).run
    assert tpc.bps_plan(1, 5000, 14, 32).run == 1


@pytest.mark.parametrize("nmodes, L, run", [(1, 1, 1), (1, 100, 1), (1, 5000, 1), (2, 40000, 2),
                                            (2, 70000, 4), (1, 2 ** 17, 4), (2, 2 ** 17, 8),
                                            (2, 2 ** 18, 16), (4, 2 ** 20, 16)])
def test_plan_run_halves_for_short_rows(nmodes, L, run):
    p = tpc.bps_plan(nmodes, L, 14)
    assert p.run == run and p.tile == 128 * run and p.ctas == nmodes * -(-L // p.tile)
    assert p.ctas >= tpc.BPS_MIN_CTAS or run == 1


def test_plan_for_a_window_beyond_a_cta():
    """A half-window of thousands of samples exceeds one CTA: the launcher refuses it as a
    limit of the kernel (the plain search takes it)."""
    assert tpc.bps_plan(*FULL_RATE, 4000).smem > SMEM_LIMIT >= tpc.bps_plan(*FULL_RATE, 3000).smem


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything builds or loads the kernel library."""
    def library():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_build, "library", library)


def test_launcher_refuses_the_cpu_and_the_bare_name_is_plain(no_build):
    grid = (1.0, -3.5, 8)
    rng = np.random.default_rng(0)
    er, ei = (torch.as_tensor(rng.standard_normal((2, 600)).astype(np.float32)) for _ in "ri")
    cos_t, sin_t = (torch.as_tensor(t) for t in tph.bps_tables(np.linspace(-0.7, 0.7, 8), grid))
    with pytest.raises(ValueError, match="CUDA"):
        tpc.bps_search_cuda(er, ei, cos_t, sin_t, grid, 5)
    assert torch.equal(tpc.bps_search(er, ei, cos_t, sin_t, grid, 5),
                       tpc.bps_search_plain(er, ei, cos_t, sin_t, grid, 5))


# ---------------------------------------------------------------------------
# the kernel's summation order against the plain search
# ---------------------------------------------------------------------------

def _alphabet(key):
    if key in ("x32", "x128", "sq64"):
        M = int(key[1:] if key[0] == "x" else key[2:])
        return (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
    if key == "r":
        re, im = np.meshgrid(0.5 * (np.arange(8) - 3.5), 0.5 * (np.arange(4) - 1.5),
                             indexing="ij")
        return (re + 1j * im).astype(np.complex64).reshape(-1)
    return {"w64": warped_qam(64), "apsk": apsk_const(32), "w256": warped_qam(256)}[key]


def _planes(const, seed, L):
    """Two modes of ``const`` with a random-walk carrier phase and noise (as the card tests)."""
    rng = np.random.default_rng(seed)
    z = const[rng.integers(0, const.size, (2, L))] * np.exp(
        1j * np.cumsum(rng.normal(scale=0.01, size=(2, L)), -1))
    z = z + 0.045 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
    return (torch.as_tensor(z.real.astype(np.float32)),
            torch.as_tensor(z.imag.astype(np.float32)))


def tie_rule(grid):
    """chip_smoke.py's (TIE_REL, TIES_MAX), on a general alphabet (TIE_REL_GEN, TIES_MAX_GEN)."""
    return (1e-6, 2e-2) if tph.grid_decision_info(grid)[0] == "gen" else (1e-5, 1e-3)


def _search_three_ways(er, ei, grid, A, N, runs):
    """(the model's indices per run, the plain search's, its near-ties) from one distance table."""
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (torch.as_tensor(t) for t in tph.bps_tables(ang, grid))
    d = tph.bps_distances(er, ei, cos_t, sin_t, grid)
    zero = torch.zeros((1, 1))
    d_zero = tph.bps_distances(zero, zero, cos_t, sin_t, grid)[0, 0]
    want = tph._select_angle_index(d, 2 * N)
    ties = (tph._window_near_ties(d, N, tie_rule(grid)[0]) if er.shape[-1] > 2 * N
            else torch.zeros_like(want, dtype=torch.bool))
    return [kernel_order_indices(d, d_zero, N, run) for run in runs], want, ties


@pytest.mark.parametrize("A, N", [(64, 14), (16, 60)])
@pytest.mark.parametrize("key", ["sq64", "r", "x32", "x128", "w64", "apsk", "w256"])
def test_kernel_order_equals_the_plain_search_off_near_ties(key, A, N):
    """Run-reseeded sliding sums, at the decimated rate's run of 4 and the full rate's 8 and
    16, pick the plain search's angle wherever its two best windows lie apart by more than the
    near-tie band, on every kind of constellation."""
    const = _alphabet(key)
    grid = tph.detect_grid(const)
    er, ei = _planes(const, A + N, 2 ** 13 if tph.grid_decision_info(grid)[0] == "gen" else 2 ** 15)
    got, want, ties = _search_three_ways(er, ei, grid, A, N, (4, 8, 16))
    for g in got:
        assert g.shape == want.shape and g.dtype == torch.int32
        assert not bool(((g != want) & ~ties).any())
        assert len(torch.unique(g)) > 1
    assert float(ties.double().mean()) <= tie_rule(grid)[1]


@pytest.mark.parametrize("L, N", [(300, 14), (28, 14), (20, 14), (1000, 0), (517, 60),
                                  (5000, 1), (5000, 2)])
def test_kernel_order_at_the_row_edges(L, N):
    """Rows shorter than a tile, of at most 2N samples (all zeros), and N = 0."""
    const = _alphabet("sq64")
    er, ei = _planes(const, L, L)
    (got,), want, ties = _search_three_ways(er, ei, tph.detect_grid(const), 8, N,
                                            (tpc.bps_plan(2, L, N).run,))
    assert not bool(((got != want) & ~ties).any())
    if L <= 2 * N:
        assert not bool(got.any())
