"""Cross, rectangular and general alphabets in the port against the JAX package.

The decisions of B1 (sbd, mddma, dd), the distances of B3 and B8 and the
blind chain on a constellation that is not a square grid. The port's plain
PyTorch versions, which its CUDA kernels are held against on the card
(tests/test_torch_cuda.py, chip_smoke.py), run here against the reference's
Pallas kernels in interpret mode, on inputs made with numpy from a seed.

XLA on the CPU fuses a*b + c into one FMA where the port rounds the product
and the sum separately: indices are compared exactly off near-ties of the
window sums, phases within an ulp-scaled bound, and trainings over 8 blocks
(a decision is discontinuous: a rounding difference at a boundary moves one
error by a level spacing, and long runs part, as with rde).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
from qampy_tpu.ops import equaliser as jeq
from qampy_tpu.ops import phase as jph
from qampy_tpu.ops.equaliser_pallas import (_make_block_err_decision,
                                            train_equaliser_block_pallas)
from qampy_tpu.ops.phase_pallas import _make_dist_fn, bps_fine_pallas, bps_idx_pallas
from qampy_tpu_torch import convert, workload
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.equaliser_cuda import train_block, train_block_plain
from qampy_tpu_torch.ops.phase_cuda import bps_fine_plain, bps_search_plain
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.workload import GATE_TRIM, ser_gate, shared_decisions


def _qam(M):
    return (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)


def _rect():
    """An 8 x 4 grid by hand, spacing 0.5, unit power to within a few percent."""
    re, im = np.meshgrid(0.5 * (np.arange(8) - 3.5), 0.5 * (np.arange(4) - 1.5), indexing="ij")
    return (re + 1j * im).astype(np.complex64).reshape(-1)


ALPHABETS = {
    "r": _rect(), "x32": _qam(32), "x128": _qam(128), "w64": workload.warped_qam(64),
    "w256": workload.warped_qam(256), "apsk": workload.apsk_const(32),
    "ring": np.exp(1j * 2 * np.pi * np.arange(32) / 32).astype(np.complex64),
}
KINDS = {"r": "r", "x32": "x", "x128": "x", "w64": "gen", "w256": "gen", "apsk": "gen",
         "ring": "gen"}
SEARCHED = ["r", "x32", "x128", "w64", "w256"]
# near-ties are judged relative to the best window's sum of magnitudes: a general
# alphabet's scores carry each sample's -|z|^2, so that sum is ~100x the gap of two
# angles' windows, and the band that 1e-5 excuses on squared distances would cover
# several percent of the positions. 1e-6 is a float32 sum's rounding over 28 terms.
TIE_REL = {"r": 1e-5, "x": 1e-5, "gen": 1e-6}
# one float32 rounding of a value below 1 rad is at most 2^-25; the fine phases
# (|ph| < 1) may differ by the FMA's rounding of the offset term
PHASE_ULPS = 2.0 ** -22


@pytest.mark.parametrize("key", list(ALPHABETS))
def test_kinds_and_search_constants(key):
    const = ALPHABETS[key]
    grid = tph.detect_grid(const)
    assert grid == jph.detect_grid(const) and tph.grid_decision_info(grid)[0] == KINDS[key]
    sc = tph.grid_consts(grid)
    assert sc.scale == _make_dist_fn(grid)[1]
    assert sc.kind == KINDS[key]
    if sc.kind == "gen":
        # 2 re and 2 im are exact in float32; |s|^2 is rounded once from float64
        c = const.astype(np.complex128)
        np.testing.assert_array_equal(sc.points[:, 0], (2 * c.real).astype(np.float32))
        np.testing.assert_array_equal(sc.points[:, 1], (2 * c.imag).astype(np.float32))
        np.testing.assert_array_equal(sc.points[:, 2],
                                      (c.real ** 2 + c.imag ** 2).astype(np.float32))
    spec, sc2 = convert.decision_from_jax("sbd", np.tile(const, (2, 1)), jph.detect_grid(const))
    assert spec == teq.err_spec("sbd", np.tile(const, (2, 1))) and sc2.kind == sc.kind
    assert convert.grid_from_jax(jph.detect_grid(const)) == grid


# ---------------------------------------------------------------------------
# the host probes of a general alphabet's fitted grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["w64", "w256", "apsk", "ring"])
def test_fitted_grid_probes_equal_the_reference(key):
    const = ALPHABETS[key]
    fit = tph.fit_uniform_grid(const)
    assert fit == jph.fit_uniform_grid(const)
    # 256 points: 8 of the coarse probe's 32 trials and 2 of the fine probe's 16 (a fine
    # trial takes a second per package); the other alphabets run the chain's own counts
    ckw, kw = (dict(trials=8), dict(trials=2)) if key == "w256" else ({}, {})
    coarse = tph.coarse_grid_for_alphabet(const, **ckw)
    assert coarse == jph.coarse_grid_for_alphabet(const, **ckw)
    assert (coarse is not None) == (key in ("w64", "w256"))
    # the fine probe on the fit, accepted by the coarse probe or not
    fine = tph.fine_grid_ok(const, fit, **kw)
    assert isinstance(fine, bool) and fine == bool(jph.fine_grid_ok(const, fit, **kw))
    # the warped 64-point alphabet passes both probes; the 256-point one the coarse only
    assert fine == (key == "w64")


def test_probes_at_the_decimated_chains_angle_count():
    """The chain probes at max(bps_angles // div, 16): 16 in twostage (above), 64 in decimated.

    At 64 angles the fine step is a quarter of twostage's and the warped
    alphabet's fitted grid is refused: the decimated search runs on the points.
    """
    const = ALPHABETS["w64"]
    fit = tph.coarse_grid_for_alphabet(const, Mtestangles=64, trials=8)
    assert fit == jph.coarse_grid_for_alphabet(const, Mtestangles=64, trials=8)
    assert fit is not None
    assert tph.fine_grid_ok(const, fit, Mtestangles=64) is False
    assert not jph.fine_grid_ok(const, fit, Mtestangles=64)


# ---------------------------------------------------------------------------
# K2, K3: the distance of B3 and B8
# ---------------------------------------------------------------------------

def _planes(const, seed, L=4096, snr_db=24):
    """Two modes of the alphabet with a random-walk carrier phase and AWGN, as float32 planes."""
    rng = np.random.default_rng(seed)
    syms = const[rng.integers(0, const.size, size=(2, L))]
    ph = np.cumsum(rng.normal(scale=0.01, size=(2, L)), axis=-1) + np.array([[0.2], [-0.3]])
    noise = 10 ** (-snr_db / 20) / np.sqrt(2) * (rng.standard_normal((2, L))
                                                 + 1j * rng.standard_normal((2, L)))
    z = (syms * np.exp(1j * ph) + noise).astype(np.complex64)
    return np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)


def _angles(A):
    return np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)


@pytest.mark.parametrize("key", SEARCHED)
def test_distance_against_reference_formula(key):
    """The plain distance against ``_make_dist_fn`` evaluated by jnp outside any kernel."""
    const = ALPHABETS[key]
    grid = tph.detect_grid(const)
    er, ei = _planes(const, 3, L=512)
    cos_h, sin_h = tph.bps_tables(_angles(16), grid)
    dist_fn, scale = _make_dist_fn(grid)
    xr = er[..., None] * cos_h - ei[..., None] * sin_h
    xi = er[..., None] * sin_h + ei[..., None] * cos_h
    ref = np.asarray(dist_fn(jnp.asarray(xr), jnp.asarray(xi)))
    got = tph.bps_distances(torch.as_tensor(er), torch.as_tensor(ei), torch.as_tensor(cos_h),
                            torch.as_tensor(sin_h), grid).numpy()
    # both in float32 from the same rotated coordinates up to an FMA's rounding: a few
    # ulps of the coordinates (|x| scale ~ 12 for 128-QAM), squared distances below 1
    assert np.abs(got - ref).max() <= 2e-5 * scale
    assert got.shape == (2, 512, 16)


@pytest.mark.parametrize("key", SEARCHED)
def test_b3_against_pallas(key):
    const = ALPHABETS[key]
    grid = tph.detect_grid(const)
    A, N = 16, 14
    er, ei = _planes(const, 11)
    ref = np.asarray(bps_idx_pallas(None, _angles(A), grid, N, T=512, interpret=True,
                                    win_dtype=None, planes=(er, ei)))
    cos_t, sin_t = (torch.as_tensor(t) for t in tph.bps_tables(_angles(A), grid))
    ter, tei = torch.as_tensor(er), torch.as_tensor(ei)
    got = bps_search_plain(ter, tei, cos_t, sin_t, grid, N).numpy()
    ties = tph.bps_near_ties(ter, tei, cos_t, sin_t, grid, N, TIE_REL[KINDS[key]]).numpy()
    assert np.all((got == ref) | ties) and ties.mean() <= 2e-3
    assert not got[:, :N].any() and not got[:, -N:].any()
    # the search found the carrier: the phase it reads follows the true one
    assert len(np.unique(got[:, N:-N])) > 1


@pytest.mark.parametrize("key", SEARCHED)
def test_b8_against_pallas(key):
    const = ALPHABETS[key]
    grid = tph.detect_grid(const)
    A1, B, N = 16, 8, 14
    er, ei = _planes(const, 12)
    cos_t, sin_t = (torch.as_tensor(t) for t in tph.bps_tables(_angles(A1), grid))
    t = [torch.as_tensor(x) for x in (er, ei)]
    idx1 = bps_search_plain(*t, cos_t, sin_t, grid, 60).numpy()
    ph1 = (np.float32(-np.pi / 4) + np.float32(np.pi / 2 / A1) * idx1.astype(np.float32))
    ref = np.asarray(bps_fine_pallas(None, ph1, A1, B, grid, N, T=512, interpret=True,
                                     planes=(er, ei)))
    cd, sd, d0f, ddf = tph.fine_tables(A1, B, grid)
    tcd, tsd, tph1 = torch.as_tensor(cd), torch.as_tensor(sd), torch.as_tensor(ph1)
    got = bps_fine_plain(*t, tph1, tcd, tsd, grid, N, d0f, ddf).numpy()
    ties = tph.bps_fine_near_ties(*t, tph1, tcd, tsd, grid, N, TIE_REL[KINDS[key]]).numpy()
    # the fine angles lie pi/256 apart: measured 5.7e-3 (64 points) and 6.3e-3 (256) on gen
    assert ties.mean() <= (1e-2 if KINDS[key] == "gen" else 2e-3)
    assert np.abs(got - ref)[~ties].max() <= max(PHASE_ULPS, 1e-6)
    base = (ph1 + np.float32(d0f)).astype(np.float32)
    assert np.array_equal(got[:, :N], base[:, :N]) and np.array_equal(got[:, -N:], base[:, -N:])


def test_fitted_coarse_with_exact_fine():
    """The two-stage search with a grid of its own for the coarse stage (twostage on gen)."""
    from qampy_tpu.ops.phase_pallas import bps_phase_twostage_pallas
    from qampy_tpu_torch.ops.phase_cuda import bps_twostage
    const = ALPHABETS["w64"]
    grid, fit = tph.detect_grid(const), tph.coarse_grid_for_alphabet(const)
    er, ei = _planes(const, 13)
    ref = np.asarray(bps_phase_twostage_pallas(None, 16, 8, grid, 14, T=512, interpret=True,
                                               N1=60, grid_coarse=fit, planes=(er, ei)))
    cos1, sin1 = (torch.as_tensor(t) for t in tph.bps_tables(_angles(16), fit))
    cd, sd, d0f, ddf = tph.fine_tables(16, 8, grid)
    t = [torch.as_tensor(x) for x in (er, ei)]
    got = bps_twostage(*t, cos1, sin1, 60, torch.as_tensor(cd), torch.as_tensor(sd), grid, 14,
                       d0f, ddf, grid_coarse=fit).numpy()
    coarse = tph.bps_near_ties(*t, cos1, sin1, fit, 60).numpy()
    near = np.stack([np.convolve(c, np.ones(29), "same") > 0 for c in coarse])
    idx1 = bps_search_plain(*t, cos1, sin1, fit, 60)
    ph1 = -np.pi / 4 + (np.pi / 2 / 16) * idx1.to(torch.float32)
    fine = tph.bps_fine_near_ties(*t, ph1, torch.as_tensor(cd), torch.as_tensor(sd), grid,
                                  14, TIE_REL["gen"]).numpy()
    ok = ~(near | fine)
    assert ok.mean() >= 0.99 and np.abs(got - ref)[ok].max() <= PHASE_ULPS


# ---------------------------------------------------------------------------
# K1: the decisions of B1
# ---------------------------------------------------------------------------

def _training_capture(const, seed, nsym=600, snr_db=26):
    """Symbols of the alphabet held for two samples each, with noise: (2, 2*nsym) complex64."""
    rng = np.random.default_rng(seed)
    syms = const[rng.integers(0, const.size, size=(2, nsym))]
    E = np.repeat(syms, 2, axis=-1)
    noise = 10 ** (-snr_db / 20) / np.sqrt(2) * (rng.standard_normal(E.shape)
                                                 + 1j * rng.standard_normal(E.shape))
    return (E + noise).astype(np.complex64)


@pytest.mark.parametrize("key, method", [(k, m) for k in ("r", "x32", "x128", "w64")
                                         for m in ("sbd", "mddma", "dd")] + [("w256", "sbd")])
def test_b1_against_pallas(key, method):
    """8 blocks of 64 from the centre taps: the plain block trainer against the fused one.

    The 256-point decision (12 s in interpret mode) runs for one method: the
    three share it.
    """
    const = ALPHABETS[key]
    E = _training_capture(const, 5)
    syms = np.tile(const, (2, 1))
    w0 = jeq._init_taps(11, 2, 2, np.complex64)
    ref = train_equaliser_block_pallas(jnp.asarray(E), 512, 1, 2, 2e-3, w0, syms, method,
                                       adaptive=True, block_size=64, interpret=True)
    spec, _ = convert.decision_from_jax(method, syms)
    got = train_block_plain(convert.planes_from_complex(E, "cpu"), 512, 1, 2, 2e-3,
                            convert.taps_from_jax(w0, "cpu"), spec, True, 64)
    assert float(np.abs(got[1].numpy() - np.asarray(ref[1])).max()) <= 1e-6
    assert float(np.abs(got[2].numpy() - np.asarray(ref[2])).max()) <= 1e-6
    assert got[0].shape == (2, 512)
    assert float(np.abs(got[0].numpy() - np.asarray(ref[0])).max()) <= 1e-5
    # the bare name takes the plain version on the CPU, with or without a table handed in
    again = train_block(convert.planes_from_complex(E, "cpu"), 512, 1, 2, 2e-3,
                        convert.taps_from_jax(w0, "cpu"), spec, True, 64, points=None)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _decide(grid, zr, zi):
    dec = teq.grid_decision(grid, "cpu")
    dr, di = dec(torch.as_tensor(zr, dtype=torch.float32), torch.as_tensor(zi, dtype=torch.float32))
    return dr.numpy(), di.numpy()


def _ref_decide(grid, zr, zi):
    """The reference's decision through its dd error: d = err + z."""
    fn = _make_block_err_decision("dd", grid)
    er, ei = fn(jnp.asarray(zr, jnp.float32), jnp.asarray(zi, jnp.float32), None, None, 0, 0)
    return np.asarray(er) + np.float32(zr), np.asarray(ei) + np.float32(zi)


@pytest.mark.parametrize("key", ["r", "x32", "x128", "w64", "apsk"])
def test_decision_is_the_nearest_point(key):
    const = ALPHABETS[key]
    grid = tph.detect_grid(const)
    rng = np.random.default_rng(8)
    z = (1.3 * (rng.standard_normal(4000) + 1j * rng.standard_normal(4000))).astype(np.complex64)
    dr, di = _decide(grid, z.real, z.imag)
    near = const[np.argmin(np.abs(z[:, None].astype(np.complex128) - const[None, :]), axis=1)]
    d_got = np.abs(z - (dr + 1j * di))
    # the decided point is a point of the alphabet and as near as the nearest (the
    # grid's spacing is read off the rounded levels, so equal to ~1e-5)
    assert np.abs((dr + 1j * di)[:, None] - const[None, :]).min(axis=1).max() <= 2e-5
    assert np.all(d_got <= np.abs(z - near) + 2e-5)
    rr, ri = _ref_decide(grid, z.real, z.imag)
    assert np.abs(rr - dr).max() <= 1e-6 and np.abs(ri - di).max() <= 1e-6


def test_first_maximum_wins_on_a_general_alphabet():
    """z = 0 scores -|s|^2: four points of equal modulus tie, and the first of them is taken."""
    const = np.array([2 + 0.5j, 1 + 1j, -1 - 1j, 1 - 1j, -1 + 1j, 0.3 + 2j], np.complex64)
    grid = tph.detect_grid(const)
    assert tph.grid_decision_info(grid)[0] == "gen"
    z = np.zeros(3, np.float32)
    dr, di = _decide(grid, z, z)
    assert np.all(dr == 1.0) and np.all(di == 1.0)
    rr, ri = _ref_decide(grid, z, z)
    assert np.array_equal(rr, dr) and np.array_equal(ri, di)
    # the same alphabet with the tied points in another order takes its first again
    dr2, di2 = _decide(tph.detect_grid(const[[0, 4, 3, 2, 1, 5]]), z, z)
    assert np.all(dr2 == -1.0) and np.all(di2 == 1.0)


def test_rectangle_a_wins_a_tie_on_the_cross():
    """At a missing corner dA == dB: the decision is A's, the point above it, not beside it."""
    grid = tph.detect_grid(ALPHABETS["x32"])
    _, d0, lo, n, c = grid
    z = np.array([lo], np.float32)        # x = y = 0 exactly: the missing corner (0, 0)
    dr, di = _decide(grid, z, z)
    assert dr[0] == np.float32(lo + d0 * 0.0) and di[0] == np.float32(lo + d0 * 1.0)
    rr, ri = _ref_decide(grid, z, z)
    assert abs(rr[0] - dr[0]) <= 1e-6 and abs(ri[0] - di[0]) <= 1e-6
    # a half-way point goes up: floor(x + 0.5), never round half to even
    zr = np.array([lo + d0 * 2.5], np.float32)
    zi = np.array([lo + d0 * 2.0], np.float32)
    x = (zr - np.float32(lo)) / np.float32(d0)
    if x[0] == 2.5:                       # only where float32 keeps the half exactly
        assert _decide(grid, zr, zi)[0][0] == np.float32(lo + d0 * 3.0)


# ---------------------------------------------------------------------------
# the workload: gate, decisions and captures on alphabets without levels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["x32", "w64", "apsk"])
def test_gate_and_decide_on_alphabets_without_levels(key):
    """The nearest-point gate reads 0 on the transmitted symbols and counts planted errors."""
    const = ALPHABETS[key]
    rng = np.random.default_rng(4)
    idx = rng.integers(0, const.size, size=(2, 3000))
    tx = const[idx]
    out = np.stack([np.roll(tx[1], -4) * 1j, np.roll(tx[0], -3) * -1])   # swapped, turned, delayed
    t_out, t_ref = torch.as_tensor(out), torch.as_tensor(tx)
    assert ser_gate(t_out, t_ref, const) == 0.0
    assert torch.equal(workload.decide(t_ref, const), t_ref)
    assert torch.equal(workload.nearest_idx(t_ref[0], const), torch.as_tensor(idx[0]))
    bad = out.copy()
    wrong = np.arange(GATE_TRIM, GATE_TRIM + 26)
    bad[0, wrong] = const[(idx[1, wrong + 4] + 1) % const.size] * 1j
    assert ser_gate(torch.as_tensor(bad), t_ref, const) == pytest.approx(26 / 2600 / 2)
    # one polarisation on both outputs cannot pass: the pairing is a permutation
    assert ser_gate(torch.as_tensor(np.stack([out[0], out[0]])), t_ref, const) > 0.4
    assert shared_decisions(t_out, torch.as_tensor(out * 1j), const) == 1.0


@pytest.mark.parametrize("kw", [dict(M=32), dict(M=128), dict(const=ALPHABETS["w64"]),
                                dict(const=ALPHABETS["apsk"], snr=30),
                                dict(const=_qam(16), probs=np.arange(1.0, 17.0))],
                         ids=["x32", "x128", "w64", "apsk", "shaped16"])
def test_make_tx_equals_the_benchs(kw):
    got, ref = workload.make_tx(2 ** 10, seed=5, **kw), bench.make_tx(2 ** 10, seed=5, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


def test_alphabets_equal_the_reference_tools():
    import sys
    sys.path.insert(0, "tools")
    import genbench
    for M in (64, 256):
        assert np.array_equal(workload.warped_qam(M), genbench.warped_qam(M))
    assert np.array_equal(workload.apsk_const(32), genbench.apsk_const(32))
    with pytest.raises(ValueError, match="32-point"):
        workload.apsk_const(16)
