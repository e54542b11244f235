"""The rest of carrier recovery (the ``ops.phase`` drivers) against the JAX package.

One capture per constellation is made by the JAX package (its signal and
impairments, 2^14 symbols a mode) and handed to both packages as numpy
arrays (``phaserec`` on signal objects: ``tests/test_torch_phaserec_signals.py``). The port's kernel
route (``method="pallas"``; on CPU tensors the kernels' plain versions) is
held against the reference's Pallas branch in interpret mode: indices equal
off near-ties, so phases equal there within PHASE_ULPS ulps of their size
(the reference's unwrap sums its corrections in another order). Against
the reference's XLA branch, which forms its angles another way, the test
compares decisions. Viterbi-Viterbi and the 16-QAM partition, which the
reference leaves to XLA, within the tolerance each test states.
"""
import numpy as np
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from qampy_tpu import impairments as rimp
from qampy_tpu import signals as rsig
from qampy_tpu.ops import phase as rph
from qampy_tpu_torch.core.metrics import cal_s0
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops import phase_cuda
from qampy_tpu_torch.ops.phase_cuda import quarter_unwrap
from qampy_tpu_torch.workload import shared_decisions
from test_torch_kernels import rotation_error_bound
from test_torch_signals import first_vml_call  # noqa: F401 (autouse fixture)

CPU = "cpu"
L = 2 ** 14
# phases off near-ties: a few float32 ulps of their magnitude (the unwrap's
# corrections are summed in another order by the two packages)
PHASE_ULPS = 8


def _capture(M, lw, snr, seed=2, fb=40e9, fo=None, nmodes=2, N=L):
    s = rsig.SignalQAMGrayCoded(M, N, nmodes=nmodes, fb=fb, seed=seed)
    s = rimp.change_snr(s, snr, key=jr.PRNGKey(seed))
    s = rimp.apply_phase_noise(s, lw, key=jr.PRNGKey(seed + 1))
    if fo is not None:
        s = rimp.add_carrier_offset(s, fo)
    return s


@pytest.fixture(scope="module")
def qam64():
    return _capture(64, 100e3, 30, seed=3)


@pytest.fixture(scope="module")
def qam16():
    return _capture(16, 50, 30, seed=2)


@pytest.fixture(scope="module")
def qpsk():
    return _capture(4, 100, 25, seed=2)


def _phase_tol(ph):
    return PHASE_ULPS * np.spacing(np.float32(max(1.0, float(np.abs(ph).max()))))


def _near_ties(E, A, N, grid):
    """Positions where B3's two best windows lie within 1e-5 (either side may pick either)."""
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (torch.as_tensor(t) for t in tph.bps_tables(ang, grid))
    Et = torch.atleast_2d(torch.as_tensor(E))
    return tph.bps_near_ties(Et.real.contiguous(), Et.imag.contiguous(), cos_t, sin_t, grid,
                             N).numpy()


def _hold_phases(ph_t, ph_r, E, out_t, out_r, ties):
    ph_t, ph_r = np.atleast_2d(ph_t), np.atleast_2d(ph_r)
    # a differing index at a near-tie moves that position's phase by a step
    ok = ~ties
    assert np.abs(ph_t - ph_r)[ok].max() <= _phase_tol(ph_r)
    E2 = np.atleast_2d(E)
    bound = rotation_error_bound(E2.real, E2.imag, ph_r) + np.abs(E2) * _phase_tol(ph_r)
    assert np.all((np.abs(np.atleast_2d(out_t) - np.atleast_2d(out_r)) <= bound)[ok])


@pytest.mark.parametrize("A, N", [(64, 14), (32, 10), (4, 14)])
def test_bps_against_pallas(qam64, A, N):
    E, c = np.asarray(qam64.samples), np.asarray(qam64.coded_symbols)
    out_r, ph_r = (np.asarray(x) for x in rph.bps(E, A, c, N, method="pallas"))
    out_t, ph_t = (x.numpy() for x in tph.bps(torch.as_tensor(E), A, c, N, method="pallas"))
    assert out_t.shape == out_r.shape and ph_t.dtype == np.float32
    _hold_phases(ph_t, ph_r, E, out_t, out_r, _near_ties(E, A, N, tph.detect_grid(c)))


def test_bps_one_dimensional(qam64):
    """A 1-D capture gives 1-D outputs, equal to its row of the 2-D call."""
    E, c = np.asarray(qam64.samples)[1], np.asarray(qam64.coded_symbols)
    out_r, ph_r = (np.asarray(x) for x in rph.bps(E, 32, c, 12, method="pallas"))
    out_t, ph_t = tph.bps(torch.as_tensor(E), 32, c, 12, method="pallas")
    assert out_t.shape == ph_t.shape == (L,) == ph_r.shape
    _hold_phases(ph_t.numpy(), ph_r, E, out_t.numpy(), out_r,
                 _near_ties(E, 32, 12, tph.detect_grid(c)))
    o2, p2 = tph.bps(torch.as_tensor(np.asarray(qam64.samples)), 32, c, 12, method="pallas")
    assert torch.equal(p2[1], ph_t) and torch.equal(o2[1], out_t)


@pytest.mark.parametrize("B, N1, dim", [(8, None, 2), (4, 20, 2), (8, None, 1)])
def test_bps_twostage_against_pallas(qam64, B, N1, dim):
    E, c = np.asarray(qam64.samples), np.asarray(qam64.coded_symbols)
    if dim == 1:
        E = E[0]
    out_r, ph_r = (np.asarray(x) for x in rph.bps_twostage(E, 32, c, 14, B=B, N1=N1,
                                                           method="pallas"))
    out_t, ph_t = (x.numpy() for x in tph.bps_twostage(torch.as_tensor(E), 32, c, 14, B=B,
                                                       N1=N1, method="pallas"))
    assert out_t.shape == out_r.shape == E.shape
    # the fine stage's near-ties: its offsets around the coarse phase
    E2 = torch.atleast_2d(torch.as_tensor(E))
    grid = tph.detect_grid(c)
    ties = _near_ties(E, 32, 14 if N1 is None else N1, grid)
    cd, sd, _, _ = tph.fine_tables(32, B, grid)
    ph1 = torch.as_tensor(np.atleast_2d(ph_r))        # within a step: a fine window's neighbour
    ties |= tph.bps_fine_near_ties(E2.real.contiguous(), E2.imag.contiguous(), ph1,
                                   torch.as_tensor(cd), torch.as_tensor(sd), grid, 14).numpy()
    _hold_phases(ph_t, ph_r, E, out_t, out_r, ties.reshape(np.atleast_2d(ph_r).shape))


@pytest.mark.parametrize("fn", ["bps", "bps_twostage"])
def test_against_xla_branch_by_decisions(qam64, fn):
    """The reference's XLA branch (its CPU default) forms its angles another way: decisions."""
    E, c = np.asarray(qam64.samples), np.asarray(qam64.coded_symbols)
    args = (32, c, 14)
    out_r = np.asarray(getattr(rph, fn)(E, *args)[0])
    for method in (None, "pyt", "pallas"):
        out_t = getattr(tph, fn)(torch.as_tensor(E), *args, method=method)[0]
        agree = shared_decisions(torch.as_tensor(out_r[:, 20:-20]), out_t[:, 20:-20],
                                 torch.as_tensor(c))
        assert agree >= 0.999


def test_unwrap_rule_at_exact_quarter_steps():
    """+-pi/4 steps stay (jnp.unwrap(4 ph) / 4); B7's floor rule counts a jump at +pi/4 only."""
    q = np.float32(np.pi) / np.float32(4)
    ph = np.array([[0.0, q, 0.0, -q, 0.0, 2 * q, 2 * q + q, 0.1]], dtype=np.float32)
    ref = np.asarray(jnp.unwrap(jnp.asarray(ph) * 4, axis=-1) / 4)
    got = (tph.unwrap(torch.as_tensor(ph) * 4) / 4).numpy()
    assert np.array_equal(got, ref)
    assert got[0, 1] == q and got[0, 3] == -q          # both exact quarter steps kept
    up, down = torch.tensor([[0.0, q]]), torch.tensor([[0.0, -q]])
    assert quarter_unwrap(down)[0, 1] == -q                 # B7 keeps -pi/4 too,
    assert quarter_unwrap(up)[0, 1] == q - np.float32(np.pi / 2)   # but counts a jump at +pi/4
    assert (tph.unwrap(up * 4) / 4)[0, 1] == q
    # a random walk with many wraps: equal to jnp.unwrap off the order of its sums
    rng = np.random.default_rng(0)
    p = np.cumsum(rng.normal(scale=1.5, size=(2, 3000)), axis=-1).astype(np.float32)
    np.testing.assert_allclose(tph.unwrap(torch.as_tensor(p)).numpy(),
                               np.asarray(jnp.unwrap(jnp.asarray(p), axis=-1)), atol=5e-5)
    assert tph.unwrap(torch.zeros((2, 0))).shape == (2, 0)


@pytest.mark.parametrize("shape", [(2, 2 ** 16 + 37), (3 * 2 ** 16,)], ids=["rows", "1-D"])
def test_row_cumsum_of_long_rows(shape):
    """Rows of 2^16 and more are scanned in blocks: within 16 float32 ulps of the row's largest
    partial sum (a float32 running sum's rounding), of the shape given, on real and complex rows;
    the unwrap of such rows equals jnp.unwrap's within 8 ulps of its largest value."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    exact = np.cumsum(x.astype(np.float64), axis=-1)
    got = tph.row_cumsum(torch.as_tensor(x)).numpy()
    assert got.shape == x.shape
    big = np.abs(exact).max(axis=-1, keepdims=True).astype(np.float32)
    assert np.all(np.abs(got - exact) <= 16 * np.spacing(big))
    z = torch.complex(torch.as_tensor(x), torch.as_tensor(-x)).to(torch.complex128)
    np.testing.assert_allclose(tph.row_cumsum(z).numpy(), exact * (1 - 1j), rtol=1e-12, atol=1e-9)
    p = np.cumsum(rng.normal(scale=1.5, size=shape), axis=-1).astype(np.float32)
    ref = np.asarray(jnp.unwrap(jnp.asarray(p), axis=-1))
    np.testing.assert_allclose(tph.unwrap(torch.as_tensor(p)).numpy(), ref,
                               atol=8 * float(np.spacing(np.float32(np.abs(ref).max()))))


def test_select_angles():
    """The chosen angle per sample, for shared and per-sample angle tables."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 8, 300).astype(np.int32)
    for angles in (rng.standard_normal((1, 8)), rng.standard_normal((300, 8))):
        angles = angles.astype(np.float32)
        assert np.array_equal(tph.select_angles(torch.as_tensor(angles), torch.as_tensor(idx)).numpy(),
                              np.asarray(rph.select_angles(angles, idx)))


def test_bps_edges_keep_the_raw_phase(qam64):
    """bps unwraps [N, L-N) only: the first and last N keep index 0's -pi/4."""
    E, c = np.asarray(qam64.samples), np.asarray(qam64.coded_symbols)
    _, ph = tph.bps(torch.as_tensor(E), 16, c, 9)
    assert torch.all(ph[:, :9] == np.float32(-np.pi / 4)) and torch.all(ph[:, -9:] ==
                                                                        np.float32(-np.pi / 4))
    _, ph0 = tph.bps(torch.as_tensor(E), 16, c, 0)
    assert ph0.shape == E.shape


def test_dispatch_rule(monkeypatch, qam64):
    """The route from the alphabet alone: pallas runs the kernels, pyt the plain path, None the
    kernels on the card wherever the reference takes Pallas (a grid, or <= 256 points)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    sq = tph.detect_grid(np.asarray(qam64.coded_symbols))
    ring = np.exp(2j * np.pi * np.arange(300) / 300)
    gen256, gen300 = tph.search_grid(ring[:256] * (1 + 0.1 * (np.arange(256) % 2))), \
        tph.search_grid(ring)
    assert gen256[0] == gen300[0] == "gen"
    assert tph.use_kernels(sq, None, cuda) and tph.use_kernels(gen256, None, cuda)
    assert not tph.use_kernels(gen300, None, cuda)
    assert not any(tph.use_kernels(g, None, cpu) for g in (sq, gen256))
    assert all(tph.use_kernels(g, "pallas", d) for g in (sq, gen300) for d in (cpu, cuda))
    assert not any(tph.use_kernels(sq, "pyt", d) for d in (cpu, cuda))
    assert tph.search_grid(np.array([1 + 0j]))[0] == "gen"
    calls = []
    for name in ("bps_search", "bps_twostage", "rotate"):
        real = getattr(phase_cuda, name)
        monkeypatch.setattr(phase_cuda, name, lambda *a, _f=real, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    E = torch.as_tensor(np.asarray(qam64.samples)[:, :2048])
    c = np.asarray(qam64.coded_symbols)
    for method, want in ((None, []), ("pyt", []), ("pallas", ["bps_search", "rotate"])):
        calls.clear()
        tph.bps(E, 4, c, 14, method=method)
        assert calls == want, method
    calls.clear()
    tph.bps_twostage(E, 4, c, 14, B=8, method="pallas")
    assert calls == ["bps_twostage", "bps_search", "rotate"]  # B3, then B8, inside


def test_plain_path_takes_large_alphabets():
    """More than 256 points: no kernel takes them, the plain path searches them all."""
    rng = np.random.default_rng(3)
    ring = (np.exp(2j * np.pi * np.arange(300) / 300) * (1 + 0.3 * (np.arange(300) % 3))
            ).astype(np.complex64)
    E = ring[rng.integers(0, 300, (1, 512))] * np.exp(0.05j)
    out, ph = tph.bps(torch.as_tensor(E.astype(np.complex64)), 8, ring, 6)
    assert out.shape == (1, 512) and torch.isfinite(ph).all()


@pytest.mark.parametrize("N, dim", [(11, 2), (12, 2), (11, 1)])
def test_viterbiviterbi(qpsk, N, dim):
    """Phase within 2e-5 rad: the reference sums each N-window of float32 values directly, the
    port differences a float64 running sum (either within N ulps of the window's sum, of
    magnitude ~N here); E out zero outside [lo, hi) in both."""
    E = np.asarray(qpsk.samples)
    if dim == 1:
        E = E[0]
    out_r, ph_r = (np.asarray(x) for x in rph.viterbiviterbi(E, N, 4))
    out_t, ph_t = (x.numpy() for x in tph.viterbiviterbi(torch.as_tensor(E), N, 4))
    assert ph_t.shape == ph_r.shape and out_t.shape == out_r.shape
    np.testing.assert_allclose(ph_t, ph_r, atol=2e-5)
    assert np.array_equal(out_t == 0, out_r == 0)
    np.testing.assert_allclose(out_t, out_r, atol=2e-5 * np.abs(E).max())


@pytest.mark.parametrize("Nblock, L_", [(128, L), (100, L)], ids=["whole blocks", "tail"])
def test_phase_partition_16qam(qam16, Nblock, L_):
    """Block phases within 2e-6 rad (block sums of float32 values in another order).

    A sample whose |E| lies within a few ulps of a ring threshold may be
    classed differently (|E| and S0 are float32 in both, rounded in another
    order): its block is excused, and such samples must be that close.
    """
    E = np.asarray(qam16.samples)[:, :L_]
    out_r, ph_r = (np.asarray(x) for x in rph.phase_partition_16qam(E, Nblock))
    out_t, ph_t = (x.numpy() for x in tph.phase_partition_16qam(torch.as_tensor(E), Nblock))
    ok = np.ones(E.shape, dtype=bool)
    for m in range(2):
        c1_t = tph.partition_16qam(torch.as_tensor(E[m]))[0].numpy()
        c1_r = np.asarray(rph.partition_16qam(E[m])[0])
        S0 = float(cal_s0(torch.as_tensor(E[m]), 1.32))
        edges = np.array([np.sqrt(S0 / 5) + np.sqrt(S0), np.sqrt(9 * S0 / 5) + np.sqrt(S0)]) / 2
        for i in np.nonzero(c1_t != c1_r)[0]:
            assert np.min(np.abs(np.abs(E[m, i]) - edges)) < 4e-7 * edges.max()
            ok[m, (i // Nblock) * Nblock:(i // Nblock + 1) * Nblock] = False
            if i >= (L_ // Nblock) * Nblock - Nblock:
                ok[m, (L_ // Nblock) * Nblock:] = False
    assert ok.mean() > 0.99
    np.testing.assert_allclose(ph_t[ok], ph_r[ok], atol=2e-6)
    np.testing.assert_allclose(out_t[ok], out_r[ok], atol=4e-6)
    tail = (L_ // Nblock) * Nblock
    assert np.all(ph_t[:, tail:] == ph_t[:, tail - 1:tail])
    o1, p1 = tph.phase_partition_16qam(torch.as_tensor(E[1]), Nblock)
    assert o1.shape == p1.shape == (L_,) and torch.equal(p1, torch.as_tensor(ph_t[1]))
