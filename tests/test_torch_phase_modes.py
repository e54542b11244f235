"""The port's per-sample carrier recovery (B7, B8, two-stage search, B3) against the JAX package.

Each plain PyTorch version is what its CUDA kernel is held against on the
card (tests/test_torch_cuda.py, chip_smoke.py); here it is held against the
reference's Pallas kernel in interpret mode on the CPU, on inputs made with
numpy from a seed.

XLA on the CPU fuses a*b + c into one FMA where the port rounds the product
and the sum separately, so values computed by such an expression may differ
by an ulp between the two packages; the tests below say where that matters.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qampy_tpu.ops.phase_pallas import (_make_dist_fn, bps_fine_pallas, bps_idx_pallas,
                                        bps_phase_twostage_pallas, unwrap_derotate_pallas)
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.phase_cuda import (HALF_PI, INV_HALF_PI, bps_fine_plain,
                                            bps_search_plain, bps_twostage, quarter_unwrap,
                                            unwrap_derotate_plain)
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from test_torch_kernels import _bps_planes, rotation_error_bound

CONST = (cal_symbols_qam(64) / np.sqrt(cal_scaling_factor_qam(64))).astype(np.complex64)
GRID = tph.detect_grid(CONST)
A1, B = 16, 8
# one float32 rounding of a value below 1 rad is at most 2^-25; the phases
# here (|ph| < 1) may differ by the FMA's rounding of the offset term
PHASE_ULPS = 2.0 ** -22


def _angles(A):
    return np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)


def _tables(A):
    return tuple(torch.as_tensor(t) for t in tph.bps_tables(_angles(A), GRID))


def _fine():
    cd, sd, d0f, ddf = tph.fine_tables(A1, B, GRID)
    return torch.as_tensor(cd), torch.as_tensor(sd), d0f, ddf


# ---------------------------------------------------------------------------
# B7
# ---------------------------------------------------------------------------

def _wrapped_phase(seed, L):
    """A random-walk carrier phase wrapped into [-pi/4, pi/4): many pi/2 jumps."""
    rng = np.random.default_rng(seed)
    theta = np.cumsum(rng.normal(scale=0.2, size=(2, L)), axis=-1) + np.array([[3.0], [-2.0]])
    ph = (np.mod(theta + np.pi / 4, np.pi / 2) - np.pi / 4).astype(np.float32)
    er = rng.standard_normal((2, L)).astype(np.float32)
    ei = rng.standard_normal((2, L)).astype(np.float32)
    return er, ei, ph


class TestB7UnwrapDerotate:
    def test_against_pallas_and_formula(self):
        L = 3 * 2048 + 777     # not a multiple of the reference's tile
        er, ei, ph = _wrapped_phase(21, L)
        assert np.sum(np.abs(np.diff(ph, axis=-1)) > np.pi / 4) > 100
        ref_r, ref_i = (np.asarray(x) for x in unwrap_derotate_pallas(
            None, ph, T=2048, planes=(er, ei), planes_out=True, interpret=True))
        got_r, got_i = (x.numpy() for x in unwrap_derotate_plain(
            *(torch.as_tensor(x) for x in (er, ei, ph))))
        # u = ph - (pi/2) M in float64 with the port's (integer) jump counts M
        u32 = quarter_unwrap(torch.as_tensor(ph)).numpy()
        M = np.round((ph.astype(np.float64) - u32) / HALF_PI)
        u = ph.astype(np.float64) - HALF_PI * M
        assert np.abs(np.diff(u, axis=-1)).max() <= np.pi / 4
        bound = rotation_error_bound(er, ei, u)
        z = (er + 1j * ei.astype(np.float64)) * np.exp(1j * u)
        for want_r, want_i in ((ref_r, ref_i), (z.real, z.imag)):
            assert np.all(np.abs((got_r - want_r) + 1j * (got_i - want_i)) <= bound)

    def test_separately_rounded_rule_at_exact_quarter_steps(self):
        """The port's jump count, a numpy statement of it, at exact and near pi/4 steps."""
        lo, step = np.float32(-np.pi / 4), np.float32(np.pi / 2 / 64)
        grid_ph = lo + step * np.arange(64, dtype=np.float32)      # the single mode's map
        # steps of exactly 32 grid angles (pi/4) up and down, and one an ulp
        # below pi/4, where XLA's fused d*(2/pi) + 0.5 rounds the other way
        below = np.nextafter(np.float32(np.pi / 4), np.float32(0))
        ph = np.array([[grid_ph[0], grid_ph[32], grid_ph[0], grid_ph[63], grid_ph[31],
                        grid_ph[63], np.float32(0), below, np.float32(0)]], np.float32)
        d = np.concatenate([[np.float32(0)], ph[0, 1:] - ph[0, :-1]]).astype(np.float32)
        m = np.floor(np.float32(d * np.float32(INV_HALF_PI)) + np.float32(0.5))
        u = ph[0] - np.float32(HALF_PI) * np.cumsum(m).astype(np.float32)
        got = quarter_unwrap(torch.as_tensor(ph)).numpy()[0]
        assert np.array_equal(got, u.astype(np.float32))
        # +pi/4 exactly counts a jump, -pi/4 exactly does not, nor the step
        # an ulp below +pi/4 in XLA's fused form
        assert m[[1, 2, 7]].tolist() == [1, 0, 1]
        fused = jax.jit(lambda x: jnp.floor(x * np.float32(INV_HALF_PI) + 0.5))(d[7:8])
        assert float(np.asarray(fused)[0]) == 0.0      # the reference on the CPU counts 0 here
        # 1 + 0j comes out as exp(+j u)
        er, ei = np.ones_like(ph), np.zeros_like(ph)
        out_r, out_i = unwrap_derotate_plain(*(torch.as_tensor(x) for x in (er, ei, ph)))
        tu = torch.as_tensor(u.astype(np.float32))
        assert torch.equal(out_r[0], torch.cos(tu)) and torch.equal(out_i[0], torch.sin(tu))

    def test_rejects_mismatched_shapes(self):
        er, ei, ph = (torch.as_tensor(x) for x in _wrapped_phase(3, 64))
        with pytest.raises(ValueError):
            unwrap_derotate_plain(er, ei, ph[:, :-1])


# ---------------------------------------------------------------------------
# B3 at the per-sample modes' shapes, B8 and the two-stage search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("A, N", [(16, 60), (64, 14)])
def test_b3_at_full_rate_shapes(A, N):
    """B3 as twostage's coarse stage (A=16, N=60) and as single's search (A=64, N=14)."""
    er, ei = _bps_planes(30 + A)
    ref = np.asarray(bps_idx_pallas(None, _angles(A), GRID, N, T=2048, planes=(er, ei)))
    cos_t, sin_t = _tables(A)
    ter, tei = torch.as_tensor(er), torch.as_tensor(ei)
    got = bps_search_plain(ter, tei, cos_t, sin_t, GRID, N).numpy()
    ties = tph.bps_near_ties(ter, tei, cos_t, sin_t, GRID, N).numpy()
    assert np.all((got == ref) | ties) and ties.mean() <= 1e-3
    assert not got[:, :N].any() and not got[:, -N:].any()


def _coarse_phase(er, ei):
    cos1, sin1 = _tables(A1)
    idx = bps_search_plain(torch.as_tensor(er), torch.as_tensor(ei), cos1, sin1, GRID, 60)
    return (np.float32(-np.pi / 4) + np.float32(np.pi / 2 / A1) * idx.numpy().astype(np.float32))


class TestB8FineSearch:
    def test_fine_tables_against_reference_formula(self):
        """phase_pallas.py:551-554, 585-586 and 591-592, written out."""
        cd, sd, d0f, ddf = tph.fine_tables(A1, B, GRID)
        deltas = np.linspace(-B / 2, B / 2, B) / (B * A1) * np.pi / 2
        scale = _make_dist_fn(GRID)[1]
        np.testing.assert_array_equal(cd, (np.cos(deltas) * scale).astype(np.float32))
        np.testing.assert_array_equal(sd, (np.sin(deltas) * scale).astype(np.float32))
        assert d0f == np.float32(deltas[0]) and ddf == np.float32(deltas[1] - deltas[0])
        # the offsets span one coarse step
        assert abs((deltas[-1] - deltas[0]) - np.pi / 2 / A1) < 1e-12

    @pytest.mark.parametrize("N", [14, 60])
    def test_against_pallas(self, N):
        er, ei = _bps_planes(40 + N)
        ph1 = _coarse_phase(er, ei)
        ref = np.asarray(bps_fine_pallas(None, ph1, A1, B, GRID, N, T=2048, planes=(er, ei)))
        cd, sd, d0f, ddf = _fine()
        t = [torch.as_tensor(x) for x in (er, ei, ph1)]
        got = bps_fine_plain(*t, cd, sd, GRID, N, d0f, ddf).numpy()
        base = (ph1 + np.float32(d0f)).astype(np.float32)
        idx_got = np.round((got.astype(np.float64) - base) / ddf)
        idx_ref = np.round((ref.astype(np.float64) - base) / ddf)
        assert set(np.unique(idx_got)) <= set(range(B))
        ties = tph.bps_fine_near_ties(*t, cd, sd, GRID, N).numpy()
        assert ties.mean() <= 1e-3
        assert np.all((idx_got == idx_ref) | ties)
        # the port's phase is the separately rounded (ph1 + d0f) + ddf idx; the
        # reference's may differ from it by the FMA's last rounding
        want = base + (np.float32(ddf) * idx_got.astype(np.float32)).astype(np.float32)
        assert np.array_equal(got, want.astype(np.float32))
        assert np.abs(got - ref)[~ties].max() <= PHASE_ULPS
        # outside [N, L-N) the phase is ph1 + d0f
        assert np.array_equal(got[:, :N], base[:, :N]) and np.array_equal(got[:, -N:], base[:, -N:])

    def test_twostage_against_pallas(self):
        er, ei = _bps_planes(50)
        N = 14
        ref = np.asarray(bps_phase_twostage_pallas(None, A1, B, GRID, N, T=2048, N1=60,
                                                   planes=(er, ei)))
        cos1, sin1 = _tables(A1)
        cd, sd, d0f, ddf = _fine()
        ter, tei = torch.as_tensor(er), torch.as_tensor(ei)
        got = bps_twostage(ter, tei, cos1, sin1, 60, cd, sd, GRID, N, d0f, ddf).numpy()
        # excused: coarse near-ties, any position whose fine window holds one,
        # and fine near-ties
        coarse = tph.bps_near_ties(ter, tei, cos1, sin1, GRID, 60).numpy()
        near = np.convolve(coarse[0], np.ones(2 * N + 1), "same") > 0
        near = np.stack([near, np.convolve(coarse[1], np.ones(2 * N + 1), "same") > 0])
        ph1 = torch.as_tensor(_coarse_phase(er, ei))
        fine = tph.bps_fine_near_ties(ter, tei, ph1, cd, sd, GRID, N).numpy()
        ok = ~(near | fine)
        assert ok.mean() >= 0.99
        assert np.abs(got - ref)[ok].max() <= PHASE_ULPS

    def test_rejects_mismatched_tables(self):
        er, ei = (torch.as_tensor(x) for x in _bps_planes(3, L=256))
        cd, sd, d0f, ddf = _fine()
        with pytest.raises(ValueError):
            bps_fine_plain(er, ei, er, cd, sd[:-1], GRID, 14, d0f, ddf)
        with pytest.raises(ValueError):
            bps_fine_plain(er, ei, er[:, :-1], cd, sd, GRID, 14, d0f, ddf)
