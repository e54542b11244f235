"""The port's plain kernel versions (B1-B4) and the decimated glue against the JAX package.

Each plain PyTorch version is what the CUDA kernel of the same name is held
against on the card (tests/test_torch_cuda.py, chip_smoke.py); here it is
held against the reference's Pallas kernel in interpret mode on the CPU,
on inputs made with numpy from a seed.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
from qampy_tpu.ops import equaliser as jeq
from qampy_tpu.ops.equaliser_pallas import (apply_filter_pallas_planes,
                                            train_equaliser_block_pallas)
from qampy_tpu.ops.phase_pallas import bps_idx_pallas, interp_rotate_planes_pallas
from qampy_tpu.ops.phase import bps_idx as jax_bps_idx
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import decimated_derotation_inputs
from qampy_tpu_torch.ops.equaliser_cuda import apply_filter_plain, train_block_plain
from qampy_tpu_torch.ops import phase_cuda as tpc
from qampy_tpu_torch.ops.phase_cuda import (bps_search_plain, interp_rotate_plain,
                                            unwrap_slopes_plain)
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam

M, NTAPS, OS, MU, S = 64, 17, 2, 1.9e-3, 256
TRS = 2 ** 13
CONST = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
GRID = tph.detect_grid(CONST)
ANGLES = np.linspace(-np.pi / 4, np.pi / 4, 64, endpoint=False, dtype=np.float32)


@pytest.fixture(scope="module")
def capture():
    E, _, _ = bench.make_tx(2 ** 14, seed=3)
    P = np.concatenate([E.real, E.imag]).astype(np.float32)
    return E, P


@pytest.fixture(scope="module")
def trained(capture):
    """Both reference trainings (Pallas, interpret mode) on the 2^13-symbol prefix."""
    E, _ = capture
    w0 = jeq._init_taps(NTAPS, 2, 2, np.complex64)
    s1 = jeq._reshape_symbols(None, "mcma", M, np.complex64, 2)
    s2 = jeq._reshape_symbols(None, "mddma", M, np.complex64, 2)
    r1 = train_equaliser_block_pallas(jnp.asarray(E), TRS, 1, OS, MU, w0, s1, "mcma",
                                      adaptive=True, block_size=S)
    r2 = train_equaliser_block_pallas(jnp.asarray(E), TRS, 1, OS, MU, np.asarray(r1[1]), s2,
                                      "mddma", adaptive=True, block_size=S)
    return [tuple(np.asarray(x) for x in r) for r in (r1, r2)], (w0, s1, s2)


def _port_train(P, w, symbols, method):
    spec = teq.err_spec(method, symbols)
    return train_block_plain(torch.as_tensor(P), TRS, 1, OS, MU, torch.tensor(w), spec,
                             adaptive=True, block_size=S)


class TestB1BlockTrainer:
    # Both sides sum in float32 in different orders; over 32 dependent
    # blocks the taps drift by ~1e-7 (measured), so 1e-4 is a wide margin
    # that still catches any wrong term of the update.
    def test_mcma_stage(self, capture, trained):
        (err, w, mu), _ = trained[0]
        w0, s1, _ = trained[1]
        e_t, w_t, mu_t = _port_train(capture[1], w0, s1, "mcma")
        assert np.abs(w_t.numpy() - w).max() <= 1e-4
        np.testing.assert_allclose(mu_t.numpy(), mu, rtol=1e-5)
        assert e_t.shape == err.shape == (2, TRS)
        assert np.abs(e_t.numpy() - err).max() <= 1e-4

    def test_mddma_stage_on_first_taps(self, capture, trained):
        (_, w1, _), (err, w, mu) = trained[0]
        _, _, s2 = trained[1]
        e_t, w_t, mu_t = _port_train(capture[1], w1, s2, "mddma")
        assert np.abs(w_t.numpy() - w).max() <= 1e-4
        np.testing.assert_allclose(mu_t.numpy(), mu, rtol=1e-5)
        assert np.abs(e_t.numpy() - err).max() <= 1e-4

    def test_adaptive_step_shrinks(self, trained):
        (_, _, mu1), (_, _, mu2) = trained[0]
        assert np.all(mu1 < MU) and np.all(mu2 < MU)

    def test_complex_api_matches_xla_trainer(self, capture):
        """The complex-signal entry against the reference's XLA block trainer (mcma)."""
        E, _ = capture
        w0 = jeq._init_taps(NTAPS, 2, 2, np.complex64)
        s1 = jeq._reshape_symbols(None, "mcma", M, np.complex64, 2)
        err, w, mu = (np.asarray(x) for x in jeq.train_equaliser_block(
            jnp.asarray(E), 2048, 1, OS, MU, w0, s1, "mcma", adaptive=True, block_size=S))
        e_t, w_t, mu_t = teq.train_equaliser_block(torch.as_tensor(E), 2048, 1, OS, MU,
                                                   torch.as_tensor(w0), s1, "mcma",
                                                   adaptive=True, block_size=S)
        assert np.abs(w_t.numpy() - w).max() <= 1e-4
        np.testing.assert_allclose(mu_t.numpy(), mu, rtol=1e-5)
        assert np.abs(e_t.numpy() - err).max() <= 1e-4


class TestB2Filter:
    # float32 sums of 68 products on both sides: ~1e-7 relative, so 1e-5 x rms
    def test_full_and_decimated_planes(self, capture, trained):
        P = capture[1]
        (_, w, _) = trained[0][1]
        ref_out, ref_dec = (np.asarray(x) for x in apply_filter_pallas_planes(
            P, OS, w, mat_dtype=jnp.float32, dec_stride=16))
        out, dec = apply_filter_plain(torch.as_tensor(P), OS, torch.tensor(w), 16)
        assert out.shape == ref_out.shape and dec.shape == ref_dec.shape
        rms = np.sqrt(np.mean(ref_out ** 2))
        assert np.abs(out.numpy() - ref_out).max() <= 1e-5 * rms
        assert np.abs(dec.numpy() - ref_dec).max() <= 1e-5 * rms

    def test_complex_api_matches_xla_filter(self, capture, trained):
        E = capture[0]
        (_, w, _) = trained[0][1]
        ref = np.asarray(jeq.apply_filter_to_signal(jnp.asarray(E), OS, w))
        out = teq.apply_filter_to_signal(torch.as_tensor(E), OS, torch.tensor(w)).numpy()
        # the XLA filter runs a 3-pass bf16 (HIGH) contraction: ~2^-22 relative
        assert np.abs(out - ref).max() <= 1e-5 * np.sqrt(np.mean(np.abs(ref) ** 2))


def _bps_planes(seed, L=2 ** 14, snr_db=22):
    """Two modes of 64-QAM with a random-walk carrier phase and AWGN, as float32 planes."""
    rng = np.random.default_rng(seed)
    syms = CONST[rng.integers(0, M, size=(2, L))]
    ph = np.cumsum(rng.normal(scale=0.01, size=(2, L)), axis=-1)
    noise = 10 ** (-snr_db / 20) / np.sqrt(2) * (rng.standard_normal((2, L))
                                                 + 1j * rng.standard_normal((2, L)))
    z = (syms * np.exp(1j * ph) + noise).astype(np.complex64)
    return np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)


def _near_tie_mask(er, ei, N):
    cos_h, sin_h = tph.bps_tables(ANGLES, GRID)
    return tph.bps_near_ties(torch.as_tensor(er), torch.as_tensor(ei), torch.as_tensor(cos_h),
                             torch.as_tensor(sin_h), GRID, N).numpy()


class TestB3PhaseSearch:
    @pytest.mark.parametrize("seed", [5, 6])
    def test_indices_against_pallas(self, seed):
        N = 12
        er, ei = _bps_planes(seed)
        ref = np.asarray(bps_idx_pallas(None, ANGLES, GRID, N, T=2048, win_dtype=None,
                                        planes=(er, ei)))
        cos_h, sin_h = tph.bps_tables(ANGLES, GRID)
        got = bps_search_plain(torch.as_tensor(er), torch.as_tensor(ei),
                               torch.as_tensor(cos_h), torch.as_tensor(sin_h), GRID, N).numpy()
        assert got.dtype == np.int32 and got.shape == ref.shape
        assert np.all(got[:, :N] == 0) and np.all(got[:, -N:] == 0)
        ties = _near_tie_mask(er, ei, N)
        # indices equal except at near-ties of the reference's window sums,
        # which two summation orders may resolve either way
        assert np.all((got == ref) | ties)
        assert ties.mean() <= 1e-3

    def test_complex_api_against_xla(self):
        N = 10
        er, ei = _bps_planes(7, L=4096)
        z = er[0] + 1j * ei[0]
        ref = np.asarray(jax_bps_idx(jnp.asarray(z), ANGLES[None, :], CONST, N, grid=GRID))
        got = tph.bps_idx(torch.as_tensor(z), ANGLES, CONST, N).numpy()
        ties = _near_tie_mask(er[:1], ei[:1], N)[0]
        assert np.all((got == ref) | ties)

    def test_short_signal_is_all_zero(self):
        er, ei = _bps_planes(8, L=20)
        cos_h, sin_h = tph.bps_tables(ANGLES, GRID)
        got = bps_search_plain(torch.as_tensor(er), torch.as_tensor(ei),
                               torch.as_tensor(cos_h), torch.as_tensor(sin_h), GRID, 12)
        assert not got.any()


def _interp_inputs(seed, L=8192, dx=16):
    rng = np.random.default_rng(seed)
    er = rng.standard_normal((2, L)).astype(np.float32)
    ei = rng.standard_normal((2, L)).astype(np.float32)
    # phases of tens of radians, as the unwrapped blind phase reaches
    a = (np.cumsum(rng.normal(scale=0.5, size=(2, L // dx)), axis=-1)
         + np.array([[30.0], [-45.0]])).astype(np.float32)
    b = rng.normal(scale=0.01, size=(2, L // dx)).astype(np.float32)
    return er, ei, a, b


def rotation_error_bound(er, ei, ph):
    """Per-sample bound on the error of a float32 rotation (er + j ei) exp(+-j ph).

    The phase is rounded to float32, which moves it by up to ulp32(|ph|) (a
    sum and a product, each half an ulp), and sin and cos of the rounded
    phase are each good to about one ulp, below 2^-23; rotating z by a
    phase wrong by delta moves it by |z| delta. So one float32
    implementation lies within |z| (ulp32(|ph|) + 2^-23) of the exact value,
    and two of them within twice that of each other.
    """
    ulp = np.spacing(np.abs(ph).astype(np.float32)).astype(np.float64)
    return 2 * np.abs(er + 1j * ei.astype(np.float64)) * (ulp + 2.0 ** -23)


class TestB4InterpRotate:
    # phases of up to ~60 rad, where one float32 ulp is 3.8e-6: a flat 1e-5
    # on |z| up to ~5 is below what float32 promises, so each sample is held
    # to rotation_error_bound (measured worst ratio to |z| ulp32(|ph|): 0.56
    # against the float64 formula, 1.04 against the Pallas kernel)
    @pytest.mark.parametrize("sign", [1, -1])
    def test_against_pallas_and_formula(self, sign):
        er, ei, a, b = _interp_inputs(10 + sign)
        ref_r, ref_i = (np.asarray(x) for x in interp_rotate_planes_pallas(
            er, ei, a, b, dx=16, sign=sign, T=2048))
        got_r, got_i = (x.numpy() for x in interp_rotate_plain(
            *(torch.as_tensor(x) for x in (er, ei, a, b)), 16, sign))
        i = np.arange(er.shape[-1])
        ph = a.astype(np.float64)[:, i // 16] + b.astype(np.float64)[:, i // 16] * (i % 16)
        bound = rotation_error_bound(er, ei, ph)
        z = (er + 1j * ei.astype(np.float64)) * np.exp(sign * 1j * ph)
        for want_r, want_i in ((ref_r, ref_i), (z.real, z.imag)):
            assert np.all(np.abs((got_r - want_r) + 1j * (got_i - want_i)) <= bound)

    def test_rejects_bad_sign_and_cover(self):
        er, ei, a, b = (torch.as_tensor(x) for x in _interp_inputs(3, L=64))
        with pytest.raises(ValueError):
            interp_rotate_plain(er, ei, a, b, 16, 2)
        with pytest.raises(ValueError):
            interp_rotate_plain(er, ei, a[:, :-1], b[:, :-1], 16, 1)

    @pytest.mark.parametrize("sign", [1, -1])
    def test_partial_last_block_equals_padded_then_sliced(self, sign):
        """Planes of Lout = Ld*dx - 9 samples with Ld coefficients: the derotation of the
        planes zero-padded to Ld*dx samples, cut back to Lout, bit for bit."""
        er, ei, a, b = (torch.as_tensor(x) for x in _interp_inputs(5, L=600 * 16))
        Lout = er.shape[-1] - 9
        got = interp_rotate_plain(er[:, :Lout].contiguous(), ei[:, :Lout].contiguous(), a, b,
                                  16, sign)
        pad = torch.nn.functional.pad
        want = interp_rotate_plain(pad(er[:, :Lout], (0, 9)), pad(ei[:, :Lout], (0, 9)), a, b,
                                   16, sign)
        assert got[0].shape == got[1].shape == (2, Lout)
        assert torch.equal(got[0], want[0][:, :Lout]) and torch.equal(got[1], want[1][:, :Lout])

    @pytest.mark.parametrize("cut", [1, 9, 15])
    def test_partial_cover_refuses_a_block_short_or_over(self, cut):
        """ceil(L/dx) coefficients and no other count: a block short, or one over, is refused."""
        er, ei, a, b = (torch.as_tensor(x) for x in _interp_inputs(4, L=64))
        er, ei = er[:, :64 - cut].contiguous(), ei[:, :64 - cut].contiguous()
        interp_rotate_plain(er, ei, a, b, 16, 1)
        with pytest.raises(ValueError, match="cover"):
            interp_rotate_plain(er, ei, a[:, :-1], b[:, :-1], 16, 1)
        over = torch.cat([a, a[:, -1:]], dim=-1)
        with pytest.raises(ValueError, match="cover"):
            interp_rotate_plain(er, ei, over, over, 16, 1)


class TestDecimatedGlue:
    def test_against_numpy_statement(self):
        """chain.py:349-369 written out in numpy float32."""
        rng = np.random.default_rng(11)
        Ld, dec, Lout = 600, 16, 600 * 16 - 9
        # slowly drifting indices that wrap across the pi/2 range many times
        idx = (np.cumsum(rng.integers(-3, 4, size=(2, Ld)), axis=-1) % 64).astype(np.int32)
        eq = rng.standard_normal((4, Lout)).astype(np.float32)
        step, lo = float(np.pi / 2 / 64), float(-np.pi / 4)
        phd = (np.float32(lo) + np.float32(step) * idx.astype(np.float32)).astype(np.float32)
        hp = np.float32(np.pi / 2)
        corr = -hp * np.floor((phd[:, 1:] - phd[:, :-1]) / hp + np.float32(0.5))
        phu = phd + np.cumsum(np.pad(corr, ((0, 0), (1, 0))), axis=-1, dtype=np.float32)
        b = np.pad(phu[:, 1:] - phu[:, :-1], ((0, 0), (0, 1))) / np.float32(dec)
        er_p, ei_p, a_t, b_t = decimated_derotation_inputs(
            torch.as_tensor(eq[:2]), torch.as_tensor(eq[2:]), torch.as_tensor(idx), lo, step, dec)
        # the planes come back as they were given, with no zero tail: B4 takes the partial
        # last block
        assert er_p.shape == ei_p.shape == (2, Lout)
        assert np.array_equal(er_p.numpy(), eq[:2]) and np.array_equal(ei_p.numpy(), eq[2:])
        # cumulated sums of multiples of pi/2 in two summation orders
        assert np.abs(a_t.numpy() - phu).max() <= 1e-5 * max(1.0, np.abs(phu).max())
        assert np.abs(b_t.numpy() - b).max() <= 1e-6
        assert np.all(b_t.numpy()[:, -1] == 0)
        # the unwrap leaves no jump of pi/4 or more between decimated samples
        assert np.abs(np.diff(a_t.numpy(), axis=-1)).max() <= np.pi / 4 + 1e-6

    # the twin of B10 (phase_cuda.unwrap_slopes_plain): the glue's float32 counts, scanned
    # in int32

    @staticmethod
    def _torch_counts(idx, lo, step):
        """The glue's jump counts floor(d / (pi/2) + 0.5), each torch operation on its own."""
        phd = lo + step * idx.to(torch.float32)
        hp = float(np.float32(np.pi / 2))
        return phd, torch.floor((phd[:, 1:] - phd[:, :-1]) / hp + 0.5)

    def _check_twin(self, idx, dec=16):
        step, lo = float(np.pi / 2 / 64), float(-np.pi / 4)
        a, b = unwrap_slopes_plain(idx, lo, step, dec)
        phd, m = self._torch_counts(idx, lo, step)
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape == idx.shape
        # M, read back from a = phd - (pi/2) M, is the exact prefix sum of those counts
        hp = np.float32(np.pi / 2)
        M = np.rint((phd.numpy().astype(np.float64) - a.numpy()) / hp).astype(np.int64)
        want_M = np.concatenate([np.zeros((idx.shape[0], 1), np.int64),
                                 np.cumsum(m.numpy().astype(np.int64), axis=-1)], axis=-1)
        assert np.array_equal(M, want_M)
        assert np.array_equal(a.numpy(), phd.numpy() - hp * want_M.astype(np.float32))
        want_b = np.pad(a.numpy()[:, 1:] - a.numpy()[:, :-1], ((0, 0), (0, 1))) / np.float32(dec)
        assert np.array_equal(b.numpy(), want_b)
        return M

    def test_twin_on_long_rows_that_wrap_hundreds_of_times(self):
        rng = np.random.default_rng(21)
        L = 2 ** 18
        idx = (np.cumsum(rng.integers(-3, 4, size=(2, L)), axis=-1) % 64).astype(np.int32)
        M = self._check_twin(torch.as_tensor(idx))
        assert np.abs(np.diff(M, axis=-1)).sum(axis=-1).min() >= 300

    @pytest.mark.parametrize("Ld", [1, 2])
    def test_twin_on_rows_of_one_and_two(self, Ld):
        idx = torch.tensor([[5, 60], [63, 0]], dtype=torch.int32)[:, :Ld]
        self._check_twin(idx)
        a, b = unwrap_slopes_plain(idx, float(-np.pi / 4), float(np.pi / 128), 16)
        assert not bool(b[:, -1].any())
        if Ld == 1:
            assert torch.equal(a, -np.pi / 4 + np.pi / 128 * idx.to(torch.float32))

    @pytest.mark.parametrize("jump", [32, -32])
    def test_twin_on_jumps_of_exactly_a_half_turn(self, jump):
        """Index jumps of +-32 put d/(pi/2) on the tie 0.5: the counts are the torch
        expressions', however the tie rounds at each starting index."""
        start = np.arange(64, dtype=np.int32) if jump > 0 else np.arange(32, 96) % 64
        rows = np.stack([(start + jump * (np.arange(8) % 2)[:, None]).T.reshape(-1) % 64
                         for _ in range(2)]).astype(np.int32)
        rows[1] = rows[1][::-1]
        idx = torch.as_tensor(rows)
        self._check_twin(idx)
        phd, m = self._torch_counts(idx, float(-np.pi / 4), float(np.pi / 128))
        assert bool((m != 0).any())        # some of the ties count a turn

    @pytest.mark.parametrize("rows, L, tiles", [(1, 1, 1), (2, 2047, 1), (2, 2048, 1),
                                                (2, 2049, 2), (2, 2 ** 16, 32),
                                                (2, 2 ** 18, 128)])
    def test_b10_plan(self, rows, L, tiles):
        """B10's tiles of 2048 decimated samples from the row's first: one ticket per row and
        one status word per tile, B7's scratch layout."""
        p = tpc.slopes_plan(rows, L)
        assert p == (tpc.SLOPE_TILE, tiles, rows * tiles, rows + rows * tiles)
        assert p.tile == tpc.SLOPE_ITEMS * tpc.SLOPE_THREADS == 2048
        assert (p.tiles - 1) * p.tile < L <= p.tiles * p.tile

    def test_b10_divides_by_pi_over_2_as_the_card_does(self):
        """PyTorch on the card divides by a host scalar as a product with its float32
        reciprocal; B10 takes INV_HALF_PI for it: the two constants are one float32."""
        hp = np.float32(tpc.HALF_PI)
        assert np.float32(1) / hp == np.float32(tpc.INV_HALF_PI)
        assert (np.float32(1) / hp).view(np.int32) == np.float32(2 / np.pi).view(np.int32)

    def test_b10_refuses_the_cpu_and_bad_shapes(self):
        idx = torch.zeros(2, 8, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            tpc.unwrap_slopes_cuda(idx, 0.0, 0.1, 16)
        with pytest.raises(ValueError, match="rows, Ld"):
            unwrap_slopes_plain(idx[0], 0.0, 0.1, 16)
        with pytest.raises(ValueError, match="stride"):
            unwrap_slopes_plain(idx, 0.0, 0.1, 0)
