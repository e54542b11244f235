"""The pilot chain's plain kernel versions (B5, B6, B2's frame entry) and ``unwrap`` against JAX.

Each plain PyTorch version is what its CUDA kernel is held against on the
card (tests/test_torch_cuda.py, chip_smoke.py); here it is held against the
reference's Pallas kernel in interpret mode on the CPU and against a numpy
statement of its formula, on inputs made with numpy from a seed.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qampy_tpu.ops.equaliser_pallas import apply_filter_pallas_planes
from qampy_tpu.ops.phase_pallas import cpe_coeffs_pallas, rotate_planes_pallas
from qampy_tpu_torch.ops.equaliser_cuda import apply_filter_frames_plain
from qampy_tpu_torch.ops.phase_cuda import cpe_coeffs_plain, rotate_plain
from qampy_tpu_torch.ops.pilot_chain import unwrap
from test_torch_kernels import rotation_error_bound

# (frame_len, seq_len, ins_rat): the bench's frame, the tests' short frame, and two frames of
# more than 4,096 CPE pilots: 2^15 symbols at ratio 4 (7,936) and 2^18 at ratio 32 (8,160)
GEOMETRIES = {"bench": (2 ** 16, 1024, 32), "test": (2 ** 14, 512, 32),
              "ratio4": (2 ** 15, 1024, 4), "long": (2 ** 18, 1024, 32)}


def _cpe_geometry(frame_len, seq_len, R, cpe_avg=3):
    """(npil, n_head, npts, nbt) as the reference chain derives them (pilot_chain.py:139-167)."""
    npil = (frame_len - seq_len) // R
    n_head = (seq_len + R * ((cpe_avg - 1) // 2)) // R
    return npil, n_head, npil - (cpe_avg - 1), frame_len // R


def _pilot_rows(seed, rows, frame_len, seq_len, R, nmodes=2):
    """Filtered-symbol rows whose pilots carry a random-walk phase that wraps past +-pi.

    Returns (symr, symi, pil_r, pil_i) as float32 numpy: rows ordered
    (mode, frame), pilot rows per mode.
    """
    rng = np.random.default_rng(seed)
    npil = (frame_len - seq_len) // R
    pil = np.exp(0.5j * np.pi * (rng.integers(0, 4, (nmodes, npil)) + 0.5))
    walk = np.cumsum(rng.normal(scale=0.15, size=(rows, npil)), axis=-1) + rng.uniform(
        -np.pi, np.pi, (rows, 1))
    z = pil.repeat(rows // nmodes, axis=0) * np.exp(1j * walk)
    z += 0.05 * (rng.standard_normal(z.shape) + 1j * rng.standard_normal(z.shape))
    sym = (rng.standard_normal((rows, frame_len))
           + 1j * rng.standard_normal((rows, frame_len))).astype(np.complex64)
    sym[:, seq_len::R] = z
    return (np.ascontiguousarray(sym.real), np.ascontiguousarray(sym.imag),
            pil.real.astype(np.float32), pil.imag.astype(np.float32))


class TestB5CpeCoeffs:
    # both sides round every operation of the same formula in float32; only
    # atan2 may differ by an ulp, which moves the unwrapped phases (a few
    # rad) by ~1e-6 and the slopes by ~1e-7
    @pytest.mark.parametrize("form", ["res_ph", "atan2"])
    @pytest.mark.parametrize("geometry, rows", [("bench", 2), ("bench", 8), ("test", 6),
                                                ("ratio4", 2), ("long", 2)])
    def test_against_pallas(self, geometry, rows, form):
        frame_len, seq_len, R = GEOMETRIES[geometry]
        npil, n_head, npts, nbt = _cpe_geometry(frame_len, seq_len, R)
        symr, symi, pil_r, pil_i = _pilot_rows(rows + len(geometry), rows, frame_len, seq_len, R)
        zr, zi = symr[:, seq_len::R], symi[:, seq_len::R]
        pr, pi = (np.repeat(p, rows // 2, axis=0) for p in (pil_r, pil_i))
        # the wrapped phases do cross +-pi in these rows
        raw = np.asarray(jnp.arctan2(pr * zi - pi * zr, pr * zr + pi * zi))
        assert np.abs(np.diff(raw, axis=-1)).max() > np.pi
        if form == "res_ph":
            ref = cpe_coeffs_pallas(None, None, None, None, n_head, npts, R, 3, nbt, res_ph=raw)
        else:
            ref = cpe_coeffs_pallas(zr, zi, pr, pi, n_head, npts, R, 3, nbt)
        ref_a, ref_b = (np.asarray(x) for x in ref)
        a, b = cpe_coeffs_plain(*(torch.as_tensor(x) for x in (symr, symi, pil_r, pil_i)),
                                seq_len, R, n_head, npts, R, 3, nbt)
        assert a.shape == b.shape == ref_a.shape == (rows, nbt) and npil == zr.shape[1]
        assert np.abs(a.numpy() - ref_a).max() <= 1e-5
        assert np.abs(b.numpy() - ref_b).max() <= 1e-6

    def test_against_numpy_formula(self):
        """The float64 statement: unwrap, 3-point average, head/tail clamp, per-block slopes."""
        frame_len, seq_len, R = GEOMETRIES["test"]
        npil, n_head, npts, nbt = _cpe_geometry(frame_len, seq_len, R)
        symr, symi, pil_r, pil_i = _pilot_rows(3, 4, frame_len, seq_len, R)
        a, b = cpe_coeffs_plain(*(torch.as_tensor(x) for x in (symr, symi, pil_r, pil_i)),
                                seq_len, R, n_head, npts, R, 3, nbt)
        z = (symr[:, seq_len::R] + 1j * symi[:, seq_len::R].astype(np.float64))
        pil = np.repeat(pil_r + 1j * pil_i.astype(np.float64), 2, axis=0)
        u = np.unwrap(np.angle(np.conj(pil) * z), axis=-1)
        pavg = (u[:, 2:] + u[:, 1:-1] + u[:, :-2]) / 3
        k = np.arange(nbt) - n_head
        inside = (k >= 0) & (k < npts - 1)
        j = np.clip(k, 0, npts - 2)
        ref_a = np.where(k < 0, pavg[:, :1], np.where(inside, pavg[:, j], pavg[:, -1:]))
        ref_b = np.where(inside, (pavg[:, j + 1] - pavg[:, j]) / R, 0.0)
        assert np.abs(a.numpy() - ref_a).max() <= 1e-5
        assert np.abs(b.numpy() - ref_b).max() <= 1e-6

    def test_exact_half_turn_rounds_up(self):
        """A step of exactly pi counts as a jump: floor(0.5 + 0.5) = 1 (phase_pallas.py:776)."""
        half = np.float32(np.pi)
        ph = np.array([[0.0, half, 0.0, 0.0, 0.0, 0.0]], np.float32)
        symr = np.zeros((2, 8), np.float32)
        symr[:, :6] = np.cos(ph)
        symi = np.zeros((2, 8), np.float32)
        symi[:, :6] = np.sin(ph)
        pil = torch.ones(2, 6), torch.zeros(2, 6)
        a, _ = cpe_coeffs_plain(torch.as_tensor(symr), torch.as_tensor(symi), *pil, 0, 1, 0, 4,
                                1, 3, 4)
        raw = np.arctan2(symi[:1, :6], symr[:1, :6])
        ref, _ = cpe_coeffs_pallas(None, None, None, None, 0, 4, 1, 3, 4, res_ph=raw)
        np.testing.assert_allclose(a.numpy()[:1], np.asarray(ref), atol=1e-6)

    def test_refuses_short_rows(self):
        symr, symi, pil_r, pil_i = (torch.as_tensor(x) for x in _pilot_rows(1, 2, 2048, 64, 32))
        with pytest.raises(ValueError, match="overrun"):
            cpe_coeffs_plain(symr, symi, pil_r, pil_i, 100, 32, 3, 58, 32, 3, 64)
        with pytest.raises(ValueError, match="fewer"):   # 62 pilots hold 60 3-point averages
            cpe_coeffs_plain(symr, symi, pil_r, pil_i, 64, 32, 3, 61, 32, 3, 64)


class TestB6Rotate:
    @pytest.mark.parametrize("sign", [1, -1])
    def test_against_pallas_and_formula(self, sign):
        rng = np.random.default_rng(20 + sign)
        er, ei = (rng.standard_normal((2, 6000)).astype(np.float32) for _ in range(2))
        # CPE traces wander over a few radians
        ph = (np.cumsum(rng.normal(scale=0.05, size=(2, 6000)), axis=-1) + 3).astype(np.float32)
        ref_r, ref_i = (np.asarray(x) for x in rotate_planes_pallas(er, ei, ph, sign=sign,
                                                                    T=2048))
        got_r, got_i = (x.numpy() for x in rotate_plain(
            *(torch.as_tensor(x) for x in (er, ei, ph)), sign))
        bound = rotation_error_bound(er, ei, ph.astype(np.float64))
        z = (er + 1j * ei.astype(np.float64)) * np.exp(sign * 1j * ph.astype(np.float64))
        for want_r, want_i in ((ref_r, ref_i), (z.real, z.imag)):
            assert np.all(np.abs((got_r - want_r) + 1j * (got_i - want_i)) <= bound)

    def test_refuses_mismatched_phase(self):
        x = torch.zeros(2, 64)
        with pytest.raises(ValueError, match="one shape"):
            rotate_plain(x, x, x[:, :32])
        with pytest.raises(ValueError, match="sign"):
            rotate_plain(x, x, x, 0)


class TestB2FrameEntry:
    # float32 sums of 68 products on both sides: ~1e-7 relative, so 1e-5 x rms
    def test_against_pallas_virtual_inputs(self):
        """Frame by frame against the reference's form (pilot_chain.py:698-715).

        The reference stacks the window of each output mode as nmodes^2
        virtual input planes and filters them with block-diagonal taps.
        """
        rng = np.random.default_rng(30)
        frame_len, ntaps, os_, n = 2048, 17, 2, 2
        fr_len = (frame_len - 1) * os_ + ntaps
        L = 4 * frame_len * os_ + 200
        P = rng.standard_normal((2 * n, L)).astype(np.float32)
        w = ((rng.standard_normal((n, n, ntaps)) + 1j * rng.standard_normal((n, n, ntaps)))
             / 8).astype(np.complex64)
        offs = np.array([[37, 37 + 4096, 37 + 8192], [21, 21 + 4096, 21 + 8192]])
        got = apply_filter_frames_plain(torch.as_tensor(P), os_, torch.as_tensor(w),
                                        torch.as_tensor(offs), frame_len).numpy()
        assert got.shape == (2, n, 3, frame_len)
        wv = np.zeros((n, n * n, ntaps), np.complex64)
        for i in range(n):
            wv[i, i * n:(i + 1) * n] = w[i]
        for f in range(3):
            sl = [P[:, offs[i, f]:offs[i, f] + fr_len] for i in range(n)]
            planes_v = np.concatenate([s[:n] for s in sl] + [s[n:] for s in sl])
            ref = np.asarray(apply_filter_pallas_planes(planes_v, os_, wv, mat_dtype=jnp.float32))
            rms = np.sqrt(np.mean(ref ** 2))
            assert np.abs(got[0, :, f] - ref[:n]).max() <= 1e-5 * rms
            assert np.abs(got[1, :, f] - ref[n:]).max() <= 1e-5 * rms


    @pytest.mark.parametrize("poff, pstride", [(1024, 32), (0, 1), (37, 5)])
    def test_pilot_side_output_is_the_pilot_columns(self, poff, pstride):
        """The side output is the main output's columns poff + p*pstride, bit for bit."""
        rng = np.random.default_rng(31)
        frame_len, ntaps, os_, n = 4096, 17, 2, 2
        P = torch.as_tensor(rng.standard_normal((2 * n, 5 * frame_len * os_)).astype(np.float32))
        w = torch.as_tensor(((rng.standard_normal((n, n, ntaps))
                              + 1j * rng.standard_normal((n, n, ntaps))) / 8).astype(np.complex64))
        offs = torch.tensor([[37, 37 + 8192, 37 + 16384], [21, 21 + 8192, 21 + 16384]])
        npil = (frame_len - 1 - poff) // pstride + 1
        out, side = apply_filter_frames_plain(P, os_, w, offs, frame_len, (poff, pstride, npil))
        assert torch.equal(out, apply_filter_frames_plain(P, os_, w, offs, frame_len))
        assert side.shape == (2, n, 3, npil) and side.is_contiguous()
        assert torch.equal(side, out[..., poff::pstride][..., :npil])


class TestUnwrap:
    def test_against_jnp_unwrap(self):
        rng = np.random.default_rng(40)
        p = np.angle(np.exp(1j * np.cumsum(rng.normal(scale=1.2, size=(3, 5000)), axis=-1)))
        p = p.astype(np.float32)
        ref = np.asarray(jnp.unwrap(jnp.asarray(p), axis=-1))
        got = unwrap(torch.as_tensor(p)).numpy()
        # corrections of ~2*pi cumulated in two summation orders
        assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
        assert np.abs(np.diff(got, axis=-1)).max() <= np.pi + 1e-5

    def test_exact_half_turns_tie_rule(self):
        """Steps of exactly +-pi are kept as they are, as jnp.unwrap does."""
        h = np.float32(np.pi)
        up = np.nextafter(h, np.float32(4))
        p = np.array([0, h, 2 * h, h, 0, -h, -2 * h, -h, 0, up, 0, -up, 0], np.float32)
        ref = np.asarray(jnp.unwrap(jnp.asarray(p)))
        got = unwrap(torch.as_tensor(p)).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got[:9], p[:9])          # no correction at +-pi
        assert got[9] != p[9] and got[11] != p[11]              # just past pi: corrected

    def test_other_axis(self):
        rng = np.random.default_rng(41)
        p = rng.uniform(-np.pi, np.pi, (50, 4)).astype(np.float32)
        ref = np.asarray(jnp.unwrap(jnp.asarray(p), axis=0))
        assert np.abs(unwrap(torch.as_tensor(p), dim=0).numpy() - ref).max() <= 1e-5
