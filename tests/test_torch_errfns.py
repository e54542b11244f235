"""The port's equaliser constants and error functions against the JAX package.

Host constants must be the reference's arrays; every error function is held
against the JAX one on 256 random points made with numpy from a seed.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qampy_tpu.ops import equaliser as jeq
from qampy_tpu_torch import convert
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam

GENERATED = ("cma", "cma2", "sgncma", "sca", "cme", "mcma", "rde", "mrde", "sbd", "mddma", "dd",
             "sgncma_real", "cma_real", "dd_real")
COMPLEX_METHODS = ("cma", "sgncma", "cma2", "mcma", "rde", "mrde", "sbd", "sbd_data", "mddma",
                   "dd", "sca", "cme")
REAL_METHODS = ("cma", "sgncma", "dd", "dd_data")
ERR_TOL = 1e-6          # float32 on both sides, the same formula op by op
NPTS = 256


def _const(M):
    return (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


class TestHostConstants:
    def test_method_registries(self):
        for name in ("DECISION_BASED", "NONDECISION_BASED", "REAL_VALUED", "DATA_AIDED",
                     "TRAINING_FCTS", "EXTENDED_METHODS"):
            assert getattr(teq, name) == getattr(jeq, name)

    @pytest.mark.parametrize("M", [4, 16, 64])
    @pytest.mark.parametrize("method", GENERATED)
    def test_generate_symbols_for_eq(self, method, M):
        dtype = np.float32 if method in teq.REAL_VALUED else np.complex64
        assert _same(teq.generate_symbols_for_eq(method, M, dtype),
                     jeq.generate_symbols_for_eq(method, M, dtype))

    @pytest.mark.parametrize("M", [4, 16, 64])
    def test_scalar_constants(self, M):
        syms = _const(M)
        assert teq._cal_Rsca(M) == jeq._cal_Rsca(M)
        assert teq._min_spacing(M) == jeq._min_spacing(M)
        assert _same(teq._cal_Rdash(syms), jeq._cal_Rdash(syms))
        assert _same(teq.generate_partition_codes_complex(M),
                     jeq.generate_partition_codes_complex(M))

    @pytest.mark.parametrize("M", [4, 16, 64])
    @pytest.mark.parametrize("method", ["cma", "cma2", "sgncma", "mcma", "rde", "mrde", "sbd",
                                        "mddma", "dd"])
    def test_symbols_from_alphabet(self, method, M):
        # a warped alphabet: the constants must come from its own moments
        const = _const(M) * (1 + 0.1 * np.abs(_const(M)))
        assert _same(teq.generate_symbols_for_eq_from_alphabet(method, const, np.complex64),
                     jeq.generate_symbols_for_eq_from_alphabet(method, const, np.complex64))

    def test_symbols_errors(self):
        with pytest.raises(ValueError, match="data-aided"):
            teq.generate_symbols_for_eq("sbd_data", 16, np.complex64)
        with pytest.raises(ValueError, match="unknown"):
            teq.generate_symbols_for_eq("nope", 16, np.complex64)
        with pytest.raises(ValueError, match="alphabet"):
            teq.generate_symbols_for_eq_from_alphabet("sca", _const(16), np.complex64)

    @pytest.mark.parametrize("M", [4, 16, 64])
    @pytest.mark.parametrize("method", GENERATED)
    def test_reshape_symbols_generated(self, method, M):
        real = method in teq.REAL_VALUED
        dtype, nmodes = (np.float32, 4) if real else (np.complex64, 2)
        assert _same(teq._reshape_symbols(None, method, M, dtype, nmodes),
                     jeq._reshape_symbols(None, method, M, dtype, nmodes))

    @pytest.mark.parametrize("method, symbols, nmodes", [
        ("sbd", _const(16), 2), ("sbd", np.tile(_const(16), (2, 1)), 2),
        ("sbd_data", np.tile(_const(16), (3, 4)), 3),
        ("sca", _const(16), 2), ("cme", _const(16), 2), ("cme", np.array([[1.2, 0.3, 0.25]]), 2),
        ("dd_real", _const(16), 4), ("dd_real", _const(16)[None], 4),
        ("dd_data_real", np.tile(_const(16), (2, 1)), 4),
        ("dd_real", np.vstack([_const(16).real, _const(16).imag]), 4),
        ("dd_data_real", np.vstack([_const(16).real] * 4), 4)])
    def test_reshape_symbols_given(self, method, symbols, nmodes):
        dtype = np.float32 if method in teq.REAL_VALUED else np.complex64
        assert _same(teq._reshape_symbols(symbols, method, 16, dtype, nmodes),
                     jeq._reshape_symbols(symbols, method, 16, dtype, nmodes))

    @pytest.mark.parametrize("method, symbols, nmodes", [
        ("sbd", np.tile(_const(16), (3, 1)), 2),
        ("dd_real", np.tile(_const(16), (3, 1)), 4),
        ("dd_real", np.tile(_const(16).real, (3, 1)), 4)])
    def test_reshape_symbols_refuses_shapes(self, method, symbols, nmodes):
        dtype = np.float32 if method in teq.REAL_VALUED else np.complex64
        with pytest.raises(ValueError, match="modes"):
            teq._reshape_symbols(symbols, method, 16, dtype, nmodes)

    def test_real_conversion_round_trip(self):
        rng = np.random.default_rng(0)
        E = (rng.standard_normal((2, 64)) + 1j * rng.standard_normal((2, 64))).astype(np.complex64)
        R = teq._convert_sig_to_real(torch.as_tensor(E))
        assert np.array_equal(R.numpy(), np.asarray(jeq._convert_sig_to_real(E)))
        assert np.array_equal(teq._convert_sig_to_cmplx(R, 4).numpy(), E)
        # convert.planes_from_complex is the same stacking, as float32 on a device
        assert torch.equal(convert.planes_from_complex(E, "cpu"), R)

    def test_symbols_from_jax(self):
        syms = jeq._reshape_symbols(None, "rde", 64, np.complex64, 2)
        t = convert.symbols_from_jax(syms, "cpu")
        assert t.dtype == torch.complex64 and np.array_equal(t.numpy(), syms)
        r = convert.symbols_from_jax(jeq._reshape_symbols(None, "dd_real", 16, np.float32, 4),
                                     "cpu")
        assert r.dtype == torch.float32 and r.shape == (4, 16)
        with pytest.raises(ValueError, match="rows"):
            convert.symbols_from_jax(np.ones(4), "cpu")


def _points(seed, M):
    """256 points scattered around the M-QAM constellation, and 256 training symbols."""
    rng = np.random.default_rng(seed)
    const = _const(M)
    tx = const[rng.integers(0, M, NPTS)]
    z = tx + 0.08 * (rng.standard_normal(NPTS) + 1j * rng.standard_normal(NPTS))
    return z.astype(np.complex64), tx


class TestErrorFunctions:
    @pytest.mark.parametrize("M", [16, 64])
    @pytest.mark.parametrize("method", COMPLEX_METHODS)
    def test_complex_error(self, method, M):
        z, tx = _points(M, M)
        syms = tx if method == "sbd_data" else \
            jeq._reshape_symbols(None, method, M, np.complex64, 1)[0]
        idx = np.arange(NPTS)
        ref = np.asarray(jeq._make_error_fn(method)(jnp.asarray(z), jnp.asarray(syms), idx))
        got = teq._make_error_fn(method)(torch.as_tensor(z), torch.as_tensor(syms),
                                         torch.as_tensor(idx)).numpy()
        assert got.shape == ref.shape and got.dtype == np.complex64
        assert np.max(np.abs(got - ref)) <= ERR_TOL

    @pytest.mark.parametrize("method", COMPLEX_METHODS)
    def test_complex_error_over_modes(self, method):
        """(nout, S) estimates beside (nout, k) rows: each mode against its own row."""
        (z0, tx0), (z1, tx1) = _points(7, 64), _points(8, 64)
        z = [z0, z1]
        if method == "sbd_data":
            rows = [tx0, tx1]
        else:
            row = jeq._reshape_symbols(None, method, 64, np.complex64, 1)[0]
            rows = [row, row * np.complex64(1.1)]
        idx = np.arange(NPTS)
        fn = teq._make_error_fn(method)
        both = fn(torch.as_tensor(np.stack(z)), torch.as_tensor(np.stack(rows)),
                  torch.as_tensor(idx))
        for m in range(2):
            one = fn(torch.as_tensor(z[m]), torch.as_tensor(rows[m]), torch.as_tensor(idx))
            assert torch.equal(both[m], one)

    @pytest.mark.parametrize("method", REAL_METHODS)
    def test_real_error(self, method):
        z, tx = _points(3, 16)
        x = z.real.copy()
        syms = tx.real.copy() if method == "dd_data" else \
            jeq._reshape_symbols(None, method + "_real", 16, np.float32, 2)[0]
        idx = np.arange(NPTS)
        ref = np.asarray(jeq._make_error_fn_real(method)(jnp.asarray(x), jnp.asarray(syms), idx))
        got = teq._make_error_fn_real(method)(torch.as_tensor(x), torch.as_tensor(syms),
                                              torch.as_tensor(idx)).numpy()
        assert got.dtype == np.float32
        assert np.max(np.abs(got - ref)) <= ERR_TOL

    def test_unknown_method_raises(self):
        with pytest.raises(ValueError, match="Unknown method"):
            teq._make_error_fn("nope")
        with pytest.raises(ValueError, match="Unknown method"):
            teq._make_error_fn_real("mcma")

    @pytest.mark.parametrize("method", ["cma", "sgncma", "mcma", "rde", "sbd", "mddma", "dd"])
    def test_errspec_form_is_the_same_function(self, method):
        """The host-constant form kernel B1 implements against the general error function."""
        z, _ = _points(5, 64)
        z = np.stack([z, z[::-1] * np.complex64(1.05)])
        syms = teq._reshape_symbols(None, method, 64, np.complex64, 2)
        zr, zi = torch.as_tensor(z.real.copy()), torch.as_tensor(z.imag.copy())
        er, ei = teq.block_errfn(teq.err_spec(method, syms), 2, torch.device("cpu"))(zr, zi)
        ref = teq._make_error_fn(method)(torch.as_tensor(z), torch.as_tensor(syms), None)
        # the analytic decision's levels come from a grid detected on points
        # rounded to 6 decimals, as the reference's do: a level d up to 7 steps
        # of 5e-7 off, which mddma's (d^2 - z^2) z turns into 2 d z times that
        tol = 3e-5 if method in ("sbd", "mddma", "dd") else ERR_TOL
        assert float((torch.complex(er, ei) - ref).abs().max()) <= tol

    def test_errspec_refuses_what_the_kernel_lacks(self):
        syms = teq._reshape_symbols(None, "mrde", 16, np.complex64, 2)
        with pytest.raises(NotImplementedError, match="takes"):
            teq.err_spec("mrde", syms)
        cross = teq._reshape_symbols(None, "sbd", 32, np.complex64, 2)
        assert teq.err_spec("sbd", cross).consts == tph.detect_grid(cross[0])
        assert teq.block_kernel_takes("sbd", cross, 2)
        big = np.tile(np.exp(2j * np.pi * np.arange(257) / 257) * (1 + np.arange(257) / 257), (2, 1))
        with pytest.raises(ValueError, match="at most 256"):
            teq.err_spec("sbd", big)
        assert not teq.block_kernel_takes("sbd", big, 2)
        assert not teq.block_kernel_takes("mrde", syms, 2)
        assert not teq.block_kernel_takes("cma", syms, 3)
        assert teq.block_kernel_takes("rde", syms, 2)
