"""The port's host-side helpers, workload, converters and refusals.

The numpy helpers must give the JAX package's exact output; the workload
must synthesise the same capture as ``bench.make_tx``.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from qampy_tpu import theory as jth
from qampy_tpu import utils as jut
from qampy_tpu.ops import equaliser as jeq
from qampy_tpu.ops import phase as jph
from qampy_tpu.ops.equaliser_pallas import pallas_filter_group
from qampy_tpu_torch import convert, workload
from qampy_tpu_torch import theory as tth
from qampy_tpu_torch import utils as tut
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter, apply_filter_cuda, filter_group,
                                                train_block_cuda)
from qampy_tpu_torch.ops.phase_cuda import bps_search_cuda, interp_rotate_cuda

ORDERS = [4, 8, 16, 32, 64, 128, 256]


class TestTheory:
    @pytest.mark.parametrize("M", ORDERS)
    def test_constellation_and_gray_code(self, M):
        np.testing.assert_array_equal(tth.cal_symbols_qam(M), jth.cal_symbols_qam(M))
        assert tth.cal_scaling_factor_qam(M) == jth.cal_scaling_factor_qam(M)
        np.testing.assert_array_equal(tth.gray_code_qam(M), jth.gray_code_qam(M))

    @pytest.mark.parametrize("M", [16, 64, 256])
    def test_square(self, M):
        np.testing.assert_array_equal(tth.cal_symbols_square_qam(M),
                                      jth.cal_symbols_square_qam(M))

    @pytest.mark.parametrize("M", [8, 32, 128, 512])
    def test_cross(self, M):
        np.testing.assert_array_equal(tth.cal_symbols_cross_qam(M),
                                      jth.cal_symbols_cross_qam(M))

    def test_bin2gray(self):
        v = np.arange(1024)
        np.testing.assert_array_equal(tut.bin2gray(v), jut.bin2gray(v))


def _alphabets():
    out = {M: tth.cal_symbols_qam(M) / np.sqrt(tth.cal_scaling_factor_qam(M))
           for M in (8, 16, 32, 64, 128, 256)}
    out["apsk"] = np.exp(2j * np.pi * np.arange(16) / 16) * np.repeat([0.5, 1.0], 8)
    out["tiny"] = np.array([1 + 1j, -1 - 1j])
    return out


class TestGrid:
    @pytest.mark.parametrize("key", [8, 16, 32, 64, 128, 256, "apsk", "tiny"])
    def test_detect_grid(self, key):
        s = _alphabets()[key]
        assert tph.detect_grid(s) == jph.detect_grid(s)
        assert tph.detect_square_grid(s) == jph.detect_square_grid(s)
        g = tph.detect_grid(s)
        assert tph.grid_decision_info(g) == jph.grid_decision_info(g)

    def test_kinds(self):
        al = _alphabets()
        kinds = {k: tph.grid_decision_info(tph.detect_grid(al[k]))[0]
                 for k in (16, 64, 256, 32, 128, 8, "apsk")}
        assert kinds == {16: "sq", 64: "sq", 256: "sq", 32: "x", 128: "x", 8: "r",
                         "apsk": "gen"}

    @pytest.mark.parametrize("key", [32, 128, "apsk"])
    def test_non_square_grids_refused(self, key):
        with pytest.raises(NotImplementedError, match="A4"):
            tph.square_grid(tph.detect_grid(_alphabets()[key]), "test")

    def test_bps_tables(self):
        g = tph.detect_grid(_alphabets()[64])
        ang = np.linspace(-np.pi / 4, np.pi / 4, 64, endpoint=False, dtype=np.float32)
        c, s = tph.bps_tables(ang, g)
        # the reference folds 1/d0 into its rotation table (phase_pallas.py:255-259)
        np.testing.assert_array_equal(c, (np.cos(ang.astype(np.float64)) / g[0]).astype(np.float32))
        np.testing.assert_array_equal(s, (np.sin(ang.astype(np.float64)) / g[0]).astype(np.float32))


class TestEqualiserHost:
    @pytest.mark.parametrize("M", [16, 64, 256])
    def test_radius_constants(self, M):
        assert teq._cal_Rconstant(M) == jeq._cal_Rconstant(M)
        assert teq._cal_Rconstant_complex(M) == jeq._cal_Rconstant_complex(M)
        np.testing.assert_array_equal(teq.generate_partition_codes_radius(M),
                                      jeq.generate_partition_codes_radius(M))

    @pytest.mark.parametrize("method", ["cma", "sgncma", "mcma", "rde", "sbd", "mddma", "dd"])
    @pytest.mark.parametrize("M", [16, 64])
    def test_generate_symbols_for_eq(self, method, M):
        got = teq.generate_symbols_for_eq(method, M, np.complex64)
        ref = jeq.generate_symbols_for_eq(method, M, np.complex64)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("method", ["mcma", "mddma", "rde"])
    @pytest.mark.parametrize("nmodes", [1, 2])
    def test_reshape_symbols(self, method, nmodes):
        np.testing.assert_array_equal(
            teq._reshape_symbols(None, method, 64, np.complex64, nmodes),
            jeq._reshape_symbols(None, method, 64, np.complex64, nmodes))

    def test_reshape_symbols_refuses_mode_mismatch(self):
        with pytest.raises(ValueError):
            teq._reshape_symbols(np.ones((3, 4)), "mddma", 64, np.complex64, 2)

    @pytest.mark.parametrize("args", [(17, 2, 2), (11, 1, 1), (21, 1, 2)])
    def test_init_taps_and_orthogonalize(self, args):
        w = teq._init_taps(*args, np.complex64)
        np.testing.assert_array_equal(w, jeq._init_taps(*args, np.complex64))
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 17)) + 1j * rng.standard_normal((3, 17))
        np.testing.assert_array_equal(teq.orthogonalizetaps(x), jeq.orthogonalizetaps(x))

    def test_err_spec(self):
        s1 = teq._reshape_symbols(None, "mcma", 64, np.complex64, 2)
        spec = teq.err_spec("mcma", s1)
        r = complex(s1[0, 0])
        assert spec.consts == ((r.real, r.imag), (r.real, r.imag))
        s2 = teq._reshape_symbols(None, "mddma", 64, np.complex64, 2)
        assert teq.err_spec("mddma", s2).consts == jph.detect_grid(s2[0])

    @pytest.mark.parametrize("method", ["cma", "rde", "sbd", "dd", "sca", "cma_real"])
    def test_unported_methods_raise(self, method):
        with pytest.raises(NotImplementedError, match="A7"):
            teq.err_spec(method, np.ones((2, 4), np.complex64))

    @pytest.mark.parametrize("os_, ntaps, nout", [(2, 17, 2), (2, 17, 1), (2, 11, 2), (4, 33, 2),
                                                  (3, 17, 2), (1, 9, 4)])
    def test_filter_group(self, os_, ntaps, nout):
        assert filter_group(os_, ntaps, nout) == pallas_filter_group(os_, ntaps, nout)


class TestWorkload:
    def test_make_tx_identical_to_bench(self):
        got = workload.make_tx(2 ** 12, seed=1)
        ref = bench.make_tx(2 ** 12, seed=1)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)

    def test_ser_gate_counts_errors(self):
        """The gate against a numpy statement of bench.py:127-154."""
        rng = np.random.default_rng(4)
        const = tth.cal_symbols_qam(64) / np.sqrt(tth.cal_scaling_factor_qam(64))
        Nsym = 3000
        ref = const[rng.integers(0, 64, size=(2, Nsym))].astype(np.complex64)
        # output: mode 0 carries ref mode 1 at delay 4 rotated by j, mode 1
        # carries ref mode 0 at delay 3; 7 and 0 symbols corrupted
        L = Nsym - 8
        out = np.stack([ref[1, 4:4 + L] * 1j, ref[0, 3:3 + L]]).astype(np.complex64)
        bad = rng.choice(np.arange(300, L - 300), size=7, replace=False)
        out[0, bad] -= 0.5 * np.sign(out[0, bad].real)   # inward: never clamped
        out += 0.01 * (rng.standard_normal(out.shape) + 1j * rng.standard_normal(out.shape))
        got = workload.ser_gate(torch.as_tensor(out), torch.as_tensor(ref), const)
        assert got == pytest.approx((7 / (L - 400) + 0) / 2)

    def test_chain_trim_holds_the_decimated_edge(self):
        # dec*N edge samples carry no full window and so no phase estimate:
        # the bench's N=12 keeps them inside the gate's trim, its default 14 not
        for N, inside in ((12, True), (14, False)):
            ch = make_rx_chain(bps_N=N, bps_mode="decimated16")
            assert (ch.dec * ch.bps_N <= workload.GATE_TRIM) == inside


class TestConvert:
    def test_taps_from_jax(self):
        w = jeq._init_taps(17, 2, 2, np.complex64) * (1 + 2j)
        t = convert.taps_from_jax(w, "cpu")
        assert t.dtype == torch.complex64 and t.shape == (2, 2, 17)
        np.testing.assert_array_equal(t.numpy(), w)
        with pytest.raises(ValueError):
            convert.taps_from_jax(w.real, "cpu")

    def test_planes_from_complex(self):
        E = np.arange(12).reshape(2, 6) + 1j * np.arange(12, 24).reshape(2, 6)
        P = convert.planes_from_complex(E, "cpu")
        assert P.dtype == torch.float32 and P.shape == (4, 6)
        np.testing.assert_array_equal(P.numpy(), np.concatenate([E.real, E.imag]))


class TestPortBoundaries:
    def test_import_leaves_jax_out(self):
        code = ("import sys, qampy_tpu_torch, qampy_tpu_torch.ops.chain, "
                "qampy_tpu_torch.workload, qampy_tpu_torch.convert; "
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'qampy_tpu', 'triton')]; print(bad); "
                "sys.exit(1 if bad else 0)")
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr

    @pytest.mark.parametrize("which", ["B1", "B2", "B3", "B4"])
    def test_cuda_wrappers_refuse_cpu_tensors(self, which):
        P = torch.zeros(4, 4096)
        w = torch.zeros(2, 2, 17, dtype=torch.complex64)
        g = tph.detect_grid(_alphabets()[64])
        t = torch.zeros(64)
        calls = {
            "B1": lambda: train_block_cuda(P, 1024, 1, 2, 1e-3, w,
                                           teq.ErrSpec("mcma", ((1.0, 1.0),) * 2), True, 256),
            "B2": lambda: apply_filter_cuda(P, 2, w, 16),
            "B3": lambda: bps_search_cuda(P[:2], P[2:], t, t, g, 12),
            "B4": lambda: interp_rotate_cuda(P[:2], P[2:], P[:2, :256], P[2:, :256], 16, 1),
        }
        with pytest.raises(ValueError, match="CUDA"):
            calls[which]()

    @pytest.mark.parametrize("kwargs, item", [
        (dict(bps_mode="single"), "A4"), (dict(bps_mode="twostage"), "A4"),
        (dict(bps_mode="twostage-dec"), "A4"), (dict(bps_mode="decimated64"), "A4"),
        (dict(methods=("cma", "rde")), "A7"), (dict(methods=("mcma", "sbd")), "A7"),
        (dict(M=32), "A4"), (dict(M=128), "A4"), (dict(symbols=np.ones(16)), "A4")])
    def test_unported_configurations_raise(self, kwargs, item):
        with pytest.raises(NotImplementedError, match=item):
            make_rx_chain(**kwargs)

    def test_chain_is_a_module(self):
        ch = make_rx_chain(TrSyms=256)
        assert ch.eval() is ch and not ch.training
        assert {n for n, _ in ch.named_buffers()} == {"w0", "bps_cos", "bps_sin"}
        with pytest.raises(ValueError, match="positive"):
            make_rx_chain(bps_mode="decimated0")

    def test_filter_side_stride_must_divide_group(self):
        P = torch.zeros(4, 1024)
        w = torch.zeros(2, 2, 17, dtype=torch.complex64)
        with pytest.raises(ValueError, match="phase group"):
            apply_filter(P, 2, w, 64)

    def test_chain_refuses_complex_planes(self):
        ch = make_rx_chain(TrSyms=256)
        with pytest.raises(ValueError, match="planes"):
            ch.planes(torch.zeros(4, 2048, dtype=torch.complex64))
