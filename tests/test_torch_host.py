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
import jax.numpy as jnp
from qampy_tpu import signals as jsig
from qampy_tpu import theory as jth
from qampy_tpu import utils as jut
from qampy_tpu.core import impairments as jimp
from qampy_tpu.core import metrics as jmet
from qampy_tpu.ops import equaliser as jeq
from qampy_tpu.ops import phase as jph
from qampy_tpu.ops import phase_pallas as jpp
from qampy_tpu.ops.equaliser_pallas import pallas_filter_group
from qampy_tpu_torch import convert, signals, workload
from qampy_tpu_torch import theory as tth
from qampy_tpu_torch import utils as tut
from qampy_tpu_torch.core import impairments as timp
from qampy_tpu_torch.core.metrics import decision_idx
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter, apply_filter_cuda,
                                                apply_filter_frames_cuda, filter_group,
                                                method_code, train_block_cuda)
from qampy_tpu_torch.ops.phase_cuda import (bps_fine_cuda, bps_search_cuda, cpe_coeffs_cuda,
                                            interp_rotate_cuda, rotate_cuda,
                                            unwrap_derotate_cuda)

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
        """The searches take every grid the reference searches and refuse only what it refuses."""
        sc = tph.grid_consts(tph.detect_grid(_alphabets()[key]), "test")
        assert sc.kind == {32: "x", 128: "x", "apsk": "gen"}[key]
        assert sc.scale == jpp._make_dist_fn(jph.detect_grid(_alphabets()[key]))[1]
        assert (sc.points is None) == (key != "apsk")
        with pytest.raises(ValueError, match="classifies"):
            tph.grid_consts(None, "test")
        big = np.exp(2j * np.pi * np.arange(257) / 257) * (1 + np.arange(257) / 257)
        with pytest.raises(ValueError, match="at most 256"):
            tph.grid_consts(tph.detect_grid(big), "test")

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

    @pytest.mark.parametrize("method", ["cma2", "mrde", "sbd_data", "cme", "sca", "cma_real"])
    def test_unported_methods_raise(self, method):
        # kernel B1 and its plain form take the methods of the reference's fused
        # block trainer; the others train through the general error functions
        with pytest.raises(NotImplementedError, match="takes"):
            method_code(method)
        with pytest.raises(NotImplementedError, match="takes"):
            teq.err_spec(method, np.ones((2, 4), np.complex64))
        for m in teq.BLOCK_METHODS:
            assert method_code(m) == method_code("cma" if m == "sgncma" else m)

    def test_cma_error_against_reference(self):
        """The plain trainer's cma stage against the reference's XLA block trainer."""
        rng = np.random.default_rng(8)
        E = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))).astype(
            np.complex64) / np.sqrt(2)
        w0 = jeq._init_taps(17, 2, 2, np.complex64)
        s = jeq._reshape_symbols(None, "cma", 4, np.complex64, 2)
        err, w, mu = (np.asarray(x) for x in jeq.train_equaliser_block(
            E, 1003, 10, 2, 5e-3, w0, s, "cma", adaptive=True, block_size=256))
        e_t, w_t, mu_t = teq.train_equaliser_block(torch.as_tensor(E), 1003, 10, 2, 5e-3,
                                                   torch.as_tensor(w0), s, "cma",
                                                   adaptive=True, block_size=256)
        assert e_t.shape == err.shape == (2, 7680)
        assert np.abs(w_t.numpy() - w).max() <= 1e-4
        np.testing.assert_allclose(mu_t.numpy(), mu, rtol=1e-5)

    def test_batched_trainer_equals_one_by_one(self):
        rng = np.random.default_rng(9)
        P = torch.as_tensor(rng.standard_normal((3, 4, 2048)).astype(np.float32))
        w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64))
        spec = teq.err_spec("cma", teq._reshape_symbols(None, "cma", 4, np.complex64, 2))
        err, w, mu = teq.train_block_planes(P, 1003, 2, 2, 5e-3, w0, spec, True, 256)
        assert err.shape == (3, 2, 1536) and w.shape == (3, 2, 2, 17) and mu.shape == (3, 2)
        for b in range(3):
            e1, w1, m1 = teq.train_block_planes(P[b], 1003, 2, 2, 5e-3, w0, spec, True, 256)
            assert np.abs((w[b] - w1).numpy()).max() <= 1e-6
            assert np.abs((err[b] - e1).numpy()).max() <= 1e-6
            np.testing.assert_allclose(mu[b].numpy(), m1.numpy(), rtol=1e-6)

    @pytest.mark.parametrize("args", [(2, 17, 2048), (2, 45, 2092), (2, 17, 1040), (4, 11, 999)])
    def test_training_symbol_len(self, args):
        assert teq._cal_training_symbol_len(*args) == jeq._cal_training_symbol_len(*args)

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

    def test_shared_decisions_undo_a_quarter_turn_per_mode(self):
        rng = np.random.default_rng(15)
        const = tth.cal_symbols_qam(64) / np.sqrt(tth.cal_scaling_factor_qam(64))
        a = torch.as_tensor(const[rng.integers(0, 64, size=(2, 1000))].astype(np.complex64))
        b = a.clone()
        b[1] *= 1j
        assert workload.shared_decisions(a, b, const) == 1.0
        b[0, :100] = 0.0
        assert workload.shared_decisions(a, b, const) == pytest.approx(1 - 0.1 / 2, abs=0.01)

    def test_chain_trim_holds_the_decimated_edge(self):
        # dec*N edge samples carry no full window and so no phase estimate:
        # the bench's N=12 keeps them inside the gate's trim, its default 14 not
        for N, inside in ((12, True), (14, False)):
            ch = make_rx_chain(bps_N=N, bps_mode="decimated16", device="cpu")
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
                "qampy_tpu_torch.ops.pilot_chain, qampy_tpu_torch.signals, "
                "qampy_tpu_torch.core.impairments, qampy_tpu_torch.core.metrics, "
                "qampy_tpu_torch.workload, qampy_tpu_torch.convert; "
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'qampy_tpu', 'triton')]; print(bad); "
                "sys.exit(1 if bad else 0)")
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr

    @pytest.mark.parametrize("which", ["B1", "B2", "B3", "B4", "B2 frames", "B5", "B6", "B7",
                                       "B8"])
    def test_cuda_wrappers_refuse_cpu_tensors(self, which):
        P = torch.zeros(4, 4096)
        w = torch.zeros(2, 2, 17, dtype=torch.complex64)
        g = tph.detect_grid(_alphabets()[64])
        t = torch.zeros(64)
        pil = torch.zeros(2, 60)
        calls = {
            "B2 frames": lambda: apply_filter_frames_cuda(P, 2, w, torch.zeros(2, 3).long(), 512),
            "B5": lambda: cpe_coeffs_cuda(P, P, pil, pil, 64, 32, 3, 58, 32, 3, 128),
            "B6": lambda: rotate_cuda(P[:2], P[2:], P[:2]),
            "B1": lambda: train_block_cuda(P, 1024, 1, 2, 1e-3, w,
                                           teq.ErrSpec("mcma", ((1.0, 1.0),) * 2), True, 256),
            "B2": lambda: apply_filter_cuda(P, 2, w, 16),
            "B3": lambda: bps_search_cuda(P[:2], P[2:], t, t, g, 12),
            "B4": lambda: interp_rotate_cuda(P[:2], P[2:], P[:2, :256], P[2:, :256], 16, 1),
            "B7": lambda: unwrap_derotate_cuda(P[:2], P[2:], P[:2]),
            "B8": lambda: bps_fine_cuda(P[:2], P[2:], P[:2], t[:8], t[:8], g, 14, -0.05, 0.01),
        }
        with pytest.raises(ValueError, match="CUDA"):
            calls[which]()

    @pytest.mark.parametrize("kwargs, item", [
        (dict(bps_mode="twostage-dec"), "twostage-dec"),
        (dict(methods=("cma", "mrde")), "takes"), (dict(methods=("mcma", "cme")), "takes"),
        (dict(M=32), "x"), (dict(M=128), "x"), (dict(symbols=np.ones(16)), "gen"),
        (dict(symbols=np.exp(2j * np.pi * np.arange(300) / 300)), "at most 256"),
        (dict(symbols=np.ones(1)), "at least two points")])
    def test_unported_configurations_raise(self, kwargs, item):
        """What the port does not run raises; the constellations and modes of the reference build."""
        if item in ("x", "gen"):
            assert make_rx_chain(**kwargs, device="cpu").backend_info["grid_kind"] == item
            return
        if item == "twostage-dec":
            assert make_rx_chain(**kwargs, device="cpu").mode == item
            return
        err = NotImplementedError if item == "takes" else ValueError
        with pytest.raises(err, match=item):
            make_rx_chain(**kwargs, device="cpu")

    def test_chain_is_a_module(self):
        tables = {"w0", "bps_cos", "bps_sin"}
        for mode, buffers, A in (("single", tables, 64), ("decimated16", tables, 64),
                                 ("twostage", tables | {"fine_cos", "fine_sin"}, 16)):
            ch = make_rx_chain(TrSyms=256, bps_mode=mode, device="cpu")
            assert ch.eval() is ch and not ch.training
            assert {n for n, _ in ch.named_buffers()} == buffers
            assert ch.bps_cos.shape == (A,)
        with pytest.raises(ValueError, match="positive"):
            make_rx_chain(bps_mode="decimated0", device="cpu")
        with pytest.raises(ValueError, match="unknown bps_mode"):
            make_rx_chain(bps_mode="double", device="cpu")

    def test_filter_side_stride_must_divide_group(self):
        P = torch.zeros(4, 1024)
        w = torch.zeros(2, 2, 17, dtype=torch.complex64)
        with pytest.raises(ValueError, match="phase group"):
            apply_filter(P, 2, w, 64)

    def test_chain_refuses_complex_planes(self):
        ch = make_rx_chain(TrSyms=256, device="cpu")
        with pytest.raises(ValueError, match="planes"):
            ch.planes(torch.zeros(4, 2048, dtype=torch.complex64))


class TestPilotHost:
    @pytest.mark.parametrize("layout", [(2 ** 16, 1024, 32), (2 ** 14, 512, 32), (100, 10, 0),
                                        (96, 16, 8)])
    def test_cal_pilot_idx(self, layout):
        for got, ref in zip(signals.cal_pilot_idx(*layout),
                            jsig.SignalWithPilots._cal_pilot_idx(*layout)):
            np.testing.assert_array_equal(got, ref)
        with pytest.raises(ValueError):
            signals.cal_pilot_idx(100, 10, 7)

    @pytest.mark.parametrize("M", [4, 16, 32, 64, 128, 256])
    def test_generate_mapping(self, M):
        scale = np.sqrt(tth.cal_scaling_factor_qam(M))
        got = signals.generate_mapping(M, scale)
        ref = jsig.SignalQAMGrayCoded._generate_mapping(M, scale)
        for g_, r_ in zip(got, ref[:3]):
            assert g_.dtype == r_.dtype
            np.testing.assert_array_equal(g_, r_)

    def test_decision_idx(self):
        rng = np.random.default_rng(12)
        coded = signals.generate_mapping(64, np.sqrt(tth.cal_scaling_factor_qam(64)))[0]
        E = (coded[rng.integers(0, 64, (2, 3000))]
             + 0.1 * (rng.standard_normal((2, 3000)) + 1j * rng.standard_normal((2, 3000)))
             ).astype(np.complex64)
        ref = np.asarray(jmet.decision_idx(jnp.asarray(E), jnp.asarray(coded)))
        got = decision_idx(torch.as_tensor(E), torch.as_tensor(coded)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)

    def test_pmd_and_modal_delay_against_reference(self):
        rng = np.random.default_rng(13)
        E = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))).astype(
            np.complex64)
        ref = np.asarray(jimp.apply_PMD_to_field(E, np.pi / 4.3, 20e-12, 48e9))
        got = timp.apply_PMD_to_field(torch.as_tensor(E), np.pi / 4.3, 20e-12, 48e9).numpy()
        assert got.dtype == np.complex64
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        np.testing.assert_array_equal(
            timp.add_modal_delay(torch.as_tensor(E), [0, 333]).numpy(),
            np.asarray(jimp.add_modal_delay(E, [0, 333])))

    def test_noise_statistics(self):
        """Phase-noise steps and the SNR follow the reference's definitions (other draws)."""
        g = torch.Generator().manual_seed(1)
        L, fs, df = 2 ** 18, 48e9, 20e3
        ph = timp.phase_noise((2, L), df, fs, g)
        var = torch.diff(ph.double(), dim=-1).var().item()
        assert var == pytest.approx(2 * np.pi * df / fs, rel=0.02)
        sig = torch.ones(2, L, dtype=torch.complex64)
        noisy = timp.change_snr(sig, 20, 24e9, fs, g)
        # os-aware: the noise power is os * 10^(-snr/10) of the signal's
        assert torch.mean((noisy - sig).abs() ** 2).item() == pytest.approx(2 * 1e-2, rel=0.02)
        rolled = timp.roll_frame_sync(torch.arange(10)[None], 3)
        assert rolled[0, :4].tolist() == [7, 8, 9, 0]


class TestPilotWorkload:
    def test_make_pilot_tx_layout(self):
        tx = workload.make_pilot_tx(2, frame_len=2 ** 12, seq_len=256, ins_rat=32, seed=4, device="cpu")
        _, idx_dat, idx_pil = signals.cal_pilot_idx(2 ** 12, 256, 32)
        assert tx.planes.shape == (4, 2 * 2 * 2 ** 12) and tx.planes.dtype == torch.float32
        assert tx.pilot_seq.shape == (2, 256) and tx.ph_pilots.shape == (2, idx_pil.sum() - 256)
        assert tx.idx_tx.shape == (2, idx_dat.sum()) and int(tx.idx_tx.max()) < 64
        assert tx.bits.shape == (64, 6) and tx.coded.shape == (64,)
        # QPSK pilots of unit power; a capture of unit power per mode
        assert np.allclose(np.abs(tx.pilot_seq), 1, atol=1e-6)
        p = (tx.planes[:2] ** 2 + tx.planes[2:] ** 2).mean(-1)
        assert torch.allclose(p, torch.ones(2), rtol=0.05)
        again = workload.make_pilot_tx(2, frame_len=2 ** 12, seq_len=256, ins_rat=32, seed=4, device="cpu")
        assert torch.equal(again.planes, tx.planes)

    def test_ber_gate_counts_bits(self):
        rng = np.random.default_rng(14)
        coded, _, bits = signals.generate_mapping(64, np.sqrt(tth.cal_scaling_factor_qam(64)))
        idx = torch.as_tensor(rng.integers(0, 64, (2, 500)))
        tx = workload.PilotTx(None, None, None, idx, bits, coded)
        rx = idx.repeat(1, 3).clone()
        rx[0, 7] = idx[0, 7] ^ 5          # two bits wrong in frame 0 of mode 0
        rx[1, 1200] = idx[1, 200] ^ 32    # one bit wrong in frame 2 of mode 1
        z = torch.as_tensor(coded)[rx]
        res = workload.ber_gate(z.real, z.imag, tx, 130.0, chunk=700)
        assert res["ber"] == pytest.approx(3 / (2 * 1500 * 6))
        assert res["ser"] == pytest.approx(2 / 3000) and not res["ok"]
        assert workload.ber_gate(z.real[:, :500], z.imag[:, :500], tx, 119.0)["ok"] is False
        z0 = torch.as_tensor(coded)[idx]
        assert workload.ber_gate(z0.real, z0.imag, tx, 120.0)["ok"] is True

    def test_pilot_state_from_jax(self):
        w = jeq._init_taps(45, 2, 2, np.complex64) * (1 - 1j)
        t, sh, mo = convert.pilot_state_from_jax(w, np.array([3032, 3020], np.int32),
                                                 np.array([1, 0], np.int32), "cpu")
        assert t.dtype == torch.complex64 and sh.dtype == mo.dtype == torch.int64
        assert sh.tolist() == [3032, 3020] and mo.tolist() == [1, 0]
        with pytest.raises(ValueError):
            convert.pilot_state_from_jax(w, np.array([1.5, 2.0]), np.array([0, 1]), "cpu")
