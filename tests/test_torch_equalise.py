"""The port's granular equaliser against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX functions
(``train_equaliser_seq``/``_block``, the Pallas trainers in interpret mode,
``equalise_signal``, ``dual_mode_equalisation``, ``CDcomp``) and the port's.
On CPU tensors the kernel backends ("cuda", "cuda_block") run the plain
versions of kernels B9 and B1 under the kernels' own restrictions.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
from qampy_tpu.ops import equaliser as jeq
from qampy_tpu.ops.equaliser_pallas import (train_equaliser_block_pallas,
                                            train_equaliser_pallas)
from qampy_tpu_torch import convert
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.equaliser_cuda import (train_block_plain, train_seq, train_seq_cuda,
                                                train_seq_plain)
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu_torch.workload import GATE_TRIM, make_pilot_tx, ser_gate, shared_decisions

TAPS_TOL = 1e-4         # float32 on both sides, sums in other orders (the reference's own bound)
MU_TOL = 1e-6           # final step size, absolute, at mu = 1e-3
ERR_TRACE_TOL = 1e-4    # per-sample error of a recurrence that stays within TAPS_TOL
M = 16


def _mu(method):
    """The tests' step size; sca's error carries a factor 16 and needs a step that much smaller."""
    return 2e-3 / 16 if method == "sca" else 2e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(42)
    return (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))).astype(
        np.complex64)


@pytest.fixture(scope="module")
def capture():
    """A dual-pol 16-QAM capture at 2 samples per symbol with PMD, phase noise and AWGN."""
    E, syms, const = bench.make_tx(2 ** 12, M=M, seed=3)
    return E, syms, const


class TestSeqTrainer:
    @pytest.mark.parametrize("method", ["cma", "mcma", "rde"])
    @pytest.mark.parametrize("adaptive", [False, True])
    def test_matches_jax_seq_and_pallas(self, field, method, adaptive):
        w0 = jeq._init_taps(11, 2, 2, np.complex64)
        syms = jeq._reshape_symbols(None, method, M, np.complex64, 2)
        e_s, w_s, mu_s = jeq.train_equaliser_seq(field, 1000, 1, 2, 1e-3, w0, syms, method,
                                                 adaptive=adaptive)
        _, w_p, mu_p = train_equaliser_pallas(field, 1000, 1, 2, 1e-3, w0, syms, method,
                                              adaptive=adaptive, interpret=True)
        E = torch.as_tensor(field)
        port = [teq.train_equaliser_seq(E, 1000, 1, 2, 1e-3, w0, syms, method, adaptive),
                # kernel B9's plain version, through its dispatcher, on planes
                train_seq(convert.planes_from_complex(field, "cpu"), 1000, 1, 2, 1e-3,
                          convert.taps_from_jax(w0, "cpu"), syms, method, adaptive)]
        assert torch.equal(port[0][1], port[1][1]) and torch.equal(port[0][0], port[1][0])
        e_t, w_t, mu_t = port[0]
        assert e_t.shape == (2, 1000) and w_t.shape == (2, 2, 11) and mu_t.shape == (2,)
        for w_ref, mu_ref in ((w_s, mu_s), (w_p, mu_p)):
            assert np.max(np.abs(_np(w_t) - np.asarray(w_ref))) <= TAPS_TOL
            assert np.max(np.abs(_np(mu_t) - np.asarray(mu_ref))) <= MU_TOL
        # the reference's kernel returns zeros here; the port's contract is seq's trace
        assert np.max(np.abs(_np(e_t) - np.asarray(e_s))) <= ERR_TRACE_TOL

    def test_niter_carries_the_previous_error(self, field):
        w0 = jeq._init_taps(11, 2, 2, np.complex64)
        syms = jeq._reshape_symbols(None, "cma", 4, np.complex64, 2)
        e_s, w_s, mu_s = jeq.train_equaliser_seq(field, 500, 3, 2, 1e-3, w0, syms, "cma",
                                                 adaptive=True)
        _, w_p, _ = train_equaliser_pallas(field, 500, 3, 2, 1e-3, w0, syms, "cma",
                                           adaptive=True, interpret=True)
        e_t, w_t, mu_t = teq.train_equaliser_seq(torch.as_tensor(field), 500, 3, 2, 1e-3, w0,
                                                 syms, "cma", True)
        assert e_t.shape == (2, 1500)
        assert np.max(np.abs(_np(w_t) - np.asarray(w_s))) <= TAPS_TOL
        assert np.max(np.abs(_np(w_t) - np.asarray(w_p))) <= TAPS_TOL
        assert np.max(np.abs(_np(mu_t) - np.asarray(mu_s))) <= MU_TOL
        assert np.max(np.abs(_np(e_t) - np.asarray(e_s))) <= ERR_TRACE_TOL

    @pytest.mark.parametrize("method", ["cma2", "mrde", "sbd", "mddma", "dd", "sca", "cme",
                                        "sbd_data"])
    def test_every_complex_method(self, capture, method):
        E, tx, _ = capture
        w0 = jeq._init_taps(11, 2, 2, np.complex64)
        syms = tx[:, :600] if method == "sbd_data" else \
            jeq._reshape_symbols(None, method, M, np.complex64, 2)
        mu = _mu(method)
        ref = jeq.train_equaliser_seq(E, 600, 1, 2, mu, w0, syms, method, adaptive=True)
        got = teq.train_equaliser_seq(torch.as_tensor(E), 600, 1, 2, mu, w0, syms, method, True)
        assert np.max(np.abs(_np(got[1]) - np.asarray(ref[1]))) <= TAPS_TOL
        assert np.max(np.abs(_np(got[2]) - np.asarray(ref[2]))) <= MU_TOL
        assert np.max(np.abs(_np(got[0]) - np.asarray(ref[0]))) <= ERR_TRACE_TOL

    @pytest.mark.parametrize("method", ["cma", "sgncma", "dd", "dd_data"])
    def test_real_valued(self, capture, method):
        E, tx, _ = capture
        Er = np.concatenate([E.real, E.imag])
        w0 = jeq._init_taps(11, 4, 4, np.float32)
        syms = np.concatenate([tx.real, tx.imag])[:, :600].copy() if method == "dd_data" else \
            jeq._reshape_symbols(None, method + "_real", M, np.float32, 4)
        ref = jeq.train_equaliser_seq(Er, 600, 1, 2, 2e-3, w0, syms, method, adaptive=True,
                                      real_valued=True)
        got = teq.train_equaliser_seq(torch.as_tensor(Er), 600, 1, 2, 2e-3, w0, syms, method,
                                      True, real_valued=True)
        assert got[0].dtype == torch.float32 and got[1].shape == (4, 4, 11)
        assert np.max(np.abs(_np(got[1]) - np.asarray(ref[1]))) <= TAPS_TOL
        assert np.max(np.abs(_np(got[2]) - np.asarray(ref[2]))) <= MU_TOL

    def test_kernel_methods_only(self, field):
        P = convert.planes_from_complex(field, "cpu")
        w0 = convert.taps_from_jax(jeq._init_taps(11, 2, 2, np.complex64), "cpu")
        syms = jeq._reshape_symbols(None, "sbd", M, np.complex64, 2)
        with pytest.raises(NotImplementedError, match="takes"):
            train_seq_plain(P, 100, 1, 2, 1e-3, w0, syms, "sbd")
        with pytest.raises(ValueError, match="CUDA"):
            train_seq_cuda(P, 100, 1, 2, 1e-3, w0, syms[:, :1], "cma")
        with pytest.raises(ValueError, match="shorter"):
            train_seq_plain(P, 4096, 1, 2, 1e-3, w0, syms[:, :1], "cma")


def _block_symbols(method, tx, real):
    if method in ("sbd_data", "dd_data"):
        s = tx[:, :1024]
        return np.concatenate([s.real, s.imag]).copy() if real else s
    return jeq._reshape_symbols(None, method + "_real" if real else method, M,
                                np.float32 if real else np.complex64, 4 if real else 2)


class TestBlockTrainer:
    @pytest.mark.parametrize("method", ["cma", "sgncma", "cma2", "mcma", "rde", "mrde", "sbd",
                                        "sbd_data", "mddma", "dd", "sca", "cme"])
    def test_every_complex_method(self, capture, method):
        E, tx, _ = capture
        w0 = jeq._init_taps(11, 2, 2, np.complex64)
        syms = _block_symbols(method, tx, False)
        mu = _mu(method)
        ref = jeq.train_equaliser_block(E, 1024, 2, 2, mu, w0, syms, method, adaptive=True,
                                        block_size=128)
        got = teq.train_equaliser_block(torch.as_tensor(E), 1024, 2, 2, mu, w0, syms, method,
                                        adaptive=True, block_size=128)
        assert got[0].shape == (2, 2048)
        assert np.max(np.abs(_np(got[1]) - np.asarray(ref[1]))) <= TAPS_TOL
        assert np.max(np.abs(_np(got[2]) - np.asarray(ref[2]))) <= MU_TOL
        assert np.max(np.abs(_np(got[0]) - np.asarray(ref[0]))) <= ERR_TRACE_TOL

    @pytest.mark.parametrize("method", ["cma", "sgncma", "dd", "dd_data"])
    def test_real_valued(self, capture, method):
        E, tx, _ = capture
        Er = np.concatenate([E.real, E.imag])
        w0 = jeq._init_taps(11, 4, 4, np.float32)
        syms = _block_symbols(method, tx, True)
        ref = jeq.train_equaliser_block(Er, 1024, 2, 2, 2e-3, w0, syms, method, adaptive=True,
                                        real_valued=True, block_size=128)
        got = teq.train_equaliser_block(torch.as_tensor(Er), 1024, 2, 2, 2e-3, w0, syms, method,
                                        adaptive=True, real_valued=True, block_size=128)
        assert got[0].dtype == torch.float32 and got[0].shape == (4, 2048)
        assert np.max(np.abs(_np(got[1]) - np.asarray(ref[1]))) <= TAPS_TOL
        assert np.max(np.abs(_np(got[2]) - np.asarray(ref[2]))) <= MU_TOL

    @pytest.mark.parametrize("method", ["cma", "sgncma", "rde", "sbd", "dd"])
    def test_kernel_form_matches_pallas_block(self, capture, method):
        """Kernel B1's plain version for its new methods against the reference's fused trainer."""
        E, _, _ = capture
        w0 = jeq._init_taps(11, 2, 2, np.complex64)
        syms = jeq._reshape_symbols(None, method, M, np.complex64, 2)
        ref = train_equaliser_block_pallas(jnp.asarray(E), 1024, 2, 2, 2e-3, w0, syms, method,
                                           adaptive=True, block_size=128, interpret=True)
        got = train_block_plain(convert.planes_from_complex(E, "cpu"), 1024, 2, 2, 2e-3,
                                convert.taps_from_jax(w0, "cpu"), teq.err_spec(method, syms),
                                True, 128)
        assert np.max(np.abs(_np(got[1]) - np.asarray(ref[1]))) <= TAPS_TOL
        assert np.max(np.abs(_np(got[2]) - np.asarray(ref[2]))) <= MU_TOL
        assert np.max(np.abs(_np(got[0]) - np.asarray(ref[0]))) <= ERR_TRACE_TOL


CALL_CASES = {
    "seq": dict(backend="seq"),
    "block": dict(backend="block", block_size=64),
    "block default size": dict(backend="block"),
    "modes=[1]": dict(backend="seq", modes=[1]),
    "apply": dict(backend="block", block_size=64, apply=True),
    "apply modes=[0]": dict(backend="seq", modes=[0], apply=True),
    "avoid_cma_sing": dict(backend="seq", method="cma", avoid_cma_sing=True, apply=True),
    "avoid_cma_sing block": dict(backend="block", block_size=64, method="cma",
                                 avoid_cma_sing=True),
    "real-valued": dict(backend="seq", method="cma_real", apply=True),
    "real-valued block": dict(backend="block", block_size=64, method="dd_real", apply=True),
    "data-aided": dict(backend="seq", method="sbd_data", TrSyms=800),
    "wxy and Niter": dict(backend="seq", method="rde", Niter=2, TrSyms=500, wxy="trained"),
    "adaptive sbd": dict(backend="block", block_size=64, method="sbd", adaptive_stepsize=True),
}


class TestEntryFunctions:
    @pytest.mark.parametrize("case", list(CALL_CASES))
    def test_equalise_signal(self, capture, case):
        E, tx, _ = capture
        kw = dict(CALL_CASES[case])
        if kw.get("method") == "sbd_data":
            kw["symbols"] = tx[:, :800]
        if kw.get("wxy") == "trained":
            kw["wxy"] = np.array(jeq.equalise_signal(E, 2, 2e-3, M, Ntaps=11, backend="seq")[0])
        ref = jeq.equalise_signal(E, 2, 2e-3, M, **dict(dict(Ntaps=11), **kw))
        got = teq.equalise_signal(E, 2, 2e-3, M, **dict(dict(Ntaps=11), **kw), device="cpu")
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert tuple(g.shape) == np.asarray(r).shape
        w_g, w_r = (got[-2], ref[-2])
        assert np.max(np.abs(_np(w_g) - np.asarray(w_r))) <= TAPS_TOL
        assert np.max(np.abs(_np(got[-1]) - np.asarray(ref[-1]))) <= ERR_TRACE_TOL
        if kw.get("apply"):
            out_g, out_r = _np(got[0]), np.asarray(ref[0])
            assert np.iscomplexobj(out_g)
            # taps within 1e-4 over 22 (44 real-valued) window terms of unit power
            assert np.max(np.abs(out_g - out_r)) <= 1e-3

    @pytest.mark.parametrize("backend, kw", [
        ("seq", {}), ("block", dict(block_size=64)),
        ("seq", dict(methods=("cma", "rde"), adaptive_stepsize=(True, True), Niter=(2, 1))),
        ("block", dict(methods=("cma_real", "dd_real"), block_size=64)),
        ("seq", dict(apply=False, modes=[0], TrSyms=(400, 300)))])
    def test_dual_mode_equalisation(self, capture, backend, kw):
        E, _, _ = capture
        jkw = {k: v for k, v in kw.items() if k != "block_size"}
        if "block_size" in kw:
            # the reference's dual-mode function hands block_size down through **kwargs
            jkw["block_size"] = kw["block_size"]
        ref = jeq.dual_mode_equalisation(E, 2, (2e-3, 1e-3), M, Ntaps=11, backend=backend, **jkw)
        got = teq.dual_mode_equalisation(E, 2, (2e-3, 1e-3), M, Ntaps=11, backend=backend,
                                         device="cpu", **kw)
        assert len(got) == len(ref)
        assert np.max(np.abs(_np(got[-2]) - np.asarray(ref[-2]))) <= TAPS_TOL
        for e_g, e_r in zip(got[-1], ref[-1]):
            assert np.max(np.abs(_np(e_g) - np.asarray(e_r))) <= ERR_TRACE_TOL
        if len(got) == 3:
            assert np.max(np.abs(_np(got[0]) - np.asarray(ref[0]))) <= 1e-3

    def test_kernel_backends_on_cpu_run_their_plain_versions(self, capture):
        E, _, _ = capture
        seq = teq.equalise_signal(E, 2, 2e-3, M, Ntaps=11, method="rde", backend="seq",
                                  adaptive_stepsize=True, device="cpu")
        b9 = teq.equalise_signal(E, 2, 2e-3, M, Ntaps=11, method="rde", backend="cuda",
                                 adaptive_stepsize=True, device="cpu")
        assert torch.equal(seq[0], b9[0]) and torch.equal(seq[1], b9[1])
        # B1's plain version takes its error from host constants, the block
        # backend from the general error function: the same arithmetic
        blk = teq.equalise_signal(E, 2, 2e-3, M, Ntaps=11, method="cma", backend="block",
                                  block_size=64, adaptive_stepsize=True, device="cpu")
        b1 = teq.equalise_signal(E, 2, 2e-3, M, Ntaps=11, method="cma", backend="cuda_block",
                                 block_size=64, adaptive_stepsize=True, device="cpu")
        assert float((blk[0] - b1[0]).abs().max()) <= 1e-6

    def test_apply_filter_top_level(self, capture):
        E, _, _ = capture
        rng = np.random.default_rng(1)
        w = ((rng.standard_normal((2, 2, 11)) + 1j * rng.standard_normal((2, 2, 11))) / 8).astype(
            np.complex64)
        wr = (rng.standard_normal((4, 4, 11)) / 8).astype(np.float32)
        Et = torch.as_tensor(E)
        for taps, modes in ((w, None), (w, [1]), (wr, None)):
            ref = np.asarray(jeq.apply_filter(E, 2, taps, modes=modes))
            got = teq.apply_filter(Et, 2, torch.as_tensor(taps), modes=modes)
            assert got.shape == ref.shape and got.dtype == torch.complex64
            assert np.max(np.abs(_np(got) - ref)) <= 1e-5 * np.sqrt(np.mean(np.abs(ref) ** 2)) * 10
        assert teq.apply_filter_py is teq.apply_filter
        with pytest.raises(ValueError, match="complex signal"):
            teq.apply_filter(Et.real, 2, torch.as_tensor(w))

    def test_default_training_length_and_block_size(self):
        assert teq._cal_training_symbol_len(2, 11, 8192) == jeq._cal_training_symbol_len(2, 11, 8192)
        assert teq._resolve_backend("auto", None, True) == ("seq", 32)
        assert teq._resolve_backend("block", None, True) == ("block", 32)
        assert teq._resolve_backend("auto", None, False, True) == ("cuda_block", 128)
        assert teq._resolve_backend("auto", None, False, False) == ("block", 128)
        assert teq._resolve_backend("cuda", None, False) == ("cuda", 32)
        assert teq._resolve_backend("cuda_block", 256, False) == ("cuda_block", 256)


class TestCDcomp:
    # 10 km of standard fibre at 10 GBd, 2 samples per symbol
    ARGS = dict(fs=20e9, L=10e3, D=16.8e-6, wl=1550e-9)

    @pytest.mark.parametrize("N", [0, 256])
    def test_matches_jax(self, N):
        rng = np.random.default_rng(6)
        E = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
        a = self.ARGS
        ref, H_ref = jeq.CDcomp(E, a["fs"], N, a["L"], a["D"], a["wl"])
        got, H = teq.CDcomp(E, a["fs"], N, a["L"], a["D"], a["wl"], device="cpu")
        ref, H_ref = np.asarray(ref), np.asarray(H_ref)
        assert got.shape == ref.shape and H.shape == H_ref.shape
        assert np.max(np.abs(_np(H) - H_ref)) <= 1e-4
        assert np.max(np.abs(_np(got) - ref)) <= 1e-4 * np.max(np.abs(ref))

    def test_block_length_must_be_a_multiple_of_four(self):
        a = self.ARGS
        with pytest.raises(ValueError, match="multiple of 4"):
            teq.CDcomp(np.ones(512, np.complex64), a["fs"], 250, a["L"], a["D"], a["wl"],
                       device="cpu")


class TestSlice:
    def test_two_stage_seq_shares_decisions_with_jax(self):
        """The equaliser path end to end: both packages, then the same carrier recovery."""
        E, syms, const = bench.make_tx(2 ** 15, seed=2)
        kw = dict(Ntaps=17, methods=("mcma", "rde"), adaptive_stepsize=(True, True),
                  backend="seq")
        ref = np.array(jeq.dual_mode_equalisation(E, 2, (1e-3, 1e-3), 64, **kw)[0])
        got, w, (e1, e2) = teq.dual_mode_equalisation(E, 2, (1e-3, 1e-3), 64, **kw, device="cpu")
        assert got.shape == ref.shape and e1.shape == e2.shape == (2, w.shape[-1] * (
            2 ** 15 // 17 - 1))
        chain = make_rx_chain(bps_mode="single", bps_N=14, device="cpu")
        outs = []
        for z in (torch.as_tensor(ref), got):
            eqp = teq.planes(z)
            outr, outi = chain.unwrap_derotate(eqp, chain.carrier_phase(eqp))
            outs.append(torch.complex(outr, outi))
        trim = slice(GATE_TRIM, -GATE_TRIM)
        assert shared_decisions(outs[0][:, trim], outs[1][:, trim], const) >= 0.999
        for o in outs:
            assert ser_gate(o, torch.as_tensor(syms), const) <= 1e-4


class TestRaises:
    def test_unknown_backend(self, capture):
        with pytest.raises(ValueError, match="unknown backend"):
            teq.equalise_signal(capture[0], 2, 1e-3, M, Ntaps=11, backend="pallas", device="cpu")

    @pytest.mark.parametrize("backend, method", [("cuda", "sbd"), ("cuda", "mddma"),
                                                 ("cuda", "cma2"), ("cuda_block", "mrde"),
                                                 ("cuda_block", "cme"), ("cuda", "cma_real"),
                                                 ("cuda_block", "dd_real")])
    def test_kernel_backend_names_its_methods(self, capture, backend, method):
        with pytest.raises(NotImplementedError, match="cma.*mcma.*rde"):
            teq.equalise_signal(capture[0], 2, 1e-3, M, Ntaps=11, method=method, backend=backend,
                                device="cpu")

    def test_block_kernel_refuses_a_cross_grid(self, capture):
        """cuda_block takes a cross grid: its plain version decides on the cross as block does."""
        kw = dict(Ntaps=11, method="sbd", TrSyms=512, block_size=64, device="cpu")
        w, err = teq.equalise_signal(capture[0], 2, 1e-3, 32, backend="cuda_block", **kw)
        w_b, err_b = teq.equalise_signal(capture[0], 2, 1e-3, 32, backend="block", **kw)
        assert float((w - w_b).abs().max()) <= 1e-6 and float((err - err_b).abs().max()) <= 1e-5
        # what the kernel does refuse is an alphabet above 256 points without a grid
        big = np.exp(2j * np.pi * np.arange(300) / 300) * (1 + np.arange(300) / 300)
        with pytest.raises(ValueError, match="at most 256"):
            teq.equalise_signal(capture[0], 2, 1e-3, 32, symbols=big.astype(np.complex64),
                                backend="cuda_block", **kw)

    def test_avoid_cma_sing_checks(self, capture):
        with pytest.raises(ValueError, match="dual-pol"):
            teq.equalise_signal(capture[0][:1], 2, 1e-3, M, Ntaps=11, avoid_cma_sing=True,
                                device="cpu")
        with pytest.raises(ValueError, match="modes"):
            teq.equalise_signal(capture[0], 2, 1e-3, M, Ntaps=11, avoid_cma_sing=True, modes=[0],
                                device="cpu")

    @pytest.mark.parametrize("entry", ["equalise_signal", "dual_mode_equalisation", "CDcomp",
                                       "make_rx_chain", "make_pilot_rx_chain", "make_pilot_tx"])
    def test_entry_points_default_to_the_card(self, capture, entry):
        """With no ``device`` an entry point runs on the card; without one it raises."""
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        E = capture[0]
        calls = {
            "equalise_signal": lambda: teq.equalise_signal(E, 2, 1e-3, M, Ntaps=11),
            "dual_mode_equalisation": lambda: teq.dual_mode_equalisation(E, 2, (1e-3, 1e-3), M,
                                                                         Ntaps=11),
            "CDcomp": lambda: teq.CDcomp(E[0], 20e9, 0, 1e3, 16.8e-6, 1550e-9),
            "make_rx_chain": lambda: make_rx_chain(TrSyms=256),
            "make_pilot_rx_chain": lambda: make_pilot_rx_chain(
                np.ones((2, 64), np.complex64), np.ones((2, 30), np.complex64), 1024, 32,
                eq_trainer="ls"),
            "make_pilot_tx": lambda: make_pilot_tx(2, frame_len=2 ** 10, seq_len=64),
        }
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
            calls[entry]()
