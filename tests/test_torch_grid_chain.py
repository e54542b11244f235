"""The blind chain on cross and general alphabets in the port against the JAX package.

``make_rx_chain(M=32)`` and ``make_rx_chain(symbols=...)`` on captures of
``bench.make_tx``: the reference runs its Pallas chain in interpret mode
with float32 windows, the port its plain versions on the CPU. The reference
filters in bf16 and the port in float32, so outputs are compared by
decisions, each mode at its best quarter turn, and by the gate.
"""
import functools

import numpy as np
import jax
import pytest
import torch

import bench
from qampy_tpu.ops.chain import make_rx_chain as jax_make_rx_chain
from qampy_tpu_torch import convert, workload
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.workload import GATE_TRIM, ser_gate, shared_decisions

ALPHABETS = {"w64": workload.warped_qam(64),
             "ring": np.exp(1j * 2 * np.pi * np.arange(32) / 32).astype(np.complex64)}

# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

NSYM, TRS = 2 ** 15, 2 ** 14
CFG = dict(Ntaps=17, os=2, methods=("mcma", "sbd"), mu=1.9e-3, bps_angles=64, bps_N=14,
           block_size=256, TrSyms=TRS)
CHAINS = {
    "x32": (dict(M=32), dict(M=32, bps_mode="single")),
    "w64": (dict(const=ALPHABETS["w64"]), dict(symbols=ALPHABETS["w64"], bps_mode="twostage")),
}
INFO_KEYS = ("grid_kind", "gen_bps_coarse", "gen_bps_fine", "bps_mode", "methods")


@functools.lru_cache(maxsize=None)
def _chain_run(key):
    """Both packages' chains on one capture of the alphabet ``key``, run once per process."""
    txkw, chkw = CHAINS[key]
    E, syms, const = bench.make_tx(NSYM, seed=2, **txkw)
    Ew, _, _ = workload.make_tx(NSYM, seed=2, **txkw)
    fwd = jax_make_rx_chain(**CFG, **chkw, pallas=True, bps_tile=2048, bps_win="f32")
    P = np.concatenate([E.real, E.imag]).astype(np.float32)
    (outr, outi), w = jax.jit(fwd.planes_with_taps)(P)
    chain = make_rx_chain(**CFG, **chkw, device="cpu")
    (pr, pi), pw = chain.planes_with_taps(convert.planes_from_complex(E, "cpu"))
    return dict(key=key, E=E, Ew=Ew, syms=syms, const=const, fwd=fwd, chain=chain,
                ref=torch.as_tensor(np.asarray(outr) + 1j * np.asarray(outi)),
                ref_w=np.asarray(w), got=torch.complex(pr, pi), got_w=pw)


@pytest.fixture(scope="module", params=list(CHAINS))
def chain_runs(request):
    return _chain_run(request.param)


def test_chain_capture_is_the_benchs(chain_runs):
    assert np.array_equal(chain_runs["E"], chain_runs["Ew"])


def test_chain_backend_info(chain_runs):
    info, ref = chain_runs["chain"].backend_info, chain_runs["fwd"].backend_info
    assert {k: info[k] for k in INFO_KEYS} == {k: ref[k] for k in INFO_KEYS}
    want = {"x32": ("x", "exact", "exact"), "w64": ("gen", "fitted", "fitted")}[chain_runs["key"]]
    assert (info["grid_kind"], info["gen_bps_coarse"], info["gen_bps_fine"]) == want


@pytest.mark.parametrize("which", ["ref", "got"])
def test_chain_ser(chain_runs, which):
    ser = ser_gate(chain_runs[which], torch.as_tensor(chain_runs["syms"]), chain_runs["const"])
    assert ser < 1e-3


def test_chain_shares_decisions(chain_runs):
    """The reference filters in bf16, the port in float32: measured shares 0.99997 (x32, w64)."""
    trim = slice(GATE_TRIM, -GATE_TRIM)
    share = shared_decisions(chain_runs["ref"][:, trim], chain_runs["got"][:, trim],
                             chain_runs["const"])
    assert share >= 0.99
    assert np.abs(chain_runs["got_w"].numpy() - chain_runs["ref_w"]).max() <= 2e-3


def test_chain_tracking_equals_full(chain_runs):
    chain = chain_runs["chain"]
    outr, outi = chain.tracking_planes(convert.planes_from_complex(chain_runs["E"], "cpu"),
                                       chain_runs["got_w"])
    assert torch.equal(outr, chain_runs["got"].real) and torch.equal(outi, chain_runs["got"].imag)


@pytest.mark.parametrize("mode, coarse, fine, buffers", [
    ("single", "exact", "exact", {"gen_points"}),
    ("twostage", "fitted", "fitted", {"fine_cos", "fine_sin", "gen_points"}),
    ("decimated16", "fitted", "exact", {"gen_points"})])
def test_gen_chain_buffers_and_flags(mode, coarse, fine, buffers):
    """Which grid each search takes, and that the alphabet's table is a buffer of the chain.

    The decimated mode's one search has the fine stage's role and is probed at
    all 64 angles, where the fitted grid of the warped alphabet is refused (at
    twostage's 16 it passes): that search runs on the alphabet itself.
    """
    ch = make_rx_chain(symbols=ALPHABETS["w64"], bps_mode=mode, methods=("mcma", "sbd"),
                       TrSyms=256, device="cpu")
    assert (ch.backend_info["gen_bps_coarse"], ch.backend_info["gen_bps_fine"]) == (coarse, fine)
    assert {n for n, _ in ch.named_buffers()} == {"w0", "bps_cos", "bps_sin"} | buffers
    fitted = tph.grid_decision_info(ch.search_grid)[0] == "sq"
    assert fitted == (mode == "twostage")
    # without a decision stage and with fitted searches nothing reads the table
    ch2 = make_rx_chain(symbols=ALPHABETS["w64"], bps_mode=mode, methods=("mcma", "rde"),
                        TrSyms=256, device="cpu")
    assert (ch2.gen_points is None) == (mode == "twostage")


def test_ring_alphabet_keeps_the_exact_searches():
    """tests/test_chain.py:283-286 of the reference: a ring fails the coarse probe."""
    ch = make_rx_chain(symbols=ALPHABETS["ring"], bps_mode="twostage", device="cpu")
    assert ch.backend_info["gen_bps_coarse"] == "exact"
    assert ch.backend_info["gen_bps_fine"] == "exact"
    assert ch.search_grid is ch.grid and ch.fine_grid is ch.grid and ch.gen_points.shape == (32, 3)


def test_small_gen_alphabet_skips_the_probes():
    """24 points or fewer: the search over the points is cheap, no probe runs (chain.py:156)."""
    const = ALPHABETS["ring"][:24] * (1 + 0.1 * np.arange(24))
    ch = make_rx_chain(symbols=const, bps_mode="twostage", device="cpu")
    assert ch.backend_info["gen_bps_coarse"] == "exact" and ch.search_grid is ch.grid


def test_gen_single_tracking_decides_like_reference():
    """B3's gen distance inside a chain: single mode on the warped alphabet, the port's taps."""
    chain_runs = _chain_run("w64")
    const, w = chain_runs["const"], chain_runs["got_w"].numpy()
    E = chain_runs["E"][:, :2 ** 14]      # 2^13 symbols: the 64 x 64 search in interpret mode
    cfg = dict(CFG, symbols=const, bps_mode="single")
    fwd = jax_make_rx_chain(**cfg, pallas=True, bps_tile=2048, bps_win="f32")
    ref = torch.as_tensor(np.array(jax.jit(fwd.tracking)(E, w)))
    chain = make_rx_chain(**cfg, device="cpu")
    got = chain.tracking(torch.as_tensor(E), torch.as_tensor(w))
    assert chain.backend_info["gen_bps_fine"] == fwd.backend_info["gen_bps_fine"] == "exact"
    assert chain.search_grid is chain.grid and chain.gen_points.shape == (64, 3)
    trim = slice(GATE_TRIM, -GATE_TRIM)
    syms = torch.as_tensor(chain_runs["syms"][:, :2 ** 13])
    assert max(ser_gate(o, syms, const) for o in (ref, got)) < 1e-3
    assert shared_decisions(ref[:, trim], got[:, trim], const) >= 0.99
