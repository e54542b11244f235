"""The port's blind decimated16 chain against the JAX package's, on one capture.

The reference runs ``make_rx_chain(..., pallas=True, bps_win="f32")`` with
its Pallas kernels in interpret mode on the CPU; the port runs its plain
versions on CPU tensors. The capture is ``bench.make_tx`` at 2^15 symbols
per polarisation, trained on a 2^14-symbol prefix as the bench does: a
2^13-symbol prefix does not converge on this channel in either package
(both gate at SER ~0.44), so the gate could not tell a right chain from a
wrong one there.
"""
import numpy as np
import jax
import pytest
import torch

import bench
from qampy_tpu.ops.chain import make_rx_chain as jax_make_rx_chain
from qampy_tpu_torch.convert import planes_from_complex, taps_from_jax
from qampy_tpu_torch.ops.chain import cma_singularity_guard, make_rx_chain
from qampy_tpu_torch.workload import GATE_TRIM, decide, ser_gate

NSYM, TRS = 2 ** 15, 2 ** 14
CFG = dict(M=64, Ntaps=17, os=2, bps_angles=64, bps_N=12, block_size=256, TrSyms=TRS,
           bps_mode="decimated16")


@pytest.fixture(scope="module")
def capture():
    E, syms, const = bench.make_tx(NSYM, seed=1)
    return E, syms, const, np.concatenate([E.real, E.imag]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run(capture):
    fwd = jax_make_rx_chain(**CFG, pallas=True, bps_tile=2048, bps_win="f32")
    (outr, outi), w = jax.jit(fwd.planes_with_taps)(capture[3])
    return np.asarray(outr) + 1j * np.asarray(outi), np.asarray(w)


@pytest.fixture(scope="module")
def port(capture):
    chain = make_rx_chain(**CFG, device="cpu")
    P = planes_from_complex(capture[0], "cpu")
    (outr, outi), w = chain.planes_with_taps(P)
    return chain, P, torch.complex(outr, outi), w


def test_taps_agree(jax_run, port):
    # float32 on both sides; the two trainings' taps differ by ~1e-7 (measured)
    assert np.abs(port[3].numpy() - jax_run[1]).max() <= 1e-4


def test_tracking_on_reference_taps_decides_like_reference(capture, jax_run, port):
    chain, P = port[0], port[1]
    outr, outi = chain.tracking_planes(P, taps_from_jax(jax_run[1], "cpu"))
    got = torch.complex(outr, outi)[:, GATE_TRIM:-GATE_TRIM]
    ref = torch.as_tensor(jax_run[0][:, GATE_TRIM:-GATE_TRIM])
    # the reference filter contracts in bf16, so values differ by ~1e-3;
    # the decided symbols must agree almost everywhere
    agree = float((decide(got, capture[2]) == decide(ref, capture[2])).double().mean())
    assert agree >= 0.999


@pytest.mark.parametrize("which", ["jax", "port"])
def test_ser_gate(capture, jax_run, port, which):
    out = torch.as_tensor(jax_run[0]) if which == "jax" else port[2]
    assert ser_gate(out, torch.as_tensor(capture[1]), capture[2]) <= 1e-5


def test_output_shape_and_finite(port):
    out = port[2]
    assert out.shape == (2, (2 * NSYM - 17) // 2 + 1)
    assert bool(torch.isfinite(out.real).all() and torch.isfinite(out.imag).all())


def test_tracking_equals_full_chain(port):
    chain, P, out, w = port
    outr, outi = chain.tracking_planes(P, w)
    assert torch.equal(outr, out.real) and torch.equal(outi, out.imag)


def test_complex_and_pair_entries(capture, port):
    chain, P, out, w = port
    E = torch.as_tensor(capture[0])
    o2, w2 = chain.with_taps(E)
    assert torch.equal(w2, w) and torch.equal(o2, out)
    assert torch.equal(chain.tracking(E, w), out)
    outr, outi = chain.tracking_planes(P[:2], w, P[2:])
    assert torch.equal(outr, out.real) and torch.equal(outi, out.imag)


def test_single_polarisation_taps_agree(capture):
    """nmodes=1: no singularity guard; the trainings still match the reference."""
    E = capture[0][:1]
    P1 = np.concatenate([E.real, E.imag]).astype(np.float32)
    fwd = jax_make_rx_chain(**CFG, pallas=True, bps_tile=2048, bps_win="f32")
    _, w_ref = jax.jit(fwd.planes_with_taps)(P1)
    (outr, _), w = make_rx_chain(**CFG).planes_with_taps(torch.as_tensor(P1))
    assert w.shape == (1, 1, 17) and outr.shape == (1, NSYM - 8)
    assert np.abs(w.numpy() - np.asarray(w_ref)).max() <= 1e-4


def test_singularity_guard_against_numpy():
    """chain.py:263-270 written out in numpy."""
    rng = np.random.default_rng(2)
    row = rng.standard_normal((2, 17)) + 1j * rng.standard_normal((2, 17))
    cases = ((np.stack([row, 1.05 * row]), True),
             (np.stack([row, rng.standard_normal((2, 17)) + 0j]), False))
    for w, expect_parallel in cases:
        w = w.astype(np.complex64)
        f0, f1 = w[0].ravel(), w[1].ravel()
        parallel = abs(np.vdot(f0, f1)) > 0.9 * np.sqrt(np.sum(abs(f0) ** 2) * np.sum(abs(f1) ** 2))
        assert parallel == expect_parallel
        ref = np.concatenate([w[:1], np.conj(w[0][::-1, ::-1])[None]]) if parallel else w
        got = cma_singularity_guard(torch.as_tensor(w)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=0)
