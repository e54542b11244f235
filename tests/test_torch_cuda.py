"""The CUDA kernels B1-B4 against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit: without a card they
skip. The module imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""
import numpy as np
import pytest
import torch

from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter_cuda, apply_filter_plain,
                                                train_block_cuda, train_block_plain)
from qampy_tpu_torch.ops.phase_cuda import (bps_search_cuda, bps_search_plain,
                                            interp_rotate_cuda, interp_rotate_plain)
from qampy_tpu_torch.workload import GATE_TRIM, decide, make_tx, ser_gate

pytestmark = pytest.mark.gpu

CFG = dict(M=64, Ntaps=17, os=2, bps_angles=64, bps_N=12, block_size=256, TrSyms=2 ** 14,
           bps_mode="decimated16")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions run on the card too: keep their products in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def capture(dev):
    E, syms, const = make_tx(2 ** 15, seed=5)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    return E, syms, const, P


def _specs(nmodes):
    return {m: teq.err_spec(m, teq._reshape_symbols(None, m, 64, np.complex64, nmodes))
            for m in ("mcma", "mddma")}


@pytest.mark.parametrize("nmodes", [1, 2])
@pytest.mark.parametrize("method", ["mcma", "mddma"])
def test_b1_train_block(dev, capture, method, nmodes):
    P = capture[3]
    P = torch.cat([P[:nmodes], P[2:2 + nmodes]]).contiguous()
    w0 = torch.as_tensor(teq._init_taps(17, nmodes, nmodes, np.complex64), device=dev)
    spec = _specs(nmodes)[method]
    e_p, w_p, mu_p = train_block_plain(P, 2 ** 14, 1, 2, 1.9e-3, w0, spec, True, 256)
    e_k, w_k, mu_k = train_block_cuda(P, 2 ** 14, 1, 2, 1.9e-3, w0, spec, True, 256)
    # float32 on both sides in other summation orders, over 64 dependent blocks
    assert float((w_k - w_p).abs().max()) <= 1e-4
    torch.testing.assert_close(mu_k, mu_p, rtol=1e-5, atol=0)
    assert float((e_k - e_p).abs().max()) <= 1e-4


def test_b1_niter_and_fixed_step(dev, capture):
    P = capture[3]
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    spec = _specs(2)["mcma"]
    e_p, w_p, mu_p = train_block_plain(P, 4096, 2, 2, 1e-3, w0, spec, False, 128)
    e_k, w_k, mu_k = train_block_cuda(P, 4096, 2, 2, 1e-3, w0, spec, False, 128)
    assert e_k.shape == (2, 8192)
    assert bool((mu_k == 1e-3).all())
    assert float((w_k - w_p).abs().max()) <= 1e-4


def test_b1_refuses_block_size(dev, capture):
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        train_block_cuda(capture[3], 4096, 1, 2, 1e-3, w0, _specs(2)["mcma"], True, 100)


@pytest.mark.parametrize("dec", [None, 8, 16])
@pytest.mark.parametrize("nmodes", [1, 2])
def test_b2_filter(dev, capture, dec, nmodes):
    P = capture[3]
    P = torch.cat([P[:nmodes], P[2:2 + nmodes]]).contiguous()
    g = torch.Generator().manual_seed(3)
    w = torch.complex(torch.randn(nmodes, nmodes, 17, generator=g),
                      torch.randn(nmodes, nmodes, 17, generator=g)).to(dev) / 8
    ref = apply_filter_plain(P, 2, w, dec)
    got = apply_filter_cuda(P, 2, w, dec)
    ref, got = (ref, got) if dec else ((ref,), (got,))
    rms = float(ref[0].pow(2).mean().sqrt())
    for r, k in zip(ref, got):
        assert r.shape == k.shape
        assert float((k - r).abs().max()) <= 1e-5 * rms


def test_b2_checks_inputs(dev, capture):
    w = torch.zeros(2, 2, 17, dtype=torch.complex64, device=dev)
    with pytest.raises(TypeError):
        apply_filter_cuda(capture[3].double(), 2, w)
    with pytest.raises(ValueError, match="contiguous"):
        apply_filter_cuda(capture[3][:, ::2], 2, w)


@pytest.mark.parametrize("A, N", [(64, 12), (32, 8), (64, 40)])
def test_b3_bps_search(dev, A, N):
    rng = np.random.default_rng(A + N)
    const = make_rx_chain().grid
    L = 2 ** 16
    levels = const[1] + const[0] * np.arange(const[2])
    syms = rng.choice(levels, (2, L)) + 1j * rng.choice(levels, (2, L))
    z = syms * np.exp(1j * np.cumsum(rng.normal(scale=0.01, size=(2, L)), -1))
    z = (z + 0.05 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L))))
    er = torch.as_tensor(z.real.astype(np.float32), device=dev)
    ei = torch.as_tensor(z.imag.astype(np.float32), device=dev)
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, const))
    ref = bps_search_plain(er, ei, cos_t, sin_t, const, N)
    got = bps_search_cuda(er, ei, cos_t, sin_t, const, N)
    ties = tph.bps_near_ties(er, ei, cos_t, sin_t, const, N)
    assert got.dtype == torch.int32
    assert not bool(((got != ref) & ~ties).any())
    assert float(ties.double().mean()) <= 1e-3


@pytest.mark.parametrize("sign", [1, -1])
def test_b4_interp_rotate(dev, sign):
    rng = np.random.default_rng(7)
    L, dx = 2 ** 20, 16
    er, ei = (torch.as_tensor(rng.standard_normal((2, L)).astype(np.float32), device=dev)
              for _ in range(2))
    a = torch.as_tensor((np.cumsum(rng.normal(scale=0.5, size=(2, L // dx)), -1)
                         + 40).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.normal(scale=0.01, size=(2, L // dx)).astype(np.float32),
                        device=dev)
    rp, ip = interp_rotate_plain(er, ei, a, b, dx, sign)
    rk, ik = interp_rotate_cuda(er, ei, a, b, dx, sign)
    assert float((rk - rp).abs().max()) <= 1e-5
    assert float((ik - ip).abs().max()) <= 1e-5


def test_chain_on_card_matches_plain_chain(dev, capture):
    E, syms, const, P = capture
    counters = (train_block_cuda, apply_filter_cuda, bps_search_cuda, interp_rotate_cuda)
    for fn in counters:
        fn.launches = 0
    chain = make_rx_chain(**CFG, device=dev)
    (outr, outi), w = chain.planes_with_taps(P)
    assert [fn.launches for fn in counters] == [2, 1, 1, 1]
    tr, ti = chain.tracking_planes(P, w)
    assert torch.equal(tr, outr) and torch.equal(ti, outi)
    out = torch.complex(outr, outi)
    assert ser_gate(out, torch.as_tensor(syms, device=dev), const) <= 1e-5
    ref = make_rx_chain(**CFG).forward(torch.as_tensor(E))[:, GATE_TRIM:-GATE_TRIM]
    got = out.cpu()[:, GATE_TRIM:-GATE_TRIM]
    # a near-tied phase index may resolve either way and move a few symbols
    # by one angle step: the decisions, not the values, must agree
    assert float((decide(got, const) == decide(ref, const)).double().mean()) >= 0.999
