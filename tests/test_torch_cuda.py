"""The CUDA kernels B1-B10 against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit: without a card they
skip. The module imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""
import sys

import numpy as np
import pytest
import torch

from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import phase as tph
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.equaliser_cuda import (apply_filter_cuda, apply_filter_frames_cuda,
                                                apply_filter_frames_plain, apply_filter_plain,
                                                chain_latencies, filter_plan, div_check, train_block_cuda,
                                                train_block_plain, train_seq_cuda,
                                                train_seq_plain)
from qampy_tpu_torch.ops.phase_cuda import (bps_fine_cuda, bps_fine_plain, bps_plan,
                                            bps_search_cuda, bps_search_plain, cpe_coeffs_cuda,
                                            cpe_coeffs_plain, interp_rotate_cuda,
                                            interp_rotate_plain, quarter_unwrap, rotate_cuda,
                                            rotate_plain, unwrap_derotate_cuda,
                                            unwrap_derotate_plain, unwrap_slopes_cuda,
                                            unwrap_slopes_plain, fine_plan, cpe_plan,
                                            slopes_plan)
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
from qampy_tpu_torch.workload import (GATE_TRIM, apsk_const, ber_gate, decide, make_pilot_tx,
                                      make_tx, ser_gate, shared_decisions, warped_qam)
from test_torch_bps_launch import kernel_order_search

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


def _sub(P, nmodes, L=None):
    """The planes of the first ``nmodes`` modes, cut to ``L`` samples."""
    return torch.cat([P[:nmodes, :L], P[2:2 + nmodes, :L]]).contiguous()


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("L", [2 ** 16, 40001], ids=["bulk copies", "odd L: cp.async"])
@pytest.mark.parametrize("nmodes, S, ntaps, os_", [(1, 32, 17, 2), (2, 64, 17, 2), (2, 256, 45, 2),
                                                   (2, 512, 16, 2), (1, 256, 16, 2),
                                                   (2, 32, 45, 2), (2, 128, 17, 1),
                                                   (1, 1024, 5, 2), (2, 256, 17, 3)])
def test_b1_instances(dev, capture, nmodes, S, ntaps, os_, L):
    """Both ways a segment arrives, one and two modes, every block size class, odd and even
    tap counts, os = 2 and the plain path; two passes, so the ring wraps to block 0."""
    P = _sub(capture[3], nmodes, L)
    w0 = torch.as_tensor(teq._init_taps(ntaps, nmodes, nmodes, np.complex64), device=dev)
    args = (P, 4096, 2, os_, 1e-3, w0, _specs(nmodes)["mcma"], True, S)
    e_p, w_p, mu_p = train_block_plain(*args)
    got = train_block_cuda(*args)
    e_k, w_k, mu_k = got
    assert e_k.shape == e_p.shape == (nmodes, 8192)
    assert float((w_k - w_p).abs().max()) <= 1e-4
    torch.testing.assert_close(mu_k, mu_p, rtol=1e-5, atol=0)
    assert float((e_k - e_p).abs().max()) <= 1e-4
    assert _same(got, train_block_cuda(*args))


def test_b1_unaligned_view(dev, capture):
    """Planes that start 4 bytes past a 16-byte boundary take the cp.async path."""
    P = capture[3]
    buf = torch.empty(P.numel() + 1, dtype=torch.float32, device=dev)
    view = buf[1:].view(P.shape)
    view.copy_(P)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    args = (4096, 1, 2, 1e-3, w0, _specs(2)["mcma"], True, 256)
    assert _same(train_block_cuda(view, *args), train_block_cuda(P, *args))


@pytest.mark.parametrize("method", ["mcma", "mddma", "cma", "rde", "sbd", "dd"])
def test_b1_methods_small_blocks(dev, capture, method):
    """Every method's instance at S = 64 (the filter output split over 8 lanes), two passes."""
    P = capture[3]
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    _, w1, _ = train_block_cuda(P, 2 ** 14, 1, 2, 1.9e-3, w0, _specs(2)["mcma"], True, 256)
    spec = teq.err_spec(method, teq._reshape_symbols(None, method, 64, np.complex64, 2))
    # rde over 8 blocks in all (see test_b1_square_grid_methods)
    args = (P, 256, 2, 2, 1.9e-3, w0 if method in ("mcma", "cma") else w1, spec, True, 64)
    e_p, w_p, mu_p = train_block_plain(*args)
    got = train_block_cuda(*args)
    assert float((got[1] - w_p).abs().max()) <= 1e-4
    torch.testing.assert_close(got[2], mu_p, rtol=1e-5, atol=0)
    assert float((got[0] - e_p).abs().max()) <= 1e-4
    assert _same(got, train_block_cuda(*args))


def test_b1_refuses_block_size(dev, capture):
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        train_block_cuda(capture[3], 4096, 1, 2, 1e-3, w0, _specs(2)["mcma"], True, 100)


def _taps(dev, nout, nmodes, ntaps, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(nout, nmodes, ntaps, generator=g),
                         torch.randn(nout, nmodes, ntaps, generator=g)).to(dev) / 8


@pytest.mark.parametrize("dec", [None, 8, 16])
@pytest.mark.parametrize("nout", [1, 2])
@pytest.mark.parametrize("os_", [1, 2, 3, 6])
@pytest.mark.parametrize("ntaps", [1, 2, 17, 45, 63])
@pytest.mark.parametrize("nmodes", [1, 2])
def test_b2_filter(dev, capture, dec, nout, os_, ntaps, nmodes):
    """Every tap count class (one chunk, padded chunks, 45 and 63), os = 2 and the generic
    instance, one and two output modes, with and without side output; 2^16 - 5 samples, so
    the last tile is ragged and the rows are staged thread by thread (L % 4 != 0)."""
    P = _sub(capture[3], nmodes, 2 ** 16 - 5)
    w = _taps(dev, nout, nmodes, ntaps, 3 + ntaps)
    ref = apply_filter_plain(P, os_, w, dec)
    got = apply_filter_cuda(P, os_, w, dec)
    ref, got = (ref, got) if dec else ((ref,), (got,))
    assert got[0].shape[-1] % filter_plan(nmodes, nout, ntaps, os_, got[0].shape[-1]).tile
    rms = float(ref[0].pow(2).mean().sqrt())
    for r, k in zip(ref, got):
        assert r.shape == k.shape
        assert float((k - r).abs().max()) <= 1e-5 * rms
    again = apply_filter_cuda(P, os_, w, dec)
    assert _same(got, again if dec else (again,))


def test_b2_checks_inputs(dev, capture):
    w = torch.zeros(2, 2, 17, dtype=torch.complex64, device=dev)
    with pytest.raises(TypeError):
        apply_filter_cuda(capture[3].double(), 2, w)
    with pytest.raises(ValueError, match="contiguous"):
        apply_filter_cuda(capture[3][:, ::2], 2, w)


def _qam_planes(dev, seed, L=2 ** 16):
    """64-QAM planes on the card with a random-walk carrier phase and noise: (grid, er, ei)."""
    rng = np.random.default_rng(seed)
    grid = make_rx_chain(device="cpu").grid
    levels = grid[1] + grid[0] * np.arange(grid[2])
    syms = rng.choice(levels, (2, L)) + 1j * rng.choice(levels, (2, L))
    z = syms * np.exp(1j * np.cumsum(rng.normal(scale=0.01, size=(2, L)), -1))
    z = (z + 0.05 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L))))
    return (grid, torch.as_tensor(z.real.astype(np.float32), device=dev),
            torch.as_tensor(z.imag.astype(np.float32), device=dev))


@pytest.mark.parametrize("A, N", [(64, 12), (32, 8), (64, 40), (16, 60), (64, 14)])
def test_b3_bps_search(dev, A, N):
    const, er, ei = _qam_planes(dev, A + N)
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


def test_b4_partial_last_block(dev):
    """Planes of Ld*16 - 9 samples with Ld coefficients: bit-equal to the twin on the card,
    and to the kernel on the planes zero-padded to Ld*16, cut back."""
    rng = np.random.default_rng(8)
    Ld, dx = 2 ** 16, 16
    L = Ld * dx - 9
    er, ei = (torch.as_tensor(rng.standard_normal((2, L)).astype(np.float32), device=dev)
              for _ in range(2))
    a = torch.as_tensor((np.cumsum(rng.normal(scale=0.5, size=(2, Ld)), -1)
                         + 40).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.normal(scale=0.01, size=(2, Ld)).astype(np.float32), device=dev)
    rk, ik = interp_rotate_cuda(er, ei, a, b, dx, 1)
    rp, ip = interp_rotate_plain(er, ei, a, b, dx, 1)
    assert rk.shape == (2, L) and torch.equal(rk, rp) and torch.equal(ik, ip)
    pad = torch.nn.functional.pad
    rf, if_ = interp_rotate_cuda(pad(er, (0, 9)), pad(ei, (0, 9)), a, b, dx, 1)
    assert torch.equal(rk, rf[:, :L]) and torch.equal(ik, if_[:, :L])
    with pytest.raises(ValueError, match="cover"):
        interp_rotate_cuda(er, ei, a[:, :-1].contiguous(), b[:, :-1].contiguous(), dx, 1)


def _decimated_indices(dev, rows, L, seed):
    """Indices of a random walk over the 64 angles that wraps often, with jumps of +-32 (the
    half-turn tie) mixed in."""
    g = torch.Generator(device=dev).manual_seed(seed)
    steps = torch.randint(-3, 4, (rows, L), generator=g, device=dev)
    tie = torch.rand(rows, L, generator=g, device=dev) < 0.01
    steps = torch.where(tie, 32 * (2 * (steps > 0).to(steps.dtype) - 1), steps)
    return (torch.cumsum(steps, -1) % 64).to(torch.int32)


@pytest.mark.parametrize("rows, L", [(2, 2 ** 16), (2, 2 ** 18), (2, 2047), (2, 2048),
                                     (2, 2049), (3, 5001), (2, 1), (1, 2)])
def test_b10_unwrap_slopes(dev, rows, L):
    """Bit-equal to the twin run on the card: the benchmark's two shapes, one tile and one
    sample either side, rows whose length is no multiple of 4 (scalar accesses), rows of one
    and two samples. Two launches in a row give the same (the scratch is zeroed each time)."""
    idx = _decimated_indices(dev, rows, L, L)
    lo, step = float(-np.pi / 4), float(np.pi / 128)
    ap, bp = unwrap_slopes_plain(idx, lo, step, 16)
    before = unwrap_slopes_cuda.launches
    ak, bk = unwrap_slopes_cuda(idx, lo, step, 16)
    assert unwrap_slopes_cuda.launches == before + 1
    assert torch.equal(ak, ap) and torch.equal(bk, bp)
    ak2, bk2 = unwrap_slopes_cuda(idx, lo, step, 16)
    assert torch.equal(ak2, ak) and torch.equal(bk2, bk)
    # the scratch the wrapper sizes: its tile rule is the kernel's
    from qampy_tpu_torch.ops import _build
    assert _build.library().qtt_unwrap_slopes_tiles(L) == slopes_plan(rows, L).tiles
    # indices whose storage is not 16-byte aligned: scalar accesses
    moved = torch.empty(rows * L + 1, dtype=torch.int32, device=dev)[1:].view(rows, L)
    moved.copy_(idx)
    ak2, bk2 = unwrap_slopes_cuda(moved, lo, step, 16)
    assert torch.equal(ak2, ak) and torch.equal(bk2, bk)
    # an odd stride: the division as PyTorch does it on the card
    ap, bp = unwrap_slopes_plain(idx, lo, step, 3)
    ak, bk = unwrap_slopes_cuda(idx, lo, step, 3)
    assert torch.equal(ak, ap) and torch.equal(bk, bp)


@pytest.mark.parametrize("nsym", [2 ** 20, 2 ** 22])
def test_b10_counts_equal_the_torch_glue(dev, nsym):
    """On captures of the blind cells' sizes (2^20 and 2^22 symbols a mode): B10's
    quarter-turn counts are those of the glue's torch expressions on the card (floor(d /
    (pi/2) + 0.5), the float32 cumsum of -(pi/2) counts), and its phase within that float
    sum's rounding."""
    cfg = dict(CFG, bps_N=12)
    E, _, _ = make_tx(nsym, seed=7)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    del E
    chain = make_rx_chain(**cfg, device=dev)
    _, w = chain.planes_with_taps(P)
    eqp, decp = chain.equalise(P, w)
    idxd = chain.phase_search(decp)
    hp = float(np.float32(np.pi / 2))
    phd = chain.lo_a + chain.step_a * idxd.to(torch.float32)
    m = torch.floor((phd[:, 1:] - phd[:, :-1]) / hp + 0.5)
    phu = phd + torch.cumsum(torch.nn.functional.pad(-hp * m, (1, 0)), dim=-1)
    a, b = unwrap_slopes_cuda(idxd, chain.lo_a, chain.step_a, chain.dec)
    M = torch.round((phd.double() - a.double()) / hp).to(torch.int64)
    assert torch.equal(torch.diff(M, dim=-1), m.to(torch.int64))
    assert float((a - phu).abs().max()) <= 1e-5 * max(1.0, float(phu.abs().max()))


def test_chain_on_card_matches_plain_chain(dev, capture):
    E, syms, const, P = capture
    counters = (train_block_cuda, apply_filter_cuda, bps_search_cuda, unwrap_slopes_cuda,
                interp_rotate_cuda)
    for fn in counters:
        fn.launches = 0
    chain = make_rx_chain(**CFG, device=dev)
    (outr, outi), w = chain.planes_with_taps(P)
    assert [fn.launches for fn in counters] == [2, 1, 1, 1, 1]
    tr, ti = chain.tracking_planes(P, w)
    assert torch.equal(tr, outr) and torch.equal(ti, outi)
    out = torch.complex(outr, outi)
    assert ser_gate(out, torch.as_tensor(syms, device=dev), const) <= 1e-5
    ref = make_rx_chain(**CFG, device="cpu").forward(torch.as_tensor(E))[:, GATE_TRIM:-GATE_TRIM]
    got = out.cpu()[:, GATE_TRIM:-GATE_TRIM]
    # a near-tied phase index may resolve either way and move a few symbols
    # by one angle step: the decisions, not the values, must agree
    assert float((decide(got, const) == decide(ref, const)).double().mean()) >= 0.999


@pytest.mark.parametrize("rows, L", [(2, 2 ** 20 + 2 ** 19 + 77), (3, 1000), (2, 1)])
def test_b7_unwrap_derotate(dev, rows, L):
    """Rows longer than 2^20 samples, shorter than one tile, and of one sample."""
    g = torch.Generator(device=dev).manual_seed(L)
    er, ei = (torch.randn(rows, L, generator=g, device=dev) for _ in range(2))
    theta = torch.cumsum(0.2 * torch.randn(rows, L, generator=g, device=dev), -1)
    ph = torch.remainder(theta + np.pi / 4, np.pi / 2) - np.pi / 4
    rp, ip = unwrap_derotate_plain(er, ei, ph)
    rk, ik = unwrap_derotate_cuda(er, ei, ph)
    u = quarter_unwrap(ph).abs()
    # both within |z| (ulp32(|u|) + 2^-23) of the exact rotation by the same u
    ulp = torch.nextafter(u, torch.full_like(u, np.inf)) - u
    bound = 2 * torch.sqrt(er ** 2 + ei ** 2) * (ulp + 2.0 ** -23)
    assert bool((torch.sqrt((rk - rp) ** 2 + (ik - ip) ** 2) <= bound).all())


@pytest.mark.parametrize("N", [14, 60])
def test_b8_bps_fine(dev, N):
    grid, er, ei = _qam_planes(dev, N)
    ang = np.linspace(-np.pi / 4, np.pi / 4, 16, endpoint=False, dtype=np.float32)
    cos1, sin1 = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    ph1 = -np.pi / 4 + np.pi / 32 * bps_search_cuda(er, ei, cos1, sin1, grid, 60).float()
    cd, sd, d0f, ddf = tph.fine_tables(16, 8, grid)
    cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
    ref = bps_fine_plain(er, ei, ph1, cd, sd, grid, N, d0f, ddf)
    got = bps_fine_cuda(er, ei, ph1, cd, sd, grid, N, d0f, ddf)
    ties = tph.bps_fine_near_ties(er, ei, ph1, cd, sd, grid, N)
    assert not bool(((got != ref) & ~ties).any())
    assert float(ties.double().mean()) <= 1e-3


def test_b7_b8_check_inputs(dev):
    grid, er, ei = _qam_planes(dev, 3, L=4096)
    cd, sd, d0f, ddf = tph.fine_tables(16, 8, grid)
    cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
    wide = torch.cat([er, ei], dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        unwrap_derotate_cuda(wide[:, ::2], wide[:, 1::2], wide[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        bps_fine_cuda(wide[:, ::2], ei, er, cd, sd, grid, 14, d0f, ddf)
    with pytest.raises(TypeError):
        unwrap_derotate_cuda(er.double(), ei.double(), er.double())
    with pytest.raises(ValueError, match="shape"):
        unwrap_derotate_cuda(er, ei, er[:1])


@pytest.mark.parametrize("mode", ["single", "twostage"])
def test_per_sample_chain_on_card(dev, capture, mode):
    E, syms, const, P = capture
    cfg = dict(CFG, bps_N=14, bps_mode=mode)
    counters = (train_block_cuda, apply_filter_cuda, bps_search_cuda, interp_rotate_cuda,
                bps_fine_cuda, unwrap_derotate_cuda, unwrap_slopes_cuda)
    for fn in counters:
        fn.launches = 0
    chain = make_rx_chain(**cfg, device=dev)
    (outr, outi), w = chain.planes_with_taps(P)
    assert [fn.launches for fn in counters] == [2, 1, 1, 0, int(mode == "twostage"), 1, 0]
    tr, ti = chain.tracking_planes(P, w)
    assert torch.equal(tr, outr) and torch.equal(ti, outi)
    out = torch.complex(outr, outi)
    assert ser_gate(out, torch.as_tensor(syms, device=dev), const) <= 1e-5
    ref = make_rx_chain(**cfg, device="cpu").forward(torch.as_tensor(E))[:, GATE_TRIM:-GATE_TRIM]
    assert shared_decisions(out.cpu()[:, GATE_TRIM:-GATE_TRIM], ref, const) >= 0.999


def _pilot_rows(dev, rows, frame_len, seq_len, R, seed):
    """Rows whose pilots carry a random-walk phase over a few radians (wrapping past +-pi)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    npil = (frame_len - seq_len) // R
    pil = torch.polar(torch.ones(2, npil, device=dev),
                      (torch.randint(0, 4, (2, npil), generator=g, device=dev) + 0.5) * np.pi / 2)
    walk = torch.cumsum(0.05 * torch.randn(rows, npil, generator=g, device=dev), -1)
    sym = torch.complex(torch.randn(rows, frame_len, generator=g, device=dev),
                        torch.randn(rows, frame_len, generator=g, device=dev))
    sym[:, seq_len::R] = pil.repeat_interleave(rows // 2, 0) * torch.polar(torch.ones_like(walk),
                                                                          walk)
    return (sym.real.contiguous(), sym.imag.contiguous(), pil.real.contiguous(),
            pil.imag.contiguous())


@pytest.mark.parametrize("frame_len, seq_len, rows", [(2 ** 16, 1024, 480), (2 ** 14, 512, 6),
                                                      (2 ** 17, 1024, 4)])
def test_b5_cpe_coeffs(dev, frame_len, seq_len, rows):
    R = 32
    symr, symi, pr, pi = _pilot_rows(dev, rows, frame_len, seq_len, R, rows)
    npil = (frame_len - seq_len) // R
    args = (symr, symi, pr, pi, seq_len, R, seq_len // R + 1, npil - 2, R, 3, frame_len // R)
    a_p, b_p = cpe_coeffs_plain(*args)
    a_k, b_k = cpe_coeffs_cuda(*args)
    # the same float32 formula; atan2 may differ by an ulp between the two
    assert float((a_k - a_p).abs().max()) <= 1e-5
    assert float((b_k - b_p).abs().max()) <= 1e-6


def _cpe_forms(symr, symi, seq_len, R, npil, form):
    """The symbol planes and (off, stride) B5 reads the pilots from in ``form``: "strided", the
    filter output itself; "contiguous", the pilots gathered as B2's side output gives them;
    "unaligned", the same rows one float past 16-byte alignment (scalar loads)."""
    if form == "strided":
        return symr, symi, seq_len, R
    zr, zi = (x[:, seq_len::R][:, :npil] for x in (symr, symi))
    if form == "contiguous":
        return zr.contiguous(), zi.contiguous(), 0, 1
    pad = torch.zeros(zr.shape[0], 1, device=zr.device)
    return torch.cat([pad, zr], 1), torch.cat([pad, zi], 1), 1, 1


@pytest.mark.parametrize("form", ["strided", "contiguous", "unaligned"])
@pytest.mark.parametrize("cpe_avg", [1, 3, 9])
@pytest.mark.parametrize("frame_len, rows", [(1024 + 32 * 4097, 6), (2 ** 18, 8), (2 ** 20, 4),
                                             (2 ** 16, 480)])
def test_b5_any_pilot_count(dev, frame_len, rows, cpe_avg, form):
    """Rows of 4,097, 8,160 and 32,736 pilots (2^18 and 2^20 symbols at ratio 32), which the
    first B5 design refused, and the bench's 2,016; averages of 1, 3 and 9 pilots; the pilots
    read strided, contiguous and contiguous from rows off 16-byte alignment."""
    R, seq_len = 32, 1024
    symr, symi, pr, pi = _pilot_rows(dev, rows, frame_len, seq_len, R, rows + cpe_avg)
    npil = (frame_len - seq_len) // R
    n_head = (seq_len + R * ((cpe_avg - 1) // 2)) // R
    zr, zi, off, stride = _cpe_forms(symr, symi, seq_len, R, npil, form)
    args = (zr, zi, pr, pi, off, stride, n_head, npil - cpe_avg + 1, R, cpe_avg, frame_len // R)
    a_p, b_p = cpe_coeffs_plain(*args)
    a_k, b_k = cpe_coeffs_cuda(*args)
    assert float((a_k - a_p).abs().max()) <= 1e-5
    assert float((b_k - b_p).abs().max()) <= 1e-6
    a2, b2 = cpe_coeffs_cuda(*args)
    assert torch.equal(a2, a_k) and torch.equal(b2, b_k)


@pytest.mark.parametrize("npil, rows, cpe_avg, n_head, nbt", [(8160, 4, 2501, 3000, 12000),
                                                            (12000, 2, 10001, 5, 100)])
def test_b5_long_average_and_head(dev, npil, rows, cpe_avg, n_head, nbt):
    """An average of 2,501 pilots (longer than a tile: its halo spans tiles) with a head and a
    tail of thousands of blocks; one of 10,001 (past 48 KB of shared memory: opted in)."""
    symr, symi, pr, pi = _pilot_rows(dev, rows, 1024 + 32 * npil, 1024, 32, cpe_avg)
    args = (symr, symi, pr, pi, 1024, 32, n_head, npil - cpe_avg + 1, 32, cpe_avg, nbt)
    assert cpe_plan(rows, npil, cpe_avg).opt_in == (cpe_avg > 8156)
    a_p, b_p = cpe_coeffs_plain(*args)
    a_k, b_k = cpe_coeffs_cuda(*args)
    assert float((a_k - a_p).abs().max()) <= 1e-5
    assert float((b_k - b_p).abs().max()) <= 1e-6


@pytest.mark.parametrize("sign", [1, -1])
def test_b6_rotate(dev, sign):
    g = torch.Generator(device=dev).manual_seed(11)
    er, ei = (torch.randn(480, 2 ** 16, generator=g, device=dev) for _ in range(2))
    ph = torch.cumsum(0.01 * torch.randn(480, 2 ** 16, generator=g, device=dev), -1)
    rp, ip = rotate_plain(er, ei, ph, sign)
    rk, ik = rotate_cuda(er, ei, ph, sign)
    assert float((rk - rp).abs().max()) <= 1e-5
    assert float((ik - ip).abs().max()) <= 1e-5


def _frame_case(dev, nframes, F, ntaps, where, seed, nout=2, os_=2, pad=0, shift_ptr=0):
    """(planes, taps, offsets) of a frame launch: windows of (F - 1) os + ntaps samples.

    ``where``: "near", the first two output modes' windows 28 samples apart (staged as one
    union); "apart", more than a window apart (two stagings); "ends", frames clamped at both
    ends of the capture, as the pilot chain clamps them. ``pad``: samples added to the
    capture, so that L % 4 != 0; ``shift_ptr``: floats by which the planes' storage starts
    past an aligned allocation. Either makes the rows unfit for bulk copies, so every thread
    stages its share.
    """
    g = torch.Generator(device=dev).manual_seed(seed)
    fr_len = (F - 1) * os_ + ntaps
    L = os_ * F * (nframes + 3) + pad
    P = torch.randn(4 * L + shift_ptr, generator=g, device=dev)[shift_ptr:].view(4, L)
    w = torch.complex(torch.randn(nout, 2, ntaps, generator=g, device=dev),
                      torch.randn(nout, 2, ntaps, generator=g, device=dev)) / 8
    bases = torch.arange(nframes, device=dev) * os_ * F
    shift = {"near": [35, 7, 21, 50], "apart": [3, fr_len + 5, 2 * fr_len + 9, 11],
             "ends": [-40, 4 * os_ * F + 40, 0, 4 * os_ * F + 40]}[where]
    offs = (bases[None] + torch.tensor(shift[:nout], device=dev)[:, None]).clamp(0, L - fr_len)
    return P, w, offs.contiguous()


def _frames_agree(P, os_, w, offs, F):
    ref = apply_filter_frames_plain(P, os_, w, offs, F)
    got = apply_filter_frames_cuda(P, os_, w, offs, F)
    assert got.shape == ref.shape == (2, w.shape[0], offs.shape[1], F)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.pow(2).mean().sqrt())
    return got


@pytest.mark.parametrize("where", ["near", "apart", "ends"])
@pytest.mark.parametrize("ntaps", [17, 45])
def test_b2_frame_entry(dev, ntaps, where):
    P, w, offs = _frame_case(dev, 6, 2 ** 14, ntaps, where, ntaps)
    if where == "ends":
        assert int(offs.min()) == 0 and int(offs.max()) == P.shape[-1] - ((2 ** 14 - 1) * 2 + ntaps)
    got = _frames_agree(P, 2, w, offs, 2 ** 14)
    assert torch.equal(got, apply_filter_frames_cuda(P, 2, w, offs, 2 ** 14))


@pytest.mark.parametrize("where", ["near", "apart", "ends"])
@pytest.mark.parametrize("pad, shift_ptr", [(1, 0), (3, 0), (0, 1)])
def test_b2_frame_entry_unaligned_rows(dev, where, pad, shift_ptr):
    """Rows of L % 4 != 0 samples or planes not 16-byte aligned: each thread stages its share
    of one window, of two or of their union, zeros past both ends."""
    P, w, offs = _frame_case(dev, 6, 2 ** 12, 45, where, 5 + pad, pad=pad, shift_ptr=shift_ptr)
    assert P.is_contiguous() and (P.shape[-1] % 4 or P.data_ptr() % 16)
    got = _frames_agree(P, 2, w, offs, 2 ** 12)
    assert torch.equal(got, apply_filter_frames_cuda(P, 2, w, offs, 2 ** 12))


@pytest.mark.parametrize("os_, nout, where, F, pilots", [
    (2, 2, "near", 2 ** 14, (512, 32, 496)), (2, 2, "apart", 2 ** 14, (0, 1, 2 ** 14)),
    (2, 3, "ends", 2 ** 12, (100, 8, 487)), (3, 2, "near", 3000, (7, 5, 598)),
    (2, 1, "near", 2 ** 12, (4000, 100, 1))])
def test_b2_frame_entry_pilot_side_output(dev, os_, nout, where, F, pilots):
    """With the pilot side output the main output is the entry's without it, bit for bit, and
    the side output is the main output's columns poff + p pstride, bit for bit."""
    P, w, offs = _frame_case(dev, 6, F, 17, where, 3, nout=nout, os_=os_)
    poff, pstride, npil = pilots
    got, side = apply_filter_frames_cuda(P, os_, w, offs, F, pilots)
    assert torch.equal(got, apply_filter_frames_cuda(P, os_, w, offs, F))
    assert side.shape == (2, nout, 6, npil)
    assert torch.equal(side, got[..., poff::pstride][..., :npil])
    _, side_p = apply_filter_frames_plain(P, os_, w, offs, F, pilots)
    assert float((side - side_p).abs().max()) <= 1e-5 * float(side_p.pow(2).mean().sqrt())


@pytest.mark.parametrize("pilots", [(0, 1, 2 ** 13), (9, 2, 4000), (5, 7, 1000)])
def test_b2_frame_entry_side_output_of_dense_pilots(dev, pilots):
    """One input mode at os 1, pilots at strides 1, 2 and 7: a thread's run holds several
    pilots (every output at stride 1); the side output bit-equal to the main output's
    columns."""
    g = torch.Generator(device=dev).manual_seed(17)
    F, nframes = 2 ** 13, 5
    P = torch.randn(2, F * (nframes + 2), generator=g, device=dev)
    w = torch.complex(torch.randn(2, 1, 45, generator=g, device=dev),
                      torch.randn(2, 1, 45, generator=g, device=dev)) / 8
    offs = (torch.arange(nframes, device=dev) * F)[None].repeat(2, 1)
    offs[1] += 3
    poff, pstride, npil = pilots
    got, side = apply_filter_frames_cuda(P, 1, w, offs.contiguous(), F, pilots)
    assert torch.equal(got, apply_filter_frames_cuda(P, 1, w, offs.contiguous(), F))
    assert torch.equal(side, got[..., poff::pstride][..., :npil])


@pytest.mark.parametrize("nframes", [1, 8, 240])
def test_b2_frame_counts(dev, nframes):
    """One frame (the smallest grid: runs of 2), the return_phase chain's 8, the dispatch's
    240 (frames of 2^12, 45 taps)."""
    P, w, offs = _frame_case(dev, nframes, 2 ** 12, 45, "near", nframes)
    _frames_agree(P, 2, w, offs, 2 ** 12)


@pytest.mark.parametrize("os_, nout", [(1, 2), (3, 2), (2, 1), (2, 3), (2, 4), (6, 2), (6, 3),
                                       (30, 2)])
def test_b2_frame_generic_instances(dev, os_, nout):
    """The generic instance (os 1, 3, 6 and 30), one output mode (no union), three and four
    output modes (groups of two, the last of one), os = 6 (runs of 6: runs of 10 would not fit
    the shared memory) and os = 30 (groups of one: two fit at no run)."""
    P, w, offs = _frame_case(dev, 5, 3000, 17, "near", 7, nout=nout, os_=os_)
    plan = filter_plan(2, nout, 17, os_, 3000, 5)
    assert plan.threads == 128 * (1 if nout == 1 or os_ == 30 else 2)
    got = _frames_agree(P, os_, w, offs, 3000)
    assert torch.equal(got, apply_filter_frames_cuda(P, os_, w, offs, 3000))


def test_b2_frame_run_shrinks_to_fit(dev):
    """os = 6 over 240 frames: the grid would take runs of 10, whose CTA needs 247 KB; the
    plan takes runs of 6."""
    plan = filter_plan(2, 2, 45, 6, 2 ** 12, 240)
    assert plan.run == 6 and plan.threads == 256
    P, w, offs = _frame_case(dev, 240, 2 ** 12, 45, "near", 13, os_=6)
    _frames_agree(P, 6, w, offs, 2 ** 12)


def test_b2_frame_grid_past_the_old_row_limit(dev):
    """2 x 40,000 (mode, frame) rows: the old grid refused more than 65,535."""
    P, w, offs = _frame_case(dev, 40000, 64, 5, "near", 11)
    assert offs.numel() > 65535
    _frames_agree(P, 2, w, offs, 64)


@pytest.mark.parametrize("args", [(2, 2, 17, 2, 2 ** 20 - 8, 0), (2, 2, 17, 2, 2 ** 18 - 8, 0),
                                  (2, 2, 45, 2, 2 ** 16, 240), (2, 2, 45, 2, 2 ** 16, 8),
                                  (2, 2, 45, 2, 2 ** 12, 1), (1, 1, 63, 3, 21843, 0),
                                  (2, 1, 2, 1, 100, 0), (2, 2, 5, 2, 64, 40000),
                                  (2, 3, 17, 2, 3000, 5), (2, 2, 17, 6, 3000, 5),
                                  (2, 2, 17, 30, 3000, 5), (2, 2, 45, 6, 2 ** 16, 240),
                                  (2, 2, 17, 6, 2 ** 16 - 5, 0)])
def test_b2_plan_equals_the_library(dev, args):
    import ctypes
    from qampy_tpu_torch.ops import _build
    built = (ctypes.c_longlong * len(filter_plan(*args)))()
    _build.library().qtt_filter_plan(*args, ctypes.addressof(built))
    assert tuple(built) == filter_plan(*args)


@pytest.mark.parametrize("return_phase", [False, True])
def test_pilot_chain_launches_and_gate(dev, return_phase):
    tx = make_pilot_tx(6, frame_len=2 ** 14, seq_len=512, device=dev)
    chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, 2 ** 14, 32, os=2, nmodes=2,
                                Ntaps=17, cpe_avg=3, frames=(0, 1, 2), block_size=256,
                                return_phase=return_phase, eq_trainer="ls", device=dev)
    counters = (train_block_cuda, apply_filter_cuda, bps_search_cuda, interp_rotate_cuda,
                apply_filter_frames_cuda, cpe_coeffs_cuda, rotate_cuda, unwrap_slopes_cuda)
    for fn in counters:
        fn.launches = 0
    (dr, di), info = chain.planes(tx.planes[:2], tx.planes[2:])
    want = [0, 0, 0, 0, 1, 0, 1, 0] if return_phase else [0, 0, 0, 1, 1, 1, 0, 0]
    assert [fn.launches for fn in counters] == want
    assert ber_gate(dr, di, tx, info["sync_corr"])["ok"]
    (tr, ti), _ = chain.tracking_planes(tx.planes[:2], tx.planes[2:], info["taps"],
                                        info["shift"], info["mode_order"])
    assert torch.equal(tr, dr) and torch.equal(ti, di)


def test_pilot_chain_of_more_than_4096_cpe_pilots(dev):
    """Frames of 2^16 symbols at pilot ratio 8 (8,064 CPE pilots), which the card refused
    before B5 took any pilot count: launches, tracking, and the plain CPU chain on the same
    capture. On this capture the frame sync fails in both chains and in the JAX reference's
    alike (sync_corr 72.67 < 120, BER 0.25; ROADMAP queue C, C5), so the BER gate's outcome
    is held equal between the card and the CPU, not required to pass."""
    tx = make_pilot_tx(6, frame_len=2 ** 16, ins_rat=8, device=dev)
    cfg = dict(os=2, nmodes=2, sync_Ntaps=17, sync_mu=5e-3, sync_Niter=10, Ntaps=45,
               cpe_avg=3, frames=(0, 1, 2), block_size=256, return_phase=False,
               eq_trainer="ls")
    chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, 2 ** 16, 8, **cfg, device=dev)
    assert chain.nblk == 8064 and chain.kernel_interp
    counters = (apply_filter_frames_cuda, cpe_coeffs_cuda, interp_rotate_cuda, rotate_cuda)
    for fn in counters:
        fn.launches = 0
    (dr, di), info = chain.planes(tx.planes[:2], tx.planes[2:])
    assert [fn.launches for fn in counters] == [1, 1, 1, 0]
    (tr, ti), _ = chain.tracking_planes(tx.planes[:2], tx.planes[2:], info["taps"],
                                        info["shift"], info["mode_order"])
    assert torch.equal(tr, dr) and torch.equal(ti, di)
    cpu = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, 2 ** 16, 8, **cfg, device="cpu")
    (cr, ci), cinfo = cpu.planes(tx.planes[:2].cpu(), tx.planes[2:].cpu())
    assert cinfo["shift"].tolist() == info["shift"].tolist()
    assert cinfo["mode_order"].tolist() == info["mode_order"].tolist()
    assert float(cinfo["sync_corr"]) == pytest.approx(float(info["sync_corr"]), rel=1e-4)
    gate = ber_gate(dr, di, tx, info["sync_corr"])
    assert gate["ok"] == ber_gate(cr.to(dev), ci.to(dev), tx, cinfo["sync_corr"])["ok"]
    got, want = torch.complex(dr, di).cpu(), torch.complex(cr, ci)
    assert float((decide(got, tx.coded) == decide(want, tx.coded)).double().mean()) >= 0.999


@pytest.mark.parametrize("ntaps", [17, 45])
@pytest.mark.parametrize("method", ["cma", "mcma", "sbd"])
def test_b1_batch_rows_equal_their_own_launches(dev, method, ntaps):
    """B1 with a batch axis (the LMS pilot trainer's launch): each row, with its own segment and
    taps, bit-equal to a launch of that row alone, and within float32 reach of the plain
    trainer's batch."""
    rng = np.random.default_rng(ntaps)
    L = {17: 2067, 45: 2096}[ntaps]      # rows by 4-byte copies, and 16-byte aligned bulk copies
    P = torch.as_tensor(rng.standard_normal((3, 4, L)).astype(np.float32) * 0.7, device=dev)
    w = torch.as_tensor(np.stack([teq._init_taps(ntaps, 2, 2, np.complex64)[i:i + 1]
                                  for i in (0, 1, 0)]), device=dev)
    syms = teq._reshape_symbols(None, method, 4 if method == "cma" else 64, np.complex64, 1)
    spec = teq.err_spec(method, syms)
    trs = teq._cal_training_symbol_len(2, ntaps, L)
    args = (trs, 3, 2, 1e-3, w, spec, True, 128)
    got = train_block_cuda(P, *args)
    assert got[0].shape == (3, 1, 3 * (trs // 128) * 128) and got[1].shape == (3, 1, 2, ntaps)
    for r in range(3):
        one = train_block_cuda(P[r], *args[:4], w[r], *args[5:])
        assert all(torch.equal(x, y[r]) for x, y in zip(one, got))
    want = train_block_plain(P, *args)
    assert float((got[1] - want[1]).abs().max()) <= 1e-4
    shared = train_block_cuda(P, *args[:4], w[0], *args[5:])    # taps shared by the rows
    assert torch.equal(shared[1][0], got[1][0]) and torch.equal(shared[1][2], got[1][2])


def _small_pilot(freq_off=None, seed=3):
    return make_pilot_tx(6, frame_len=2 ** 14, seq_len=512, freq_off=freq_off, seed=seed,
                         device="cpu")


@pytest.mark.parametrize("variant", ["lms", "foe", "non_blocked", "xla_body"])
def test_pilot_chain_variants_against_the_cpu(dev, variant):
    """The LMS, FOE and general-body chains on the card against the port's plain CPU chain on one
    small capture: launches, shift and mode order equal, decisions shared >= 0.999, tracking
    bit-exact."""
    base = dict(os=2, nmodes=2, Ntaps=17, sync_mu=5e-3, cpe_avg=3, frames=(0, 1, 2),
                block_size=256, return_phase=False, eq_trainer="lms")
    kw, tx, want = {
        "lms": (dict(), _small_pilot(), {"B1": 3, "B2 frames": 1, "B5": 1, "B4": 1}),
        "foe": (dict(foe_comp=True), _small_pilot(20e6, seed=1),
                {"B1": 3, "B2 frames": 1, "B5": 1, "B4": 1}),
        "non_blocked": (dict(cpe_pilot_rat=2), _small_pilot(), {"B1": 3, "B2 frames": 1, "B6": 1}),
        "xla_body": (dict(pallas=False, return_phase=True), _small_pilot(),
                     {"B1": 3, "B2 frames": 1, "B6": 1}),
    }[variant]
    cfg = dict(base, **kw)
    counters = {"B1": train_block_cuda, "B2 frames": apply_filter_frames_cuda,
                "B5": cpe_coeffs_cuda, "B4": interp_rotate_cuda, "B6": rotate_cuda,
                "B2": apply_filter_cuda}
    chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, 2 ** 14, 32, **cfg, device=dev)
    pr, pi = tx.planes[:2].to(dev), tx.planes[2:].to(dev)
    for fn in counters.values():
        fn.launches = 0
    (dr, di), info = chain.planes(pr, pi)
    assert {k: fn.launches for k, fn in counters.items()} == {k: want.get(k, 0) for k in counters}
    assert ber_gate(dr.cpu(), di.cpu(), tx, info["sync_corr"])["ok"]
    foe = info["foe_pil"] if cfg.get("foe_comp") else None
    (tr, ti), _ = chain.tracking_planes(pr, pi, info["taps"], info["shift"], info["mode_order"],
                                        foe=foe)
    assert torch.equal(tr, dr) and torch.equal(ti, di)
    cpu = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, 2 ** 14, 32, **cfg, device="cpu")
    (cr, ci), cinfo = cpu.planes(tx.planes[:2], tx.planes[2:])
    assert cinfo["shift"].tolist() == info["shift"].tolist()
    assert cinfo["mode_order"].tolist() == info["mode_order"].tolist()
    assert abs(float(cinfo["foe_pil"]) - float(info["foe_pil"])) <= 1e-6
    got, ref = torch.complex(dr, di).cpu(), torch.complex(cr, ci)
    assert float((decide(got, tx.coded) == decide(ref, tx.coded)).double().mean()) >= 0.999


def test_frame_sync_against_the_cpu(dev):
    """``ops.pilots.frame_sync``: B9 once a window on the card; the plain CPU search's shift, mode
    order, flag and coarse FOE, and its taps within 1e-5."""
    from qampy_tpu_torch.ops import pilots
    tx = _small_pilot()
    E = torch.complex(tx.planes[:2], tx.planes[2:])
    train_seq_cuda.launches = 0
    g = pilots.frame_sync(E.to(dev), tx.pilot_seq, 2, frame_len=2 ** 14, device=dev)
    assert train_seq_cuda.launches == 63
    c = pilots.frame_sync(E, tx.pilot_seq, 2, frame_len=2 ** 14, device="cpu")
    assert np.array_equal(g[0], c[0]) and np.array_equal(g[2], c[2]) and g[4] == c[4] is True
    assert np.array_equal(g[1], c[1])
    assert np.abs(g[3] - c[3]).max() <= 1e-5


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("method", ["cma", "mcma", "rde"])
def test_b9_train_seq(dev, capture, method, adaptive):
    P = capture[3]
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    syms = teq._reshape_symbols(None, method, 64, np.complex64, 2)
    e_p, w_p, mu_p = train_seq_plain(P, 2048, 1, 2, 1e-3, w0, syms, method, adaptive)
    e_k, w_k, mu_k = train_seq_cuda(P, 2048, 1, 2, 1e-3, w0, syms, method, adaptive)
    assert e_k.shape == e_p.shape == (2, 2048) and w_k.shape == (2, 2, 17)
    # the same roundings but for the order of z's sum; a contracting recurrence
    assert float((w_k - w_p).abs().max()) <= 1e-5
    torch.testing.assert_close(mu_k, mu_p, rtol=1e-4, atol=0)
    assert float((e_k - e_p).abs().max()) <= 1e-4


@pytest.mark.parametrize("nmodes, ntaps, trs, niter", [(1, 11, 1500, 2), (2, 33, 1100, 1),
                                                       (2, 17, 300, 3)])
def test_b9_passes_chunks_and_widths(dev, capture, nmodes, ntaps, trs, niter):
    """Passes that end inside a chunk of 1024 symbols; one, two and three taps per lane."""
    P = capture[3]
    P = torch.cat([P[:nmodes], P[2:2 + nmodes]]).contiguous()
    w0 = torch.as_tensor(teq._init_taps(ntaps, nmodes, nmodes, np.complex64), device=dev)
    syms = teq._reshape_symbols(None, "mcma", 64, np.complex64, nmodes)
    e_p, w_p, mu_p = train_seq_plain(P, trs, niter, 2, 1e-3, w0, syms, "mcma", True)
    e_k, w_k, mu_k = train_seq_cuda(P, trs, niter, 2, 1e-3, w0, syms, "mcma", True)
    assert e_k.shape == (nmodes, niter * trs)
    assert float((w_k - w_p).abs().max()) <= 1e-5
    torch.testing.assert_close(mu_k, mu_p, rtol=1e-4, atol=0)
    assert float((e_k - e_p).abs().max()) <= 1e-4


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("method", ["cma", "mcma", "rde"])
@pytest.mark.parametrize("os_", [1, 2])
@pytest.mark.parametrize("nmodes, ntaps", [(1, 17), (2, 17), (2, 45), (2, 64)],
                         ids=["K=17", "K=34", "K=90", "K=128"])
def test_b9_instances(dev, capture, nmodes, ntaps, os_, method, adaptive):
    """Every instance the launcher can pick: 1-4 taps per lane x method x adaptive, os 1 and 2;
    600 symbols, so the buffered error trace ends inside a group of 32."""
    P = _sub(capture[3], nmodes)
    w0 = torch.as_tensor(teq._init_taps(ntaps, nmodes, nmodes, np.complex64), device=dev)
    syms = teq._reshape_symbols(None, method, 64, np.complex64, nmodes)
    args = (P, 600, 1, os_, 1e-3, w0, syms, method, adaptive)
    e_p, w_p, mu_p = train_seq_plain(*args)
    got = train_seq_cuda(*args)
    assert got[0].shape == (nmodes, 600)
    assert float((got[1] - w_p).abs().max()) <= 1e-5
    torch.testing.assert_close(got[2], mu_p, rtol=1e-4, atol=0)
    assert float((got[0] - e_p).abs().max()) <= 1e-4
    assert _same(got, train_seq_cuda(*args))


def test_b9_rde_longest_row(dev, capture):
    """The longest codebook row the kernel holds: 128-QAM's 17 codes and 16 boundaries, one
    of each per lane. 256-QAM's row (34 + 33 entries) is refused by the launcher."""
    P = capture[3]
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    syms = teq._reshape_symbols(None, "rde", 128, np.complex64, 2)
    assert syms.shape[-1] == 33
    args = (P, 1000, 1, 2, 1e-3, w0, syms, "rde", True)
    e_p, w_p, mu_p = train_seq_plain(*args)
    e_k, w_k, mu_k = train_seq_cuda(*args)
    assert float((w_k - w_p).abs().max()) <= 1e-5
    torch.testing.assert_close(mu_k, mu_p, rtol=1e-4, atol=0)
    assert float((e_k - e_p).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match=r"hold 64 \(_MAX_CODES\)"):
        train_seq_cuda(P, 1000, 1, 2, 1e-3, w0,
                       teq._reshape_symbols(None, "rde", 256, np.complex64, 2), "rde", True)


def test_b9_three_passes_across_chunk_ends(dev, capture):
    """1100 symbols are a chunk of 1024 and one of 76; three passes reuse both buffers."""
    P = capture[3]
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    syms = teq._reshape_symbols(None, "mcma", 64, np.complex64, 2)
    args = (P, 1100, 3, 2, 1e-3, w0, syms, "mcma", True)
    e_p, w_p, mu_p = train_seq_plain(*args)
    got = train_seq_cuda(*args)
    assert got[0].shape == (2, 3300)
    assert float((got[1] - w_p).abs().max()) <= 1e-5
    torch.testing.assert_close(got[2], mu_p, rtol=1e-4, atol=0)
    assert float((got[0] - e_p).abs().max()) <= 1e-4
    assert _same(got, train_seq_cuda(*args))


def test_b9_division_and_probe(dev):
    """B9's straight-line division is __fdiv_rn's on normal operands; the probe reads the card."""
    g = torch.Generator(device=dev).manual_seed(2)
    n = 2 ** 20
    assert div_check(torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-7,
                     1 + torch.rand(n, generator=g, device=dev)) == 0
    assert div_check(torch.randn(n, generator=g, device=dev),
                     torch.randn(n, generator=g, device=dev) + 3) == 0
    lat = chain_latencies(dev, 288)
    assert 2 < lat["fadd"] < 12 and lat["shuffle_add"] > lat["fadd"]
    assert lat["lookup_add"] > lat["shuffle_add"] and lat["barrier"] > lat["fadd"]
    assert 0.5 < lat["ghz"] < 3


def test_b9_checks_inputs(dev, capture):
    P = capture[3]
    syms = teq._reshape_symbols(None, "cma", 64, np.complex64, 2)
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    wide = torch.as_tensor(teq._init_taps(65, 2, 2, np.complex64), device=dev)
    with pytest.raises(ValueError, match="taps per output mode"):
        train_seq_cuda(P, 256, 1, 2, 1e-3, wide, syms, "cma")
    with pytest.raises(NotImplementedError, match="takes"):
        train_seq_cuda(P, 256, 1, 2, 1e-3, w0, syms, "mddma")
    with pytest.raises(ValueError, match="shorter"):
        train_seq_cuda(P, 2 ** 15, 1, 2, 1e-3, w0, syms, "cma")
    with pytest.raises(TypeError):
        train_seq_cuda(P.double(), 256, 1, 2, 1e-3, w0, syms, "cma")


@pytest.mark.parametrize("method", ["cma", "sgncma", "rde", "sbd", "dd"])
def test_b1_square_grid_methods(dev, capture, method):
    P = capture[3]
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    _, w1, _ = train_block_cuda(P, 2 ** 14, 1, 2, 1.9e-3, w0, _specs(2)["mcma"], True, 256)
    spec = teq.err_spec(method, teq._reshape_symbols(None, method, 64, np.complex64, 2))
    start = w0 if method in ("cma", "sgncma") else w1
    # rde's ring decision makes the recurrence expand a rounding difference until a
    # sample changes ring (two plain runs 2e-7 apart part after 10-20 blocks): 8 blocks
    trs = 2 ** 11 if method == "rde" else 2 ** 14
    e_p, w_p, mu_p = train_block_plain(P, trs, 1, 2, 1.9e-3, start, spec, True, 256)
    e_k, w_k, mu_k = train_block_cuda(P, trs, 1, 2, 1.9e-3, start, spec, True, 256)
    assert float((w_k - w_p).abs().max()) <= 1e-4
    torch.testing.assert_close(mu_k, mu_p, rtol=1e-5, atol=0)
    assert float((e_k - e_p).abs().max()) <= 1e-4


def test_equaliser_entry_points_run_on_the_card_by_default(dev, capture):
    E, syms, const, _ = capture
    counters = (train_block_cuda, train_seq_cuda, apply_filter_cuda)
    want = {"cuda": [0, 2, 1], "cuda_block": [2, 0, 1], "auto": [2, 0, 1]}
    for backend, launches in want.items():
        for fn in counters:
            fn.launches = 0
        out, w, (e1, e2) = teq.dual_mode_equalisation(
            E, 2, (1e-3, 1e-3), 64, Ntaps=17, methods=("mcma", "rde"),
            adaptive_stepsize=(True, True), backend=backend)
        assert out.is_cuda and w.is_cuda and e1.is_cuda
        assert [fn.launches for fn in counters] == launches
        chain = make_rx_chain(bps_mode="single", bps_N=14)
        eqp = teq.planes(out).contiguous()
        outr, outi = chain.unwrap_derotate(eqp, chain.carrier_phase(eqp))
        ser = ser_gate(torch.complex(outr, outi), torch.as_tensor(syms, device=dev), const)
        assert ser <= 1e-4
    # a plain backend on the card takes every method
    w, err = teq.equalise_signal(E, 2, 1e-3, 64, Ntaps=17, method="mrde", backend="block",
                                 TrSyms=4096)
    assert w.is_cuda and err.shape == (2, 4096) and bool(torch.isfinite(w.abs()).all())
    with pytest.raises(NotImplementedError, match="trains the complex methods"):
        teq.equalise_signal(E, 2, 1e-3, 64, Ntaps=17, method="mrde", backend="cuda_block")


# ---------------------------------------------------------------------------
# constellations that are not a square grid: the decisions of B1, B3 and B8
# ---------------------------------------------------------------------------

def _alphabet(key):
    """(constellation, make_tx arguments, make_rx_chain arguments) of a grid test's alphabet."""
    if key in ("x32", "x128"):
        M = int(key[1:])
        c = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
        return c, dict(M=M), dict(M=M)
    if key == "r":
        re, im = np.meshgrid(0.5 * (np.arange(8) - 3.5), 0.5 * (np.arange(4) - 1.5),
                             indexing="ij")
        c = (re + 1j * im).astype(np.complex64).reshape(-1)
    else:
        c = {"w64": warped_qam(64), "w256": warped_qam(256), "apsk": apsk_const(32)}[key]
    return c, dict(const=c), dict(symbols=c)


GRID_KEYS = ["r", "x32", "x128", "w64", "apsk", "w256"]
GRID_KINDS = {"r": "r", "x32": "x", "x128": "x", "w64": "gen", "apsk": "gen", "w256": "gen"}


def _alphabet_planes(dev, const, seed, L=2 ** 16):
    """Planes of ``const`` on the card with a random-walk carrier phase and noise: (er, ei)."""
    rng = np.random.default_rng(seed)
    z = const[rng.integers(0, const.size, (2, L))] * np.exp(
        1j * np.cumsum(rng.normal(scale=0.01, size=(2, L)), -1))
    z = z + 0.045 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
    return (torch.as_tensor(z.real.astype(np.float32), device=dev),
            torch.as_tensor(z.imag.astype(np.float32), device=dev))


def _tie_rule(grid):
    """Near-tie band and allowed share: a general alphabet's scores carry -|z|^2 (chip_smoke)."""
    return (1e-6, 2e-2) if tph.grid_decision_info(grid)[0] == "gen" else (1e-5, 1e-3)


@pytest.mark.parametrize("A, N", [(64, 14), (16, 60)])
@pytest.mark.parametrize("key", GRID_KEYS)
def test_b3_grid_kinds(dev, key, A, N):
    const = _alphabet(key)[0]
    grid = tph.detect_grid(const)
    assert tph.grid_decision_info(grid)[0] == GRID_KINDS[key]
    er, ei = _alphabet_planes(dev, const, A + N)
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    ref = bps_search_plain(er, ei, cos_t, sin_t, grid, N)
    got = bps_search_cuda(er, ei, cos_t, sin_t, grid, N)
    rel, share = _tie_rule(grid)
    ties = tph.bps_near_ties(er, ei, cos_t, sin_t, grid, N, rel)
    assert not bool(((got != ref) & ~ties).any())
    assert float(ties.double().mean()) <= share
    assert len(torch.unique(got)) > 1
    # the table handed in from the card is the one copied from the host
    pts = tph.points_tensor(grid, dev)
    assert torch.equal(bps_search_cuda(er, ei, cos_t, sin_t, grid, N, pts), got)


@pytest.mark.parametrize("key", GRID_KEYS)
def test_b8_grid_kinds(dev, key):
    const = _alphabet(key)[0]
    grid = tph.detect_grid(const)
    er, ei = _alphabet_planes(dev, const, 21)
    ang = np.linspace(-np.pi / 4, np.pi / 4, 16, endpoint=False, dtype=np.float32)
    cos1, sin1 = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    ph1 = -np.pi / 4 + np.pi / 32 * bps_search_cuda(er, ei, cos1, sin1, grid, 60).float()
    cd, sd, d0f, ddf = tph.fine_tables(16, 8, grid)
    cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
    ref = bps_fine_plain(er, ei, ph1, cd, sd, grid, 14, d0f, ddf)
    got = bps_fine_cuda(er, ei, ph1, cd, sd, grid, 14, d0f, ddf)
    rel, share = _tie_rule(grid)
    ties = tph.bps_fine_near_ties(er, ei, ph1, cd, sd, grid, 14, rel)
    assert not bool(((got != ref) & ~ties).any())
    assert float(ties.double().mean()) <= share


def test_b3_b8_refuse_a_wrong_table(dev):
    grid = tph.detect_grid(warped_qam(64))
    er, ei = _alphabet_planes(dev, warped_qam(64), 2, L=4096)
    ang = np.linspace(-np.pi / 4, np.pi / 4, 16, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    with pytest.raises(ValueError, match="gen table"):
        bps_search_cuda(er, ei, cos_t, sin_t, grid, 14, torch.zeros(32, 3, device=dev))
    with pytest.raises(ValueError, match="gen table"):
        bps_search_cuda(er, ei, cos_t, sin_t, grid, 14, torch.zeros(64, 3))


# B8 (B3's runs of sliding window sums over a per-sample angle) on every
# grid kind, at B in {3, 8} and N in {1, 14, 60}, on rows that are not a multiple of a tile
@pytest.mark.parametrize("N", [1, 14, 60])
@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("key", ["sq"] + GRID_KEYS)
def test_b8_offsets_windows_and_kinds(dev, key, B, N):
    L = 2 ** 16 + 37
    if key == "sq":
        grid, er, ei = _qam_planes(dev, 31 + B + N, L)
    else:
        grid = tph.detect_grid(_alphabet(key)[0])
        er, ei = _alphabet_planes(dev, _alphabet(key)[0], 31 + B + N, L)
    ang = np.linspace(-np.pi / 4, np.pi / 4, 16, endpoint=False, dtype=np.float32)
    cos1, sin1 = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    ph1 = -np.pi / 4 + np.pi / 32 * bps_search_cuda(er, ei, cos1, sin1, grid, 60).float()
    cd, sd, d0f, ddf = tph.fine_tables(16, B, grid)
    cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
    args = (er, ei, ph1, cd, sd, grid, N, d0f, ddf)
    got = bps_fine_cuda(*args)
    assert fine_plan(2, L, N, len(grid[1]) if GRID_KINDS.get(key) == "gen" else 0).run == 4
    assert torch.equal(got, bps_fine_cuda(*args))
    rel, share = _tie_rule(grid)
    ties = tph.bps_fine_near_ties(*args[:7], rel)
    assert not bool(((got != bps_fine_plain(*args)) & ~ties).any())
    assert float(ties.double().mean()) <= share


@pytest.mark.parametrize("B, N, L", [(1, 3700, 12000), (3, 3700, 12000), (8, 5000, 14000),
                                     (1, 28000, 58000)])
def test_b8_windows_of_thousands(dev, B, N, L):
    """Half-windows past what slots of 4 offsets fit take slots of one (fine_plan), up to the
    longest window the first design took (B = 1, N = 28,000)."""
    grid, er, ei = _qam_planes(dev, N, L)
    er, ei = er[:1].contiguous(), ei[:1].contiguous()
    ph1 = torch.zeros_like(er)
    cd, sd, d0f, ddf = tph.fine_tables(16, B, grid)
    cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
    args = (er, ei, ph1, cd, sd, grid, N, d0f, ddf)
    assert fine_plan(1, L, N).chunk == 1
    got = bps_fine_cuda(*args)
    assert torch.equal(got, bps_fine_cuda(*args))
    if B == 1:     # one offset: the phase is ph1 + d0f everywhere
        assert torch.equal(got, bps_fine_plain(*args))
        return
    ties = tph.bps_fine_near_ties(*args[:7])
    assert not bool(((got != bps_fine_plain(*args)) & ~ties).any())


def _unwrap_case(dev, rows, L, seed, offs=(0, 0, 0)):
    """(er, ei, ph) with jumps on every tile edge, a drift that takes |M| into the thousands,
    each plane placed ``offs`` floats into a buffer of its own (storage not 16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    i = torch.arange(L, device=dev)
    step = 0.3 * torch.randn(rows, L, generator=g, device=dev) + 0.01
    edge = ((i % 2048) <= 1) | ((i % 2048) >= 2045)
    step = torch.where(edge, step + 1.3, step)
    theta = torch.cumsum(step, -1)
    ph = torch.remainder(theta + np.pi / 4, np.pi / 2) - np.pi / 4
    planes = (torch.randn(rows, L, generator=g, device=dev),
              torch.randn(rows, L, generator=g, device=dev), ph)
    out = []
    for x, o in zip(planes, offs):
        buf = torch.empty(rows * L + 4, device=dev)
        v = buf[o:o + rows * L].view(rows, L)
        v.copy_(x)
        out.append(v)
    return out


@pytest.mark.parametrize("L", [1, 2047, 2048, 2049, 2 ** 20])
@pytest.mark.parametrize("rows", [1, 2, 5])
def test_b7_equals_b6_on_the_plain_unwrap(dev, rows, L):
    """B7 (one pass, decoupled look-back) equals B6 rotating by quarter_unwrap(ph) bit for bit,
    at every alignment of the planes, shared or not; two launches are bit-equal."""
    for offs in ((0, 0, 0), (1, 1, 1), (3, 3, 3), (2, 0, 1)):
        er, ei, ph = _unwrap_case(dev, rows, L, rows * L + sum(offs), offs)
        u = quarter_unwrap(ph)
        want = rotate_cuda(er, ei, u, 1)
        got = unwrap_derotate_cuda(er, ei, ph)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), offs
        again = unwrap_derotate_cuda(er, ei, ph)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if L == 2 ** 20:
        assert float((ph - u).abs().max()) > 1000 * np.pi / 2     # |M| in the thousands


# B3's tiles, runs and angle chunks at the edges that a tile of one position per thread
# never met: (alphabet, modes, L, A, N)
B3_EDGES = {
    "L not a multiple of the tile": ("sq", 2, 2 ** 16 + 37, 64, 12),
    "L shorter than a tile": ("sq", 1, 100, 16, 14),
    "L = 2N: all zeros": ("sq", 2, 28, 64, 14),
    "L < 2N: all zeros": ("sq", 2, 17, 8, 14),
    "N = 0": ("sq", 2, 3000, 16, 0),
    "tile boundaries at N and L - N": ("sq", 1, 5120, 16, 128),
    "run boundaries at N and L - N": ("sq", 2, 2 ** 18, 16, 16),
    "A = 256, N = 60": ("sq", 2, 2 ** 14, 256, 60),
    "A = 256, N = 60, full-rate runs": ("sq", 2, 2 ** 18, 256, 60),
    "A = 61, not a multiple of the chunk": ("sq", 2, 2 ** 18, 61, 14),
    "A = 3, less than a chunk": ("sq", 2, 5000, 3, 14),
    "A = 1": ("sq", 2, 5000, 1, 14),
    **{"full-rate runs, grid %s" % k: (k, 2, 2 ** 18, 64, 14) for k in GRID_KEYS},
    "decimated runs, grid w64": ("w64", 2, 2 ** 16, 64, 12),
}


@pytest.mark.parametrize("case", list(B3_EDGES))
def test_b3_tiles_runs_and_chunks(dev, case):
    """B3 equals, bit for bit, a float32 model of its own summation order (run-reseeded
    sliding window sums) and its plain version off near-ties; two launches are bit-equal."""
    key, nmodes, L, A, N = B3_EDGES[case]
    if key == "sq":
        grid, er, ei = _qam_planes(dev, L + A, L)
    else:
        grid = tph.detect_grid(_alphabet(key)[0])
        er, ei = _alphabet_planes(dev, _alphabet(key)[0], L + A, L)
    er, ei = er[:nmodes].contiguous(), ei[:nmodes].contiguous()
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    got = bps_search_cuda(er, ei, cos_t, sin_t, grid, N)
    assert got.shape == (nmodes, L) and got.dtype == torch.int32
    npts = len(grid[1]) if tph.grid_decision_info(grid)[0] == "gen" else 0
    run = bps_plan(nmodes, L, N, npts).run
    assert torch.equal(got, kernel_order_search(er, ei, cos_t, sin_t, grid, N, run))
    assert torch.equal(got, bps_search_cuda(er, ei, cos_t, sin_t, grid, N))
    ref = bps_search_plain(er, ei, cos_t, sin_t, grid, N)
    if L <= 2 * N or N == 0 or A == 1:
        assert not bool(got.any()) and not bool(ref.any())
        return
    if er.numel() * A * 2 * N > 2 ** 31:
        return      # the near-tie mask unfolds every window in float64: 128 GB here
    rel, share = _tie_rule(grid)
    if A > 64:
        share = 1e-2    # 256 angles lie pi/512 apart: the best two windows tie more often
    ties = tph.bps_near_ties(er, ei, cos_t, sin_t, grid, N, rel)
    assert not bool(((got != ref) & ~ties).any())
    assert float(ties.double().mean()) <= share
    assert not bool(got[:, :N].any()) and not bool(got[:, L - N:].any())


@pytest.mark.parametrize("S", [64, 256])
@pytest.mark.parametrize("method", ["sbd", "mddma", "dd"])
@pytest.mark.parametrize("key", GRID_KEYS)
def test_b1_grid_decisions(dev, key, method, S):
    """8 blocks from the taps of an mcma stage: a decision is discontinuous, long runs part."""
    const, txkw, _ = _alphabet(key)
    E, _, _ = make_tx(2 ** 15, seed=5, **txkw)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    rows = np.tile(const, (2, 1))
    first = teq.err_spec("mcma", teq.generate_symbols_for_eq_from_alphabet(
        "mcma", const, np.complex64).repeat(2, axis=0))
    _, w1, _ = train_block_cuda(P, 2 ** 14, 1, 2, 1.9e-3, w0, first, True, 256)
    spec = teq.err_spec(method, rows)
    args = (P, 8 * S, 1, 2, 1.9e-3, w1, spec, True, S)
    e_p, w_p, mu_p = train_block_plain(*args)
    got = train_block_cuda(*args)
    assert float((got[1] - w_p).abs().max()) <= 1e-6
    torch.testing.assert_close(got[2], mu_p, rtol=1e-5, atol=0)
    assert float((got[0] - e_p).abs().max()) <= 1e-5
    assert _same(got, train_block_cuda(*args, tph.points_tensor(spec.consts, dev)))


@pytest.mark.parametrize("key, mode", [("x32", "single"), ("x32", "decimated16"),
                                       ("w64", "twostage"), ("w64", "single"),
                                       ("w64", "decimated16"), ("apsk", "twostage")])
def test_grid_chain_on_card(dev, key, mode):
    """A 2^16-symbol cross or general capture: launches, gate, tracking, card against CPU."""
    const, txkw, sel = _alphabet(key)
    E, syms, coded = make_tx(2 ** 16, seed=1, **txkw)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    cfg = dict(Ntaps=17, os=2, methods=("mcma", "sbd"), mu=1.9e-3, bps_angles=64,
               bps_N=12 if mode == "decimated16" else 14, block_size=256, TrSyms=2 ** 14,
               bps_mode=mode, **sel)
    counters = (train_block_cuda, apply_filter_cuda, bps_search_cuda, interp_rotate_cuda,
                bps_fine_cuda, unwrap_derotate_cuda)
    for fn in counters:
        fn.launches = 0
    chain = make_rx_chain(**cfg, device=dev)
    (outr, outi), w = chain.planes_with_taps(P)
    dec = mode == "decimated16"
    assert [fn.launches for fn in counters] == [2, 1, 1, int(dec), int(mode == "twostage"),
                                                int(not dec)]
    if chain.gen_points is not None:
        assert chain.gen_points.is_cuda
    tr, ti = chain.tracking_planes(P, w)
    assert torch.equal(tr, outr) and torch.equal(ti, outi)
    out = torch.complex(outr, outi)
    assert ser_gate(out, torch.as_tensor(syms, device=dev), coded) <= 1e-4
    ref = make_rx_chain(**cfg, device="cpu").forward(torch.as_tensor(E))[:, GATE_TRIM:-GATE_TRIM]
    assert shared_decisions(out.cpu()[:, GATE_TRIM:-GATE_TRIM], ref, coded) >= 0.999


# ---------------------------------------------------------------------------
# backend="auto" on the card, and a training cut into launches
# ---------------------------------------------------------------------------

def test_auto_trains_what_b1_refuses(dev):
    """256-QAM's rde row of 67 entries, a block of 100 and a 20-symbol training go to "block"."""
    E, _, _ = make_tx(2 ** 15, M=256, seed=5)
    counters = (train_block_cuda, train_seq_cuda, apply_filter_cuda)

    def launches(fn):
        for c in counters:
            c.launches = 0
        out = fn()
        return out, [c.launches for c in counters]
    (w, err), n = launches(lambda: teq.equalise_signal(E, 2, 1e-3, 256, Ntaps=17, method="rde",
                                                       TrSyms=4096))
    assert n == [0, 0, 0] and w.is_cuda and bool(torch.isfinite(w.abs()).all())
    w_b, err_b = teq.equalise_signal(E, 2, 1e-3, 256, Ntaps=17, method="rde", TrSyms=4096,
                                     backend="block")
    assert torch.equal(w, w_b) and torch.equal(err, err_b)
    (out, w2, errs), n = launches(lambda: teq.dual_mode_equalisation(
        E, 2, (1e-3, 1e-3), 256, Ntaps=17, methods=("mcma", "rde"), TrSyms=(2 ** 14, 4096),
        adaptive_stepsize=(True, True)))
    assert n == [1, 0, 1] and out.is_cuda and bool(torch.isfinite(out.abs()).all())
    for kw in (dict(block_size=100), dict(TrSyms=20)):
        (w3, _), n = launches(lambda: teq.equalise_signal(E, 2, 1e-3, 256, Ntaps=17,
                                                          method="mcma", **kw))
        assert n == [0, 0, 0] and w3.is_cuda
    (w4, _), n = launches(lambda: teq.equalise_signal(E, 2, 1e-3, 256, Ntaps=17, method="mcma",
                                                      TrSyms=4096))
    assert n == [1, 0, 0]
    with pytest.raises(ValueError, match=r"_MAX_CODES.*'block' or 'seq'"):
        teq.equalise_signal(E, 2, 1e-3, 256, Ntaps=17, method="rde", TrSyms=4096,
                            backend="cuda_block")
    with pytest.raises(ValueError, match="multiple of 32"):
        teq.equalise_signal(E, 2, 1e-3, 256, Ntaps=17, method="mcma", block_size=100,
                            backend="cuda_block")


@pytest.mark.parametrize("method", ["mcma", "rde"])
def test_b9_cut_into_launches_equals_the_whole(dev, capture, method):
    """With a fixed step, launches that hand taps and step on are the whole training, bit for bit."""
    P = capture[3]
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    syms = teq._reshape_symbols(None, method, 64, np.complex64, 2)
    whole = train_seq_cuda(P, 5000, 1, 2, 1e-3, w0, syms, method, False)
    w, mu, errs = w0, 1e-3, []
    for start in range(0, 5000, 1536):
        e, w, mu = train_seq_cuda(P[:, 2 * start:].contiguous(), min(1536, 5000 - start), 1, 2,
                                  mu, w, syms, method, False)
        errs.append(e)
    assert _same(whole, (torch.cat(errs, dim=-1), w, mu))


# ---------------------------------------------------------------------------
# the phase drivers and the signal objects on the card
# ---------------------------------------------------------------------------

def _phase_capture(dev, M=64, N=2 ** 16, seed=3, snr=30, lw=100e3):
    """A signal object built on the card with ``snr`` dB and a ``lw`` Hz linewidth."""
    from qampy_tpu_torch.core import impairments as timp
    from qampy_tpu_torch.signals import SignalQAMGrayCoded
    sig = SignalQAMGrayCoded(M, N, nmodes=2, fb=40e9, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = timp.change_snr(sig.samples, snr, sig.fb, sig.fs, gen)
    if lw:
        x = timp.apply_phase_noise(x, lw, sig.fs, gen)
    return sig.replace(samples=x)


@pytest.mark.parametrize("dim", [2, 1])
@pytest.mark.parametrize("M, fn, A, B", [(64, "bps", 64, None), (64, "bps", 32, None),
                                         (4, "bps", 4, None), (64, "bps_twostage", 32, 8),
                                         (4, "bps_twostage", 4, 4)])
def test_phase_driver_routes(dev, M, fn, A, B, dim):
    """The kernel route (B3, then B8, then B6; no synchronising call) against the plain route.

    Phases equal except where a near-tie moved an index (at most 1e-3 of the
    positions), both routes under the 1e-4 SER gate after 20 edge symbols.
    The reference's tests search QPSK with 4 angles and 64-QAM with 32 and 64.
    """
    sig = _phase_capture(dev, M=M)
    E = sig.samples if dim == 2 else sig.samples[1]
    const = sig.coded_symbols_host
    kw = {} if B is None else dict(B=B)
    counters = (bps_search_cuda, bps_fine_cuda, rotate_cuda)
    for c in counters:
        c.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_k, ph_k = getattr(tph, fn)(E, A, const, 14, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [c.launches for c in counters] == [1, 1 if B else 0, 1]
    out_p, ph_p = getattr(tph, fn)(E, A, const, 14, method="pyt", **kw)
    assert [c.launches for c in counters] == [1, 1 if B else 0, 1]
    assert out_k.shape == out_p.shape == E.shape and ph_k.is_cuda
    same = ph_k == ph_p
    assert float(same.double().mean()) >= 1 - 1e-3
    assert torch.equal(out_k[same], out_p[same])
    rec = sig.replace(samples=torch.atleast_2d(out_k)[:, 20:-20],
                      symbols=torch.atleast_2d(sig.symbols if dim == 2 else sig.symbols[1]))
    assert float(rec.cal_ser().max()) <= 1e-4


def test_signal_metrics_card_against_cpu(dev):
    """A signal's metrics on the card equal (counts) or match the CPU's.

    16-QAM at 12 dB, noise only. The SNR within 1e-5 (sums in another
    order); the GMI within 1e-4: a mean of 2^15 terms log2(1 + exp(+-L))
    whose L-values the card's and the CPU's logsumexp round differently.
    """
    sig = _phase_capture(dev, M=16, N=2 ** 15, seed=2, snr=12, lw=None)
    cpu = sig.to("cpu")
    rx = torch.roll(sig.samples, 77, -1) * 1j
    assert torch.equal(sig.cal_ser(rx).cpu(), cpu.cal_ser(rx.cpu()))
    assert torch.equal(sig.cal_ber(rx).cpu(), cpu.cal_ber(rx.cpu()))
    np.testing.assert_allclose(sig.est_snr().cpu().numpy(), cpu.est_snr().numpy(), rtol=1e-5)
    np.testing.assert_allclose(sig.cal_gmi()[0], cpu.cal_gmi()[0], rtol=1e-4)
    assert torch.equal(sig.demodulate(sig.symbols).cpu(), cpu.demodulate(cpu.symbols))


# ---------------------------------------------------------------------------
# the TX side and the signal-object adapters (A9b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N, order, analog", [(5000, 2, False), (2 ** 20, 2, False),
                                              (9000, 4, True), (9000, 6, True)])
def test_iir_doubling_form_on_the_card(dev, N, order, analog):
    """The IIR recurrence's doubling passes on the card against the CPU within float32's
    rounding (rtol 1e-5 of the output's peak), and two calls on the card bit-equal."""
    from qampy_tpu_torch.core import filter as tfilter
    rng = np.random.default_rng(N + order)
    x = torch.as_tensor((rng.standard_normal((2, N)) + 1j * rng.standard_normal((2, N)))
                        .astype(np.complex64))
    # the analog prototypes at the reference tests' normalised rates (a transfer function at
    # 2 pi 16 GHz has coefficients past float32's range, in both packages)
    rates = (4.0, 0.3) if analog else (80e9, 16e9)
    kw = dict(ftype="bessel", order=order, analog=analog)
    want = tfilter.filter_signal(x, *rates, **kw)
    got = tfilter.filter_signal(x.to(dev), *rates, **kw)
    again = tfilter.filter_signal(x.to(dev), *rates, **kw)
    assert torch.equal(got, again)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _synced_pilot_signal(dev, shifts):
    from qampy_tpu_torch import signals as tsig
    sig = tsig.SignalWithPilots(64, 2 ** 12, 256, 32, nframes=6, nmodes=2, fb=24e9, seed=3,
                                device=dev)
    sig = sig.resample(2 * sig.fb, beta=0.1)
    sig.shiftfctrs = np.asarray(shifts)
    sig.synctaps = 17
    return sig


@pytest.mark.parametrize("shifts, frames", [((40, 40), (0, 1, 2)), ((40, 57), (1, 2)),
                                            ((40, 57), (0, 2, 3)), ((40, 40), (1, 3))])
def test_apply_to_pilotsignal_is_one_frames_launch(dev, shifts, frames):
    """``_apply_to_pilotsignal``: B2's frame entry once for the two output modes, against the
    reference-shaped loop of ``apply_filter`` calls (one a mode where the shifts differ,
    one a frame where the frames are not contiguous) within 1e-5 of the rms."""
    from qampy_tpu_torch import equalisation as teqz
    sig = _synced_pilot_signal(dev, shifts)
    rng = np.random.default_rng(1)
    w = torch.as_tensor((rng.standard_normal((2, 2, 21)) + 1j * rng.standard_normal((2, 2, 21)))
                        .astype(np.complex64) / 8, device=dev)
    apply_filter_frames_cuda.launches = 0
    got = teqz.apply_filter(sig, w, frames=frames)
    assert apply_filter_frames_cuda.launches == 1
    sh = np.asarray(shifts) - (21 - 17) // 2
    step = sig.os * sig.frame_len
    rows = []
    for i in range(2):
        seg = [teq.apply_filter(sig.samples[:, sh[i] + f * step: sh[i] + (f + 1) * step + 20],
                                2, w, modes=[i]) for f in frames]
        rows.append(torch.cat(seg, dim=-1)[0])
    want = torch.stack(rows)
    assert got.shape == want.shape == (2, len(frames) * sig.frame_len)
    rms = float(want.abs().pow(2).mean().sqrt())
    assert float((got.samples - want).abs().max()) <= 1e-5 * rms


def test_cal_lut_avg_is_bit_equal_across_calls(dev):
    """The pattern table's segment sums run in a fixed order on the card: two calls bit-equal
    (``index_add_`` of float32 would not be), and within 1e-6 of the CPU's."""
    from qampy_tpu_torch.core import digital_pre_compensation as tdpc
    rng = np.random.default_rng(2)
    err = torch.as_tensor((rng.standard_normal(2 ** 18) + 1j * rng.standard_normal(2 ** 18))
                          .astype(np.complex64))
    iI = torch.as_tensor(rng.integers(0, 512, 2 ** 18))
    iQ = torch.as_tensor(rng.integers(0, 512, 2 ** 18))
    a = tdpc.cal_lut_avg(err.to(dev), iI.to(dev), iQ.to(dev), 512)
    b = tdpc.cal_lut_avg(err.to(dev), iI.to(dev), iQ.to(dev), 512)
    assert torch.equal(a, b)
    assert float((a.cpu() - tdpc.cal_lut_avg(err, iI, iQ, 512)).abs().max()) <= 1e-6


def test_save_and_load_a_signal_from_the_card(dev, tmp_path):
    """The file holds no tensor (numpy only), loads on the CPU and back on the card with every
    tensor equal."""
    import pickle
    import zlib
    from qampy_tpu_torch import io as tio
    from qampy_tpu_torch import signals as tsig
    sig = _synced_pilot_signal(dev, (40, 57))
    fn = tmp_path / "sig.qz"
    sig.save_to_file(fn)
    raw = pickle.loads(zlib.decompress(fn.read_bytes()))
    assert not any(torch.is_tensor(v) for v in raw.__dict__.values())
    cpu = tio.load_signal(fn, device="cpu")
    card = tio.load_signal(fn)
    assert isinstance(card, tsig.SignalWithPilots) and card.device.type == "cuda"
    assert cpu.device.type == "cpu"
    assert torch.equal(card.samples, sig.samples) and torch.equal(cpu.samples, sig.samples.cpu())
    assert torch.equal(card.pilots, sig.pilots) and np.array_equal(card.shiftfctrs, sig.shiftfctrs)


# ---------------------------------------------------------------------------
# the multi-device receivers (parallel/)
# ---------------------------------------------------------------------------

SHARD_CFG = dict(os=2, mu1=1.9e-3, mu2=1.9e-3, M=64, Ntaps=17, methods=("mcma", "mddma"),
                 TrSyms_loc=2 ** 14, Niter=1, rounds=1, bps_angles=64, bps_N=12,
                 block_size=256, bps_mode="decimated16")
TWO_RANKS = 2


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def nccl1(dev):
    """A one-rank NCCL group in this process, and its mesh on the card."""
    import torch.distributed as dist
    from qampy_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed("localhost:%d" % _free_port(), 1, 0)
    yield make_mesh()
    dist.destroy_process_group()


def test_sharded_chain_on_one_nccl_rank(nccl1, capture):
    """The sharded decimated16 chain over one NCCL rank: B1/B2/B3/B4 = 2/1/1/1, the taps of
    the single-card chain (its CMA guard does not fire on this capture; the phase alignment
    to rank 0 turns by inner/|inner|, 1 to rounding), its decisions off the circular edges."""
    from qampy_tpu_torch.ops.chain import cma_singularity_guard
    from qampy_tpu_torch.parallel import sharded
    E, syms, const, P = capture
    chain = sharded.make_sharded_rx_chain(nccl1, **SHARD_CFG)
    rx = make_rx_chain(**CFG, methods=SHARD_CFG["methods"], mu=SHARD_CFG["mu1"])
    counters = (train_block_cuda, apply_filter_cuda, bps_search_cuda, interp_rotate_cuda)
    for k in counters:
        k.launches = 0
    Eout, ph, evm = chain(sharded.shard_signal(E, nccl1))
    torch.cuda.synchronize()
    assert [k.launches for k in counters] == [2, 1, 1, 1]
    assert Eout.shape == (2, E.shape[-1] // 2) and ph.shape == (2, E.shape[-1] // 32)
    (rr, ri), w_rx = rx.planes_with_taps(P)
    w1 = train_block_cuda(P, 2 ** 14, 1, 2, SHARD_CFG["mu1"], rx.w0, rx.specs[0], True, 256)[1]
    assert torch.equal(cma_singularity_guard(w1), w1)
    assert float((chain.train_taps(P) - w_rx).abs().max()) <= 1e-6
    edge = GATE_TRIM
    a = torch.complex(rr, ri)[:, edge:-edge].cpu()
    b = Eout[:, edge:rr.shape[-1] - edge].cpu()
    assert shared_decisions(a, b, const) >= 0.999
    assert ser_gate(Eout, torch.as_tensor(syms, device=Eout.device), const) <= 1e-4


def test_sharded_chain_kernel_limit_named(nccl1):
    """A block B1 does not take raises KernelLimit when the chain is built for the card."""
    from qampy_tpu_torch.ops._build import KernelLimit
    from qampy_tpu_torch.parallel import sharded
    with pytest.raises(KernelLimit, match="multiple of 32"):
        sharded.make_sharded_rx_chain(nccl1, **dict(SHARD_CFG, block_size=48))


def _two_ranks_main(rank, addr, out):
    """A rank of test_two_gloo_ranks_on_one_card: the exchanges, the filter, the unwrap and
    the derotations on CUDA tensors and on CPU tensors over the same gloo group."""
    import torch.distributed as dist
    from qampy_tpu_torch.parallel import init_distributed, make_mesh, sharded
    init_distributed(addr, TWO_RANKS, rank, backend="gloo")
    card, cpu = make_mesh(), make_mesh(device="cpu")
    E, _, _ = make_tx(2 ** 13, seed=5)
    w = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64))
    rng = np.random.default_rng(3)
    ph4 = torch.as_tensor(np.cumsum(rng.normal(0, 0.4, (2, 2 ** 12)), -1).astype(np.float32))
    res = {}
    for name, m in (("card", card), ("cpu", cpu)):
        P = teq.planes(sharded.shard_signal(E, m))
        x = sharded.shard_signal(ph4, m)
        loc = tph.unwrap(x)
        eqp = sharded._apply_filter_local(P, 2, w.to(m.device), m)
        ph = sharded._unwrap_across_shards(x, m)[0] / 4
        b = sharded._slopes(ph[:, ::16].contiguous(), m, 16)
        a = ph[:, ::16].contiguous()
        er, ei = eqp[:2, :2 ** 11].contiguous(), eqp[2:, :2 ** 11].contiguous()
        b6 = (er, ei, ph[:, :2 ** 11].contiguous(), 1)
        b4 = (er, ei, a[:, :128].contiguous(), b[:, :128].contiguous(), 16, 1)
        res[name] = dict(halo=m.halos(P, 7), eqp=eqp, offs=sharded._shard_offsets(loc, m), loc=loc)
        if m.device.type == "cuda":
            res[name].update(b6=torch.stack(rotate_cuda(*b6)),
                             b6_plain=torch.stack(rotate_plain(*b6)),
                             b4=torch.stack(interp_rotate_cuda(*b4)),
                             b4_plain=torch.stack(interp_rotate_plain(*b4)))
    if rank == TWO_RANKS - 1:
        torch.save({k: {kk: v.cpu() for kk, v in d.items()} for k, d in res.items()}, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def test_two_gloo_ranks_on_one_card(dev, tmp_path):
    """Two gloo ranks on the one card against the same ranks on CPU tensors: the halo
    exchange and the cross-shard unwrap's offsets bit-equal, the filter within B2's tolerance,
    the local unwrap within 1e-4 rad (plain torch on both, its scans summed in other orders);
    and on the card B6 and B4, on the sharded phase and slopes, bit-equal to their plain
    versions on the same card tensors (the CPU's sin and cos round otherwise)."""
    import os
    import subprocess
    import sys
    out = str(tmp_path / "ranks.pt")
    addr = "localhost:%d" % _free_port()
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join([root, os.path.join(root, "tests"),
                                         env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--two-ranks", str(r),
                               addr, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(TWO_RANKS)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    res = torch.load(out)
    c, h = res["card"], res["cpu"]
    assert torch.equal(c["halo"], h["halo"])
    rms = float(h["eqp"].pow(2).mean().sqrt())
    assert float((c["eqp"] - h["eqp"]).abs().max()) <= 1e-5 * rms
    assert torch.equal(c["offs"], h["offs"])
    assert float((c["loc"] - h["loc"]).abs().max()) <= 1e-4
    assert torch.equal(c["b6"], c["b6_plain"]) and torch.equal(c["b4"], c["b4_plain"])


if __name__ == "__main__" and sys.argv[1] == "--two-ranks":
    sys.exit(_two_ranks_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))


# ---------------------------------------------------------------------------
# the last modules: profiling, the pilot chain's frame offset, the examples
# ---------------------------------------------------------------------------

def test_profiling_routes_on_the_card(dev):
    from qampy_tpu_torch import profiling
    from qampy_tpu_torch.ops import equaliser_cuda, phase_cuda
    counters = {"B1": equaliser_cuda.train_block_cuda, "B2": equaliser_cuda.apply_filter_cuda,
                "B3": phase_cuda.bps_search_cuda}
    before = {k: f.launches for k, f in counters.items()}
    res, routes = profiling.run_benchmarks(nsyms=2 ** 14, reps=2, methods=("cma", "sbd"),
                                           device=dev, routes=True)
    assert routes == {"decision": "plain", "bps": "B3", "train_cma": "B1", "train_sbd": "B1",
                      "apply_filter": "B2", "soft_llr": "plain", "select_angles": "plain"}
    assert all(v > 0 for v in res.values())
    # each timed call after a warm-up call: 3 launches a group of its kernel
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    assert launched == {"B1": 6, "B2": 3, "B3": 3}


def test_pilot_tracking_at_a_frame_base(dev):
    """A tracking dispatch at ``_frame_base`` is bit-equal to a chain over those frames."""
    from qampy_tpu_torch.ops import phase_cuda
    tx = make_pilot_tx(8, frame_len=2 ** 14, seq_len=512, seed=1, device=dev)
    kw = dict(os=2, nmodes=2, Ntaps=17, cpe_avg=3, return_phase=False, eq_trainer="ls",
              device=dev)
    seq, ph = tx.pilot_seq, tx.ph_pilots
    chain = make_pilot_rx_chain(seq, ph, 2 ** 14, 32, frames=(0, 1, 2), **kw)
    pr, pi = tx.planes[:2].contiguous(), tx.planes[2:].contiguous()
    _, info = chain.planes(pr, pi)
    state = (info["taps"], info["shift"], info["mode_order"])
    base = 3 * 2 ** 14 * 2
    n0 = phase_cuda.cpe_coeffs_cuda.launches
    (r, i), _ = chain.tracking_planes(pr, pi, *state, _frame_base=base)
    assert phase_cuda.cpe_coeffs_cuda.launches == n0 + 1
    other = make_pilot_rx_chain(seq, ph, 2 ** 14, 32, frames=(3, 4, 5), **kw)
    (r2, i2), _ = other.tracking_planes(pr, pi, *state)
    assert torch.equal(r, r2) and torch.equal(i, i2)
    (r3, i3), _ = chain.tracking_planes(pr, pi, *state,
                                        _frame_base=torch.tensor(base, device=dev))
    assert torch.equal(r, r3) and torch.equal(i, i3)


def test_example_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples_torch"))
    import _common
    mod = _common.load("phase_recovery")
    res = mod.main()                       # no device named: the card
    assert not _common.gate_failures(mod.GATES, res)


# -- bf16 window sums (B3, B8) and the pilot schedules --------------------------

BF16_TILES = [2048, 384]
BF16_KEYS = ["sq"] + GRID_KEYS + ["w64 fitted"]
# every residue-class and ring case of the walk (J = log2(top / 8) from 0 to 4, the components
# of 2N above and below 8) at every reference tile that takes it, on rows that are not a
# multiple of a CTA tile or of T, the alphabets in turn; and rows shorter than one CTA tile
BF16_SWEEP = [(BF16_KEYS[i % len(BF16_KEYS)], N, T, 2 ** 16 + 77)
              for i, (N, T) in enumerate((N, T) for N in (1, 3, 4, 7, 8, 12, 14, 32, 60, 63, 64)
                                         for T in (256, 384, 2048, 8192, 16384) if 2 * N < T)]
BF16_SHORT = [("sq", 14, 256, 100), ("x32", 60, 384, 300), ("w64 fitted", 7, 256, 129)]


def _bf16_const(key):
    """64-QAM for "sq", else the grid tests' alphabet (the warped one for "w64 fitted")."""
    if key == "sq":
        return (cal_symbols_qam(64) / np.sqrt(cal_scaling_factor_qam(64))).astype(np.complex64)
    return _alphabet(key.split()[0])[0]


def _bf16_grid(key, const):
    """The grid B3 and B8 search: the alphabet's, or the warped alphabet's fitted uniform grid."""
    return tph.coarse_grid_for_alphabet(const) if key.endswith("fitted") else tph.detect_grid(const)


@pytest.mark.parametrize(
    "key, A, N, T, L",
    [(key, A, N, T, 2 ** 16 + 77) for key in BF16_KEYS for A, N in [(64, 14), (16, 60), (13, 5)]
     for T in BF16_TILES]
    + [(key, 13 if i % 2 else 16, N, T, L)
       for i, (key, N, T, L) in enumerate(BF16_SWEEP + BF16_SHORT)])
def test_b3_bf16_windows_equal_the_twin(dev, key, A, N, T, L):
    """B3 with bf16 windows at tile T: bit for bit the twin's order (ops.phase.bf16_window_sums)
    on every grid kind, on rows that are not a multiple of a tile."""
    const = _bf16_const(key)
    grid = _bf16_grid(key, const)
    er, ei = _alphabet_planes(dev, const, 7 + A + N, L=L)
    ang = np.linspace(-np.pi / 4, np.pi / 4, A, endpoint=False, dtype=np.float32)
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    got = bps_search_cuda(er, ei, cos_t, sin_t, grid, N, bf16_tile=T)
    assert torch.equal(got, bps_search_plain(er, ei, cos_t, sin_t, grid, N, T))
    assert len(torch.unique(got)) > 1


@pytest.mark.parametrize(
    "key, N, T, L",
    [(key, 14, T, 2 ** 16 + 77) for key in BF16_KEYS for T in BF16_TILES]
    + BF16_SWEEP + BF16_SHORT)
def test_b8_bf16_windows_equal_the_twin(dev, key, N, T, L):
    """B8 with bf16 windows at tile T around a bf16 coarse phase: bit for bit its twin."""
    const = _bf16_const(key)
    grid = _bf16_grid(key, const)
    er, ei = _alphabet_planes(dev, const, 31 + N, L=L)
    ang = np.linspace(-np.pi / 4, np.pi / 4, 16, endpoint=False, dtype=np.float32)
    cos1, sin1 = (torch.as_tensor(t, device=dev) for t in tph.bps_tables(ang, grid))
    ph1 = -np.pi / 4 + np.pi / 32 * bps_search_cuda(er, ei, cos1, sin1, grid, 60, bf16_tile=T).float()
    cd, sd, d0f, ddf = tph.fine_tables(16, 8, grid)
    cd, sd = torch.as_tensor(cd, device=dev), torch.as_tensor(sd, device=dev)
    got = bps_fine_cuda(er, ei, ph1, cd, sd, grid, N, d0f, ddf, bf16_tile=T)
    assert torch.equal(got, bps_fine_plain(er, ei, ph1, cd, sd, grid, N, d0f, ddf, T))


def test_bf16_plan_matches_the_library(dev):
    import ctypes
    from qampy_tpu_torch.ops import _build
    from qampy_tpu_torch.ops.phase_cuda import bf16_plan
    for fine in (False, True):
        for args in ((2, 2 ** 20, 14, 16384, 0), (2, 2 ** 16, 60, 8192, 0), (1, 5000, 64, 256, 32)):
            built = (ctypes.c_longlong * 5)()
            nmodes, L, N, T, npts = args
            _build.library().qtt_bps_bf16_plan(int(fine), nmodes, L, N, npts, T,
                                               ctypes.addressof(built))
            assert tuple(built) == bf16_plan(nmodes, L, N, T, npts, fine)


def test_pilot_span_equals_scan_on_the_card(dev):
    """frames_mode="span" (the batched frame body on windows cut from one clamped span: B2
    frames, B5 and B4 once each) against the scan on the card, within the reference's 1e-4."""
    tx = make_pilot_tx(6, frame_len=2 ** 14, seq_len=512, device=dev)
    kw = dict(os=2, nmodes=2, Ntaps=17, cpe_avg=3, frames=(0, 1, 2), block_size=256,
              return_phase=False, eq_trainer="ls", device=dev)
    scan = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, 2 ** 14, 32, **kw)
    span = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, 2 ** 14, 32, frames_mode="span", **kw)
    (dr, di), info = scan.planes(tx.planes[:2], tx.planes[2:])
    for fn in (apply_filter_cuda, apply_filter_frames_cuda, cpe_coeffs_cuda, interp_rotate_cuda):
        fn.launches = 0
    (sr, si), sinfo = span.planes(tx.planes[:2], tx.planes[2:])
    assert [fn.launches for fn in (apply_filter_cuda, apply_filter_frames_cuda, cpe_coeffs_cuda,
                                   interp_rotate_cuda)] == [0, 1, 1, 1]
    assert max(float((sr - dr).abs().max()), float((si - di).abs().max())) <= 1e-4
    assert ber_gate(sr, si, tx, sinfo["sync_corr"])["ok"]


def test_chain_spans_on_the_card(dev, capture):
    """The decimated16 chain's host spans under a profiler that traces the card: the
    launchers' spans B1/B2/B3/B10/B4 = 2/1/1/1/1 inside the one entry span, B10's inside the
    glue's, none of them among the
    card's operations, one device operation for each launching CUDA call inside the entry,
    no host sync there, and the outputs bit-equal to an untraced call's."""
    from qampy_tpu_torch.profiling import SPANS
    P = capture[3]
    chain = make_rx_chain(**CFG, device=dev)
    want = chain.planes_with_taps(P)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = chain.planes_with_taps(P)
        torch.cuda.synchronize()
    on_card = torch.autograd.DeviceType.CUDA
    host = [e for e in prof.events() if e.device_type != on_card]
    ops = [e.name for e in prof.events()
           if e.device_type == on_card and not getattr(e, "is_user_annotation", False)]
    spans = [e.name for e in host if e.name.startswith("qtt.")]
    assert set(spans) <= set(SPANS)
    assert [spans.count(n) for n in ("qtt.rx.planes_with_taps", "qtt.B1", "qtt.B2", "qtt.B3",
                                     "qtt.B10", "qtt.B4")] == [1, 2, 1, 1, 1, 1]
    glue = next(e.time_range for e in host if e.name == "qtt.rx.glue")
    b10 = next(e.time_range for e in host if e.name == "qtt.B10")
    assert glue.start <= b10.start and b10.end <= glue.end
    assert not any(n.startswith("qtt.") for n in ops)
    entry = next(e.time_range for e in host if e.name == "qtt.rx.planes_with_taps")
    calls = [e.name for e in host if entry.start <= e.time_range.start < entry.end]
    launches = [n for n in calls if n.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                or n in ("cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemsetAsync")]
    assert len(launches) == len(ops) > 0
    assert not set(calls) & {"cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaEventSynchronize", "cudaMemcpy"}
    (wr, wi), ww = want
    (gr, gi), gw = got
    assert torch.equal(gr, wr) and torch.equal(gi, wi) and torch.equal(gw, ww)
