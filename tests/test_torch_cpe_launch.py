"""What B5's launcher decides before any build, the order in which B5 works, and B2's pilot rows.

The CUDA kernel B5 (``csrc/phase.cu`` ``cpe_coeffs_kernel``) runs only on a
card (``tests/test_torch_cuda.py``). Here, on the CPU, stand its launch
plan (``ops/phase_cuda.py`` ``cpe_plan``: tiles per row, shared memory,
whether the launch opts in to more than 48 KB), a float32 model of its
tiled order (the jump count and the last phase carried from tile to tile,
the averages summed behind a halo, the blocks each tile decides) held bit
for bit against the plain version, which CTA and thread of B2's frame
entry write each pilot of its side output (restated from the kernel's
indexing, which the card tests hold against the plain version), and the
launchers' refusal of CPU tensors.
"""
import numpy as np
import pytest
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import equaliser_cuda as tec
from qampy_tpu_torch.ops import phase_cuda as tpc
from qampy_tpu_torch.ops._build import KernelLimit
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from test_torch_filter_launch import PILOT, frame_cta

SMEM_LIMIT = 227 * 1024
# pilots per row: the bench's 2,016, rows about one tile, two and four tiles long, the long
# frames' 8,160 (2^18 symbols at ratio 32) and 32,736 (2^20); a tile is 2,048
NPIL = [3, 62, 2016, 2047, 2048, 2049, 4096, 4097, 8160, 32736]
# averages of 1, 3 and 9 pilots, and one longer than a tile
CPE_AVG = [1, 3, 9, 2500]
CASES = [(npil, c) for npil in NPIL for c in CPE_AVG if npil - c + 1 >= 2]


# ---------------------------------------------------------------------------
# the model of the kernel's order
# ---------------------------------------------------------------------------

def tile_blocks(j0, j1, npts, cpe_avg, n_head, nbt):
    """The blocks [k_lo, k_hi) that the tile of pilots [j0, j1) decides (empty: k_lo >= k_hi).

    The averages pavg[p0 .. p1) end in the tile (pavg[l] ends at pilot l + cpe_avg - 1). The
    tile decides the blocks whose la = k - n_head is among them or, inside, whose la + 1 is:
    the head (la < 0) with pavg[0], the tail (la >= npts - 1) with pavg[npts - 1]
    (csrc/phase.cu ``cpe_coeffs_kernel``).
    """
    p0, p1 = max(0, j0 - cpe_avg + 1), min(npts, j1 - cpe_avg + 1)
    if p0 >= p1:
        return 0, 0
    k_lo = 0 if p0 == 0 else min(nbt, max(0, p0 - 1 + n_head))
    k_hi = nbt if p1 == npts else min(nbt, max(0, p1 - 1 + n_head))
    return k_lo, k_hi


def kernel_order_coeffs(symr, symi, pil_r, pil_i, off, stride, n_head, npts, dx, cpe_avg, nbt):
    """B5's (a, b) and how often each block was written, computed tile by tile as the kernel does.

    The phases are the plain version's (torch.atan2 for atan2f); the count of jumps before a
    tile and its last phase carry to the next, the tile's u follows a halo of the ``cpe_avg``
    values before it, and each average is summed there in the plain order.
    """
    rows = symr.shape[0]
    plan = tpc.cpe_plan(rows, pil_r.shape[1], cpe_avg, npts)
    T, Hp = plan.tile, plan.halo
    nuse = npts + cpe_avg - 1
    cols = off + stride * torch.arange(nuse)
    zr, zi = symr[:, cols], symi[:, cols]
    pr = pil_r[:, :nuse].repeat_interleave(rows // pil_r.shape[0], dim=0)
    pi = pil_i[:, :nuse].repeat_interleave(rows // pil_r.shape[0], dim=0)
    ph = torch.atan2(pr * zi - pi * zr, pr * zr + pi * zi)
    a = torch.full((rows, nbt), float("nan"))
    b = torch.full((rows, nbt), float("nan"))
    written = torch.zeros(nbt, dtype=torch.int64)
    u_s = torch.zeros((rows, Hp + T))
    count = torch.zeros((rows, 1), dtype=torch.int32)
    carry = torch.zeros((rows, 1))
    ntiles = 0
    for j0 in range(0, nuse, T):
        ntiles += 1
        j1 = min(j0 + T, nuse)
        p = ph[:, j0:j1]
        d = p - torch.cat([carry, p[:, :-1]], dim=1)
        m = torch.floor(d * tpc.INV_TWO_PI + 0.5).to(torch.int32)
        if j0 == 0:
            m[:, 0] = 0
        s = count + torch.cumsum(m, dim=1, dtype=torch.int32)
        u_s[:, Hp:Hp + j1 - j0] = p - tpc.TWO_PI * s.to(torch.float32)
        k_lo, k_hi = tile_blocks(j0, j1, npts, cpe_avg, n_head, nbt)
        p1 = min(npts, j1 - cpe_avg + 1)
        if k_lo < k_hi:
            k = torch.arange(k_lo, k_hi)
            la = k - n_head
            lo = la.clamp(0, npts - 1)
            mid = (la >= 0) & (la < npts - 1)
            hi = torch.where(mid, la + 1, lo)

            # the averages pavg[l0 .. p1) of the tile, u_s[:, Hp + l - j0] = u[l]
            l0 = max(0, int(lo.min()))
            n = p1 - l0
            at = Hp + l0 - j0 + cpe_avg - 1
            acc = u_s[:, at:at + n]
            for kk in range(1, cpe_avg):
                acc = acc + u_s[:, at - kk:at - kk + n]
            pv = acc / cpe_avg
            pa, pb = pv[:, lo - l0], pv[:, hi - l0]
            a[:, k_lo:k_hi] = pa
            b[:, k_lo:k_hi] = torch.where(mid, (pb - pa) / dx, 0.0)
            written[k_lo:k_hi] += 1
        count = s[:, -1:]
        carry = p[:, -1:]
        if j1 < nuse:
            # the last cpe_avg values of u before the next tile, behind its start
            u_s[:, Hp - cpe_avg:Hp] = u_s[:, Hp - cpe_avg + T:Hp + T].clone()
    assert ntiles == plan.tiles
    return a, b, written


def _rows(seed, rows, npil, ld=None, off=0, stride=1):
    """(rows, ld) symbol planes whose pilots at off + j stride carry a wrapping random walk."""
    rng = np.random.default_rng(seed)
    ld = ld or off + (npil - 1) * stride + 1
    pil = np.exp(0.5j * np.pi * (rng.integers(0, 4, (2, npil)) + 0.5))
    walk = np.cumsum(rng.normal(scale=0.4, size=(rows, npil)), axis=-1)
    sym = (rng.standard_normal((rows, ld)) + 1j * rng.standard_normal((rows, ld)))
    sym[:, off:off + (npil - 1) * stride + 1:stride] = (pil.repeat(rows // 2, axis=0)
                                                        * np.exp(1j * walk))
    sym = sym.astype(np.complex64)
    return tuple(torch.as_tensor(np.ascontiguousarray(x)).float()
                 for x in (sym.real, sym.imag, pil.real, pil.imag))


def _chain_geometry(npil, cpe_avg, R=32, seq_len=1024):
    """(n_head, npts, nbt) as the pilot chain derives them for frames of npil CPE pilots."""
    return (seq_len + R * ((cpe_avg - 1) // 2)) // R, npil - cpe_avg + 1, seq_len // R + npil


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("npil, cpe_avg", CASES)
def test_cpe_plan(npil, cpe_avg):
    """One CTA per row; a row's pilots in tiles of 2,048; the halo is the average's length."""
    p = tpc.cpe_plan(480, npil, cpe_avg)
    assert p.tile == tpc.CPE_TILE == 2048 and p.ctas == 480 and p.halo == -(-cpe_avg // 4) * 4
    assert p.tiles == -(-npil // 2048)
    assert p.smem == 4 * (p.halo + 2 * 2048 + 36)
    assert not p.opt_in and p.smem <= 48 * 1024


def test_cpe_plan_at_the_bench_and_the_long_frames():
    assert tpc.cpe_plan(480, 2016, 3) == (2048, 1, 4, 16544, 480, False)
    assert tpc.cpe_plan(32, 8160, 3).tiles == 4
    assert tpc.cpe_plan(4, 32736, 3).tiles == 16
    # fewer averages than the pilots hold: the tiles cover only the pilots they reach
    assert tpc.cpe_plan(2, 8160, 3, npts=2000).tiles == 1


def test_cpe_plan_opts_in_only_for_averages_of_thousands():
    """No opt-in up to an average of 8,156 pilots, 48 KB; opted in up to 53,980, 227 KB."""
    assert all(not tpc.cpe_plan(1, 60000, c).opt_in for c in (1, 1001, 8156))
    big = tpc.cpe_plan(1, 60000, 8157)
    assert big.opt_in and big.smem > 48 * 1024
    top = tpc.check_cpe_plan(1, 60000, 53980)
    assert top.opt_in and top.smem == SMEM_LIMIT
    with pytest.raises(KernelLimit, match="53980"):
        tpc.check_cpe_plan(1, 60000, 53981)


def test_chain_built_for_the_card_checks_the_limit():
    """make_pilot_rx_chain refuses an average that B5 cannot hold when it builds the chain."""
    rng = np.random.default_rng(0)
    seq = np.exp(0.5j * np.pi * rng.integers(0, 4, (2, 1024)))
    ph = np.exp(0.5j * np.pi * rng.integers(0, 4, (2, 65280)))
    with pytest.raises(KernelLimit, match="B5"):
        make_pilot_rx_chain(seq, ph, 2 ** 18, 4, cpe_avg=60001, return_phase=False,
                            eq_trainer="ls", device="cuda")
    chain = make_pilot_rx_chain(seq, ph, 2 ** 18, 4, cpe_avg=60001, return_phase=False,
                                eq_trainer="ls", device="cpu")
    assert chain.kernel_interp and chain.nblk == 65280


# ---------------------------------------------------------------------------
# the blocks each tile decides, and the tiled order against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("npil, cpe_avg", CASES)
def test_every_block_decided_once(npil, cpe_avg):
    """Over the tiles, each block k < nbt is decided exactly once, the head and tail too,
    at the chain's geometry and at heads and tails longer than a tile."""
    npts = npil - cpe_avg + 1
    nuse = npil
    for n_head, nbt in (_chain_geometry(npil, cpe_avg)[::2], (0, npts), (3000, npts + 6000),
                        (5, 2)):
        hits = np.zeros(nbt, np.int64)
        for j0 in range(0, nuse, tpc.CPE_TILE):
            k_lo, k_hi = tile_blocks(j0, min(j0 + tpc.CPE_TILE, nuse), npts, cpe_avg, n_head,
                                     nbt)
            hits[k_lo:max(k_lo, k_hi)] += 1
        assert (hits == 1).all(), (n_head, nbt)


@pytest.mark.parametrize("npil, cpe_avg", CASES)
def test_tiled_order_equals_the_plain_version(npil, cpe_avg):
    """The model of the kernel's tiles gives the plain version's (a, b) bit for bit."""
    n_head, npts, nbt = _chain_geometry(npil, cpe_avg)
    rows = 4 if npil < 10000 else 2
    args = (*_rows(npil + cpe_avg, rows, npil), 0, 1, n_head, npts, 32, cpe_avg, nbt)
    a, b, written = kernel_order_coeffs(*args)
    a_p, b_p = tpc.cpe_coeffs_plain(*args)
    assert (written == 1).all()
    assert torch.equal(a, a_p) and torch.equal(b, b_p)


@pytest.mark.parametrize("off, stride, npts, n_head, nbt", [
    (5, 3, 2000, 0, 4500), (1, 1, 5998, 4100, 7000), (0, 32, 4094, 33, 4127)])
def test_tiled_order_strided_and_short_averages(off, stride, npts, n_head, nbt):
    """Pilots read strided or from an unaligned start, fewer averages than the pilots hold,
    heads longer than a tile: the model still gives the plain version's (a, b)."""
    npil = 6000 if npts != 4094 else 4096
    args = (*_rows(off + stride, 4, npil, off=off, stride=stride), off, stride, n_head, npts,
            8, 3, nbt)
    a, b, written = kernel_order_coeffs(*args)
    a_p, b_p = tpc.cpe_coeffs_plain(*args)
    assert (written == 1).all()
    assert torch.equal(a, a_p) and torch.equal(b, b_p)


def test_tiled_order_at_an_exact_half_turn():
    """A step of exactly +pi across a tile's edge counts as a jump in both: floor(0.5 + 0.5)."""
    npil = 2 * tpc.CPE_TILE + 10
    half = np.zeros(npil, bool)
    half[tpc.CPE_TILE:tpc.CPE_TILE + 5] = True              # from the tile's first pilot on
    symr = torch.as_tensor(np.where(half, -1.0, 1.0).astype(np.float32)[None].repeat(2, 0))
    symi = torch.zeros_like(symr)                            # atan2(+0, -1) = +pi
    d = float(torch.atan2(symi[0, tpc.CPE_TILE], symr[0, tpc.CPE_TILE]))
    assert d == np.float32(np.pi)
    pil = torch.ones(2, npil), torch.zeros(2, npil)
    args = (symr, symi, *pil, 0, 1, 1, npil - 2, 1, 3, npil)
    a, b, _ = kernel_order_coeffs(*args)
    a_p, b_p = tpc.cpe_coeffs_plain(*args)
    assert torch.equal(a, a_p) and torch.equal(b, b_p)
    # the unwrap took the jump: the phases after it are pi - 2 pi
    assert float(a_p[0, tpc.CPE_TILE + 2]) < -3.0


# ---------------------------------------------------------------------------
# B2's frame entry: who writes each pilot of the side output
# ---------------------------------------------------------------------------

def pilot_writers(plan, nout, frame_len, nframes, poff, pstride, npil):
    """{(part, mode, frame, pilot): [(launch, CTA, thread), ...]} of a frame call's side output.

    Thread t of output mode j of a CTA of tile k0 holds the outputs c + r, c = t run, r < run,
    of its run in registers; before the epilogue it stores those that are pilots, output k =
    k0 + c + r being pilot p = d // pstride when d = k - poff >= 0 is a multiple of pstride
    below npil pstride. It finds them from one floor division of d by pstride: at a stride of
    at least a run, the one pilot a run can hold, else by a count through its run
    (csrc/equaliser.cu ``apply_filter_frames_kernel``).
    """
    group = plan.threads // tec.FILTER_THREADS
    ntiles = -(-frame_len // plan.tile)
    seen = {}
    for j0 in range(0, nout, group):
        ng = min(group, nout - j0)
        for f in range(nframes):
            for tile in range(ntiles):
                k0 = tile * plan.tile
                for j in range(ng):
                    for t in range(tec.FILTER_THREADS):
                        c = t * plan.run
                        d0 = k0 - poff + c
                        rr = d0 % pstride             # the floor modulo, as the kernel's
                        p = (d0 - rr) // pstride
                        for r in range(plan.run):
                            if rr == 0 and 0 <= p < npil:
                                assert k0 + c + r == poff + p * pstride < frame_len
                                for part in range(2):
                                    seen.setdefault((part, j0 + j, f, p), []).append(
                                        (j0 // group, f * ntiles + tile,
                                         j * tec.FILTER_THREADS + t))
                            rr += 1
                            if rr == pstride:
                                rr, p = 0, p + 1
    return seen


@pytest.mark.parametrize("nout, frame_len, poff, pstride, npil", [
    (2, 2 ** 12, 1024, 32, 96), (2, 3000, 512, 32, 78), (1, 3000, 7, 5, 598),
    (3, 2 ** 11, 0, 1, 2 ** 11), (2, 2 ** 12, 4000, 100, 1), (1, 2000, 3, 300, 7),
    (2, 2 ** 13, 9, 2, 4000)])
def test_pilot_side_output_written_once(nout, frame_len, poff, pstride, npil):
    """Every pilot of every (part, output mode, frame) is written once, by the CTA whose tile
    holds it, in the launch of its output mode's group, by the thread whose run holds it."""
    nframes = 2
    plan = tec.filter_plan(2, nout, 45, 2, frame_len, nframes)
    seen = pilot_writers(plan, nout, frame_len, nframes, poff, pstride, npil)
    assert set(seen) == {(part, j, f, p) for part in range(2) for j in range(nout)
                         for f in range(nframes) for p in range(npil)}
    for (part, j, f, p), who in seen.items():
        assert len(who) == 1
        k = poff + p * pstride
        assert who[0][:2] == frame_cta(plan, nout, frame_len, f, j, k)
        group = plan.threads // tec.FILTER_THREADS
        assert who[0][2] == (j % group) * tec.FILTER_THREADS + (k % plan.tile) // plan.run


def test_pilot_side_output_at_the_bench():
    """240 frames of 2^16 symbols: runs of 10 outputs, so a thread holds at most one pilot (one
    every 32 outputs), and 40 of a tile's 128 threads per output mode hold one."""
    plan = tec.filter_plan(*PILOT, 240)
    assert plan.tile == 1280 and plan.threads == 256 and plan.run == 10
    seen = pilot_writers(plan, 2, 2 ** 16, 1, 1024, 32, 2016)
    per_thread = {}
    for (part, j, f, p), who in seen.items():
        if part == 0:
            per_thread.setdefault(who[0][1:], []).append(p)
    assert max(len(ps) for ps in per_thread.values()) == 1
    assert sum(1 for (cta, t) in per_thread if cta == 10) == 2 * 40
    with pytest.raises(ValueError, match="does not fit"):
        tec.apply_filter_frames_plain(torch.zeros(4, 1), 2, torch.zeros(2, 2, 45,
                                      dtype=torch.complex64), torch.zeros(2, 1).long(), 2 ** 16,
                                      (1024, 32, 2017))


# ---------------------------------------------------------------------------
# the launchers refuse the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything builds or loads the kernel library."""
    def library():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_build, "library", library)


def test_launchers_refuse_the_cpu_and_the_bare_names_are_plain(no_build):
    symr, symi, pr, pi = _rows(1, 2, 4097)
    args = (symr, symi, pr, pi, 0, 1, 33, 4095, 32, 3, 4129)
    with pytest.raises(ValueError, match="CUDA"):
        tpc.cpe_coeffs_cuda(*args)
    for x, y in zip(tpc.cpe_coeffs(*args), tpc.cpe_coeffs_plain(*args)):
        assert torch.equal(x, y)
    rng = np.random.default_rng(2)
    P = torch.as_tensor(rng.standard_normal((4, 3000)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((2, 2, 17)) + 1j).astype(np.complex64))
    offs = torch.tensor([[0, 1200], [5, 1205]])
    with pytest.raises(ValueError, match="CUDA"):
        tec.apply_filter_frames_cuda(P, 2, w, offs, 600, (24, 32, 18))
    got = tec.apply_filter_frames(P, 2, w, offs, 600, (24, 32, 18))
    want = tec.apply_filter_frames_plain(P, 2, w, offs, 600, (24, 32, 18))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
