"""What B2's launchers decide before any build: the launch plan, the side output, the frame grid.

The CUDA kernel B2 (``csrc/equaliser.cu`` ``apply_filter_kernel`` and
``apply_filter_frames_kernel``) runs only on a card
(``tests/test_torch_cuda.py``). Here, on the CPU, stand its launch plan
(``ops/equaliser_cuda.py`` ``filter_plan``: outputs per thread, tile, tap
chunk, threads, staged segment, shared memory, grid), which CTA and thread
write each side output and which capture spans a frame CTA reads (restated
here from the kernels' indexing, which the card tests hold against the
plain version), the launchers' refusal of CPU tensors, and the zero padding
of the tap table, which must not change the filter.
"""
import numpy as np
import pytest
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import equaliser_cuda as tec
from qampy_tpu_torch.ops.equaliser import apply_filter_planes

SMEM_LIMIT = 227 * 1024
BLIND = (2, 2, 17, 2, 2 ** 20 - 8)          # (nmodes, nout, ntaps, os, Lout): 2^21 samples
EQUALISER = (2, 2, 17, 2, 2 ** 18 - 8)      # 2^19 samples
PILOT = (2, 2, 45, 2, 2 ** 16)              # a frame of 2^16 symbols


def side_output_writer(plan, i, dec):
    """(CTA, thread) of a planes launch that writes side output i // dec of output ``i``.

    The CTA that holds output i in its tile writes it, i % dec == 0, from its
    output tile in shared memory: its threads take the tile's side positions
    in turn (csrc/equaliser.cu ``apply_filter_kernel``).
    """
    if i % dec:
        raise ValueError("output %d has no side output at stride %d" % (i, dec))
    cta, u = divmod(i, plan.tile)
    u0 = (dec - cta * plan.tile % dec) % dec
    return cta, (u - u0) // dec % plan.threads


def frame_cta(plan, nout, frame_len, f, j, k):
    """(launch, CTA) of a frame call that computes output ``k`` of output mode ``j`` in frame ``f``.

    The call launches the kernel once per group of output modes; each grid
    is one-dimensional and frame-major: the tiles of frame 0, then those of
    frame 1, ... (csrc/equaliser.cu ``qtt_apply_filter_frames``).
    """
    group = plan.threads // tec.FILTER_THREADS
    return j // group, f * -(-frame_len // plan.tile) + k // plan.tile


def frame_stagings(plan, starts):
    """The capture spans (start, samples) that one frame CTA reads, its windows starting at ``starts``.

    ``starts``: each output mode's window start for the CTA's tile. A window
    is read from its 16-byte aligned start a = start - start % 4, ``plan.seg``
    + 4 samples. Two windows whose aligned starts lie less than ``plan.seg``
    apart are read as their union, once; otherwise each is read on its own
    (csrc/equaliser.cu ``apply_filter_frames_kernel``).
    """
    a = [o - o % 4 for o in starts]
    win = plan.seg + 4
    if len(a) == 2 and abs(a[1] - a[0]) < plan.seg:
        return [(min(a), abs(a[1] - a[0]) + win)]
    return [(x, win) for x in a]


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def test_plan_at_the_blind_path():
    """The planes entry starts at runs of 6 outputs: tiles of 768, 1,366 CTAs; 17 taps padded
    to 20; the staging of 1,536 + 20 samples per plane and the tap table in 25,536 bytes."""
    p = tec.filter_plan(*BLIND)
    assert p == (6, 768, 4, 128, 1556, 4 * (4 * 1556 + 20 * 2 * 2 * 2), 1366)
    assert tec.FILTER_PLANES_RUNS[0] == 6


def test_plan_at_the_pilot_paths():
    """Both output modes in one CTA of 256 threads, room for two windows of seg + 4 per plane;
    240 frames of 52 tiles, and the return_phase chain's 8 frames still at runs of 10."""
    p = tec.filter_plan(*PILOT, 240)
    assert p == (10, 1280, 4, 256, 2608, 4 * (4 * 2 * 2612 + 48 * 2 * 2 * 2), 240 * 52)
    assert tec.filter_plan(*PILOT, 8) == p._replace(ctas=8 * 52)


@pytest.mark.parametrize("args, run", [(EQUALISER, 6), ((2, 2, 17, 2, 2 ** 15), 2),
                                       ((1, 1, 17, 2, 100), 2), (BLIND, 6),
                                       ((2, 2, 45, 2, 2 ** 12, 1), 2), ((2, 2, 45, 2, 2 ** 12, 60), 6),
                                       ((2, 2, 45, 2, 2 ** 12, 240), 10)])
def test_plan_run_shrinks_for_short_rows(args, run):
    """The equaliser's 2^19 samples take runs of 6 (342 CTAs): the first run of the entry's
    (the planes entry's are 6 and 2) whose grid has FILTER_MIN_CTAS CTAs, else the
    shortest."""
    p = tec.filter_plan(*args)
    assert p.run == run and p.tile == 128 * run
    rows = args[5] if len(args) > 5 else 1
    assert p.ctas == rows * -(-args[4] // p.tile)
    runs = tec.FILTER_FRAME_RUNS if len(args) > 5 else tec.FILTER_PLANES_RUNS
    assert p.ctas >= tec.FILTER_MIN_CTAS or run == runs[-1]
    if run != runs[0]:
        longer = runs[runs.index(run) - 1]
        assert rows * -(-args[4] // (128 * longer)) < tec.FILTER_MIN_CTAS


@pytest.mark.parametrize("os_", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("nframes", [0, 240])
def test_plan_fits_a_cta(os_, nframes):
    """Up to 128 taps, 4 input modes and 4 output modes of the frame entry (2 of the planes
    entry) at any os up to 8 the CTA stays within 227 KB, as B2's CTA of one output per
    thread did; a segment holds the last run's window: tile * os + the padded taps. Where a
    longer run would not fit, the plan takes the first that does."""
    runs = tec.FILTER_FRAME_RUNS if nframes else tec.FILTER_PLANES_RUNS
    for ntaps in range(1, 129, 3):
        for nmodes in (1, 2, 4):
            for nout in (1, 2, 3, 4) if nframes else (1, 2):
                p = tec.filter_plan(nmodes, nout, ntaps, os_, 2 ** 16, nframes)
                assert p.smem <= SMEM_LIMIT
                assert p.seg % 4 == 0 and p.seg >= p.tile * os_ + -(-ntaps // 4) * 4
                group = p.threads // 128 if nframes else nout
                assert group == min(nout, 2) or not nframes
                # the staging also holds the output tile
                assert p.smem >= 4 * 2 * group * p.tile
                for longer in runs[:runs.index(p.run)]:
                    bigger = tec._plan_at(nmodes, nout, group, ntaps, os_, 2 ** 16, nframes,
                                          longer)
                    assert bigger.smem > SMEM_LIMIT or bigger.ctas < tec.FILTER_MIN_CTAS


def test_plan_shrinks_the_run_to_fit():
    """At os = 6 a frame CTA at runs of 10 would need 247 KB: the plan takes runs of 6
    (149 KB); the planes entry stays at runs of 6."""
    big = tec._plan_at(2, 2, 2, 45, 6, 2 ** 16, 240, 10)
    assert big.smem > SMEM_LIMIT
    p = tec.filter_plan(2, 2, 45, 6, 2 ** 16, 240)
    assert p.run == 6 and p.smem <= SMEM_LIMIT and p.threads == 256
    assert tec.filter_plan(2, 2, 45, 6, 2 ** 20).run == 6


def test_plan_groups_of_output_modes():
    """The frame entry takes any nout: groups of two output modes per CTA, the last of one when
    nout is odd; where two do not fit at any run (os = 30), groups of one."""
    p3 = tec.filter_plan(2, 3, 45, 2, 2 ** 12, 40)
    assert p3.threads == 256 and p3.ctas == 40 * 2 * -(-2 ** 12 // p3.tile)
    assert tec.filter_plan(2, 4, 45, 2, 2 ** 12, 40) == p3
    assert tec._plan_at(2, 2, 2, 45, 30, 4096, 8, 2).smem > SMEM_LIMIT
    p = tec.filter_plan(2, 2, 45, 30, 4096, 8)
    assert p.threads == 128 and p.run == 2 and p.smem <= SMEM_LIMIT
    assert p.ctas == 8 * 2 * 16


def test_plan_other_os():
    """os = 1 and 3 take the generic instance with the same plan rules."""
    assert tec.filter_plan(2, 2, 17, 1, 2 ** 20) == (6, 768, 4, 128, 788, 4 * (4 * 788 + 160),
                                                      1366)
    p = tec.filter_plan(2, 2, 17, 3, 2 ** 20)
    assert p.seg == 3 * 768 + 20 and p.run == 6
    assert tec.filter_plan(2, 2, 17, 3, 2 ** 20, 40).run == 10


def test_runs_stride_odd_slots_at_os_2():
    """A run is 2R floats: an odd number of 16-byte slots for every R of the plan, so the 8
    lanes of a quarter warp load 8 distinct bank groups without padding."""
    for run in set(tec.FILTER_FRAME_RUNS + tec.FILTER_PLANES_RUNS):
        slots = 2 * run // 4
        assert 2 * run % 4 == 0 and slots % 2 == 1
        assert len({(lane * slots) % 8 for lane in range(8)}) == 8


def test_grid_limit():
    """The frame grid is 1-D: 2^31 - 1 CTAs, far past the old 65,535 rows; the launcher
    refuses beyond."""
    assert tec.filter_plan(2, 2, 45, 2, 2 ** 12, 40000).ctas == 40000 * 4
    assert tec.filter_plan(2, 2, 5, 2, 64, 40000).ctas == 40000 > 65535 // 2
    assert tec.filter_plan(2, 2, 5, 2, 2 ** 20, 2 ** 30).ctas > tec._MAX_GRID


# ---------------------------------------------------------------------------
# who writes the side output, and what a frame CTA reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dec", [8, 16])
@pytest.mark.parametrize("args", [BLIND, EQUALISER, (2, 2, 17, 2, 2 ** 14 + 3)])
def test_side_output_written_once(args, dec):
    """Runs of 6 (which do not divide dec) and of 2 (which do): every output i with
    i % dec == 0 is written by a thread of the CTA that holds it in its tile, and the threads
    of a CTA take its side positions in turn, one each per pass."""
    p = tec.filter_plan(*args)
    Lout = args[4]
    writers = [side_output_writer(p, i, dec) for i in range(0, Lout, dec)]
    for i, (cta, thread) in zip(range(0, Lout, dec), writers):
        assert cta == i // p.tile and 0 <= thread < p.threads
    per_cta = {}
    for cta, thread in writers:
        per_cta.setdefault(cta, []).append(thread)
    for threads in per_cta.values():
        assert threads == [t % p.threads for t in range(len(threads))]
    with pytest.raises(ValueError):
        side_output_writer(p, dec + 1, dec)


@pytest.mark.parametrize("nout", [2, 3])
def test_frame_grid_is_frame_major(nout):
    """Two output modes share their CTAs; a third takes a launch of its own, of the same grid."""
    p = tec.filter_plan(2, nout, 45, 2, 2 ** 16, 240)
    ngroups = -(-nout // 2)
    assert p.ctas == ngroups * 240 * 52
    assert frame_cta(p, nout, 2 ** 16, 0, 0, 0) == frame_cta(p, nout, 2 ** 16, 0, 1, 0) == (0, 0)
    assert frame_cta(p, nout, 2 ** 16, 0, 1, 2 ** 16 - 1) == (0, 51)
    assert frame_cta(p, nout, 2 ** 16, 1, 0, 0) == (0, 52)
    assert frame_cta(p, nout, 2 ** 16, 239, nout - 1, 2 ** 16 - 1) == (ngroups - 1, p.ctas // ngroups - 1)
    if nout == 3:
        assert frame_cta(p, nout, 2 ** 16, 0, 2, 0) == (1, 0)


@pytest.mark.parametrize("d", [0, 1, -3, 28, -2607, 2603, 2607, 2608, -2608, -2610, 10 ** 6])
@pytest.mark.parametrize("o0", [5000, 5003])
def test_frame_stagings_pair_the_output_modes(o0, d):
    """Each window is read from its 16-byte aligned start, seg + 4 samples; two whose aligned
    starts lie less than a segment apart are read once, as their union, else each on its own:
    no capture sample is read twice unless the windows overlap."""
    p = tec.filter_plan(*PILOT, 240)
    a0, a1 = o0 - o0 % 4, o0 + d - (o0 + d) % 4
    spans = frame_stagings(p, [o0, o0 + d])
    if abs(a1 - a0) < p.seg:
        assert spans == [(min(a0, a1), abs(a1 - a0) + p.seg + 4)]
        assert spans[0][1] <= 2 * (p.seg + 4)
    else:
        assert spans == [(a0, p.seg + 4), (a1, p.seg + 4)]
    assert all(start % 4 == 0 and n % 4 == 0 for start, n in spans)
    for o in (o0, o0 + d):       # every sample the tile's outputs need lies in a span
        assert any(start <= o and o + (p.tile - 1) * 2 + 48 <= start + n for start, n in spans)
    assert frame_stagings(tec.filter_plan(2, 1, 45, 2, 2 ** 16, 240), [o0]) == [(5000, 2612)]


# ---------------------------------------------------------------------------
# the launchers on the CPU, and the padded tap table
# ---------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything builds or loads the kernel library."""
    def library():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_build, "library", library)


def _case(seed, nmodes=2, nout=2, ntaps=17, L=600):
    rng = np.random.default_rng(seed)
    P = torch.as_tensor(rng.standard_normal((2 * nmodes, L)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((nout, nmodes, ntaps))
                         + 1j * rng.standard_normal((nout, nmodes, ntaps))).astype(np.complex64))
    return P, w


def test_launchers_refuse_the_cpu_and_the_bare_names_are_plain(no_build):
    P, w = _case(0)
    with pytest.raises(ValueError, match="CUDA"):
        tec.apply_filter_cuda(P, 2, w)
    offs = torch.tensor([[0, 100], [3, 103]])
    with pytest.raises(ValueError, match="CUDA"):
        tec.apply_filter_frames_cuda(P, 2, w, offs, 50)
    assert torch.equal(tec.apply_filter(P, 2, w), tec.apply_filter_plain(P, 2, w))
    assert torch.equal(tec.apply_filter_frames(P, 2, w, offs, 50),
                       tec.apply_filter_frames_plain(P, 2, w, offs, 50))


@pytest.mark.parametrize("ntaps, os_", [(17, 2), (45, 2), (1, 1), (63, 3)])
def test_zero_padded_taps_filter_alike(ntaps, os_):
    """The kernel pads the taps with zeros to a multiple of the chunk: on the outputs both
    have, the plain filter with padded taps equals the unpadded one to float32 rounding."""
    P, w = _case(ntaps, ntaps=ntaps)
    ntp = -(-ntaps // tec.FILTER_CHUNK) * tec.FILTER_CHUNK
    wp = torch.cat([w, torch.zeros(*w.shape[:2], ntp - ntaps, dtype=w.dtype)], dim=-1)
    out, outp = apply_filter_planes(P, os_, w), apply_filter_planes(P, os_, wp)
    n = outp.shape[-1]
    assert n == (P.shape[-1] - ntp) // os_ + 1
    torch.testing.assert_close(outp, out[:, :n], rtol=0, atol=1e-6 * float(out.abs().max()))
