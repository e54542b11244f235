"""What the launchers of the trainer kernels B1 and B9 decide before any build.

The CUDA kernels run only on a card (``tests/test_torch_cuda.py``); here, on
the CPU, stand the launchers' shape rules, which look at shapes only, the
refusal of CPU tensors before the kernel library is built or loaded, and
the dispatch of the bare names to the plain versions, which stay beside
the kernels unchanged: the plain versions themselves are held against the
JAX package in ``test_torch_equalise.py`` and ``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import equaliser_cuda as tec


def _planes(nmodes, L):
    return torch.zeros(2 * nmodes, L)


def _taps(nout, nmodes, ntaps):
    return torch.zeros(nout, nmodes, ntaps, dtype=torch.complex64)


@pytest.mark.parametrize("S, trsyms, want", [(32, 4096, (32, 128)), (64, 1000, (64, 15)),
                                             (256, 16384, (256, 64)), (512, 600, (512, 1)),
                                             (1024, 2048, (1024, 2)), (256, 96, (96, 1))])
def test_block_launch_shape(S, trsyms, want):
    """The kernel's block is the algorithm's, and TrSyms is cut to whole blocks."""
    assert tec.block_launch_shape(_planes(2, 40000), trsyms, 2, _taps(2, 2, 17), S) == want


@pytest.mark.parametrize("P, trsyms, os_, w, S, match", [
    (_planes(2, 40000), 4096, 2, _taps(2, 2, 17), 100, "multiple of 32"),
    (_planes(2, 40000), 4096, 2, _taps(2, 2, 17), 16, "multiple of 32"),
    (_planes(2, 40000), 4096, 2, _taps(2, 2, 17), 2048, "multiple of 32"),
    (_planes(2, 40000), 20, 2, _taps(2, 2, 17), 256, "multiple of 32"),
    (_planes(2, 8000), 4096, 2, _taps(2, 2, 17), 256, "shorter"),
    (_planes(2, 8206), 4096, 2, _taps(2, 2, 17), 256, "shorter"),
    (_planes(1, 40000), 4096, 2, _taps(2, 2, 17), 256, "do not match"),
    (_planes(3, 40000), 4096, 2, _taps(3, 3, 17), 256, "at most 2 output modes"),
    (_planes(2, 40000), 4096, 0, _taps(2, 2, 17), 256, "oversampling"),
    (torch.zeros(4, 2, 40000), 4096, 2, _taps(2, 2, 17), 256, "do not match"),
])
def test_block_launch_shape_refuses(P, trsyms, os_, w, S, match):
    with pytest.raises(ValueError, match=match):
        tec.block_launch_shape(P, trsyms, os_, w, S)


def test_block_launch_shape_takes_the_last_window():
    """The capture may end with the last training window: 4095 * 2 + 17 samples."""
    assert tec.block_launch_shape(_planes(2, 8207), 4096, 2, _taps(2, 2, 17), 256) == (256, 16)


@pytest.mark.parametrize("nmodes, ntaps, K", [(1, 17, 17), (2, 17, 34), (2, 45, 90), (2, 64, 128),
                                              (1, 1, 1), (4, 32, 128)])
def test_seq_launch_shape(nmodes, ntaps, K):
    """One to four taps per lane: K = nmodes * ntaps up to 128."""
    assert tec.seq_launch_shape(_planes(nmodes, 5000), 1000, 2, _taps(nmodes, nmodes, ntaps)) == K


@pytest.mark.parametrize("P, trsyms, os_, w, match", [
    (_planes(2, 5000), 1000, 2, _taps(2, 2, 65), "taps per output mode"),
    (_planes(3, 5000), 1000, 2, _taps(3, 3, 43), "taps per output mode"),
    (_planes(2, 5000), 4096, 2, _taps(2, 2, 17), "shorter"),
    (_planes(2, 5000), 0, 2, _taps(2, 2, 17), "shorter"),
    (_planes(1, 5000), 1000, 2, _taps(2, 2, 17), "do not match"),
    (_planes(2, 5000), 1000, 0, _taps(2, 2, 17), "oversampling"),
])
def test_seq_launch_shape_refuses(P, trsyms, os_, w, match):
    with pytest.raises(ValueError, match=match):
        tec.seq_launch_shape(P, trsyms, os_, w)


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything builds or loads the kernel library."""
    def library():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_build, "library", library)


def _spec(method="mcma"):
    return teq.err_spec(method, teq._reshape_symbols(None, method, 64, np.complex64, 2))


@pytest.mark.parametrize("call", [
    lambda: tec.train_block_cuda(_planes(2, 9000), 4096, 1, 2, 1e-3, _taps(2, 2, 17), _spec(),
                                 True, 256),
    lambda: tec.train_seq_cuda(_planes(2, 9000), 1000, 1, 2, 1e-3, _taps(2, 2, 17),
                               teq._reshape_symbols(None, "cma", 64, np.complex64, 2), "cma"),
    lambda: tec.div_check(torch.ones(8), torch.ones(8)),
    lambda: tec.chain_latencies("cpu"),
], ids=["train_block_cuda", "train_seq_cuda", "div_check", "chain_latencies"])
def test_cuda_entries_refuse_the_cpu_before_any_build(no_build, call):
    """A launcher given CPU tensors raises; it neither builds nor gives way to a plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.parametrize("method", ["mcma", "cma", "rde"])
def test_bare_names_take_the_plain_versions_on_the_cpu(no_build, method):
    """``train_block`` and ``train_seq`` on CPU tensors are the plain versions, bit for bit."""
    rng = np.random.default_rng(3)
    P = torch.as_tensor(rng.standard_normal((4, 1200)).astype(np.float32))
    w0 = torch.as_tensor(teq._init_taps(9, 2, 2, np.complex64))
    syms = teq._reshape_symbols(None, method, 64, np.complex64, 2)
    got = tec.train_seq(P, 200, 2, 2, 1e-3, w0, syms, method, True)
    want = tec.train_seq_plain(P, 200, 2, 2, 1e-3, w0, syms, method, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    spec = teq.err_spec(method, syms)
    got = tec.train_block(P, 512, 2, 2, 1e-3, w0, spec, True, 64)
    want = tec.train_block_plain(P, 512, 2, 2, 1e-3, w0, spec, True, 64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (2, 1024)


# ---------------------------------------------------------------------------
# what backend="auto" asks before it routes to B1, and what the explicit backends say
# ---------------------------------------------------------------------------

def _qam(M):
    from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
    return (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)


def _launch(L=40000, trsyms=4096, os_=2, w=None, S=256):
    return (torch.empty((4, L), device="meta"), trsyms, os_, _taps(2, 2, 17) if w is None else w, S)


def _symbols(method, M):
    return teq._reshape_symbols(None, method, M, np.complex64, 2)


@pytest.mark.parametrize("method, M, launch, takes", [
    ("rde", 64, _launch(), True),
    ("rde", 128, _launch(), True),                      # 33 entries
    ("rde", 256, _launch(), False),                     # 67 entries, the kernels hold 64
    ("mcma", 256, _launch(), True),
    ("mcma", 64, _launch(S=100), False),                # not a multiple of 32
    ("mcma", 64, _launch(S=2048), False),
    ("mcma", 64, _launch(trsyms=20), False),            # a block of 20
    ("mcma", 64, _launch(S=128), True),
    ("sbd", 64, _launch(), True),
    ("sbd", 32, _launch(), True),                       # cross
    ("dd", 128, _launch(), True),
    ("mcma", 64, _launch(w=_taps(2, 2, 4001), L=80000, S=1024), False),   # shared memory
    ("mrde", 64, _launch(), False),
], ids=lambda v: v if isinstance(v, (str, int, bool)) else "launch")
def test_block_kernel_takes_asks_the_launcher(no_build, method, M, launch, takes):
    """``auto`` on the card goes to B1 only for what B1's launcher takes, asked without a build."""
    assert teq.block_kernel_takes(method, _symbols(method, M), 2, launch=launch) is takes
    picked = teq._resolve_backend(
        "auto", launch[4], False,
        lambda bs: teq.block_kernel_takes(method, _symbols(method, M), 2,
                                          launch=(*launch[:4], bs)))
    assert picked == ("cuda_block" if takes else "block", launch[4])


@pytest.mark.parametrize("launch, match", [
    (_launch(L=8000), "shorter than"),                   # a capture shorter than the training
    (_launch(os_=0), "oversampling"),
    ((torch.empty((6, 40000), device="meta"), 4096, 2, _taps(2, 2, 17), 256), "do not match"),
])
def test_auto_raises_on_what_no_backend_takes(no_build, launch, match):
    """Only the kernel's limits send ``auto`` to the plain trainer: a caller's error raises."""
    with pytest.raises(ValueError, match=match) as info:
        teq.block_kernel_takes("mcma", _symbols("mcma", 64), 2, launch=launch)
    assert not isinstance(info.value, tec.KernelLimit)
    with pytest.raises(ValueError, match="at least two points"):
        teq.block_kernel_takes("sbd", np.ones((2, 1), np.complex64), 2, launch=_launch())


def test_auto_resolves_the_block_size_before_it_asks(no_build):
    """block_size=None is 128 on the card, and the launcher's rules see that value."""
    seen = []
    assert teq._resolve_backend("auto", None, False, lambda bs: seen.append(bs) or True) == (
        "cuda_block", 128)
    assert seen == [128]
    assert teq._resolve_backend("auto", None, True, lambda bs: seen.append(bs)) == ("seq", 32)
    assert seen == [128]                  # on the CPU nobody asks
    assert teq._resolve_backend("auto", 64, False, False) == ("block", 64)
    assert teq._resolve_backend("cuda_block", 100, False, False) == ("cuda_block", 100)


@pytest.mark.parametrize("key, npts", [("rect", 0), ("x32", 0), ("warped", 64), ("ring", 256)])
def test_check_block_launch_on_every_grid_kind(no_build, key, npts):
    """The shared memory of a launch grows by a general alphabet's table, three floats a point."""
    from qampy_tpu_torch.workload import warped_qam
    re, im = np.meshgrid(0.5 * (np.arange(8) - 3.5), 0.5 * (np.arange(4) - 1.5), indexing="ij")
    const = {"rect": (re + 1j * im).reshape(-1), "x32": _qam(32), "warped": warped_qam(64),
             "ring": np.exp(2j * np.pi * np.arange(256) / 256) * (1 + np.arange(256) / 256)}[key]
    spec = teq.err_spec("sbd", np.tile(const.astype(np.complex64), (2, 1)))
    S, nblocks, smem = tec.check_block_launch(*_launch(), spec)
    assert (S, nblocks) == (256, 16)
    assert smem == tec.block_smem_bytes(2, 17, 2, 256, npts)
    assert smem - tec.block_smem_bytes(2, 17, 2, 256) == 12 * npts
    assert teq.block_kernel_takes("sbd", np.tile(const, (2, 1)), 2, launch=_launch())


def test_block_smem_bytes_follows_the_layout():
    """The host's count of csrc/equaliser.cu block_layout at the blind chain's shape, by hand."""
    # ring 3 x 4 planes x 540 (512 + 17 + 8, to a multiple of 4), taps 2 x 2 x 20, 25 slices
    # of 12 samples (22 at work) x 2 x 2 x 20, errors 2 x 256 and mu x error 2 x 256 + 4,
    # 4 barriers of 8 bytes
    nsl = -(-256 // 12)
    floats = 3 * 4 * 540 + 2 * 2 * 20 + 2 * nsl * 2 * 20 + 4 * 256 + 4 + 8
    assert tec.block_smem_bytes(2, 17, 2, 256) == 4 * floats
    assert tec.block_smem_bytes(2, 17, 2, 1024) < tec._SMEM_LIMIT < tec.block_smem_bytes(
        2, 4001, 2, 1024)


@pytest.mark.parametrize("call, match", [
    (lambda: tec.check_block_launch(*_launch(), teq.err_spec("rde", _symbols("rde", 256))),
     r"67 entries.*hold 64 \(_MAX_CODES\).*'block' or 'seq'"),
    (lambda: tec.check_block_launch(*_launch(S=100), _spec()),
     r"multiple of 32 up to 1024.*backend 'block'"),
    (lambda: tec.check_block_launch(*_launch(w=_taps(2, 2, 4001), L=80000, S=1024), _spec()),
     r"bytes of shared memory.*shorter block or backend 'block'"),
    (lambda: tec.block_launch_shape(_planes(3, 40000), 4096, 2, _taps(3, 3, 17), 256),
     r"at most 2 output modes \(_MAX_OUT\), got 3.*'block' or 'seq'"),
    (lambda: tec.seq_launch_shape(_planes(2, 5000), 1000, 2, _taps(2, 2, 65)),
     r"128 taps per output mode \(_MAX_SEQ_K\).*'seq', or 'cuda_block'"),
    (lambda: tec.method_code("mrde"), r"'block' and 'seq' take every method"),
    (lambda: teq.err_spec("sbd", np.tile(np.exp(2j * np.pi * np.arange(300) / 300)
                                         * (1 + np.arange(300) / 300), (2, 1))),
     r"300 points.*at most 256 \(MAX_GEN_POINTS\).*'seq' and 'block'"),
], ids=["codebook", "block size", "shared memory", "output modes", "taps", "method", "points"])
def test_refusals_name_the_limit_and_the_backend_to_take(no_build, call, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        call()
