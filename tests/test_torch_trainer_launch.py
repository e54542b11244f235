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
