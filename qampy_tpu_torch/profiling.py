"""Profiling and benchmarking harness (counterpart of ``qampy_tpu/profiling.py``).

The reference's benchmark groups (quantize/decision, BPS, equaliser training
per method, soft LLR, ``apply_filter``, ``select_angles``; QAMpy's
test/test_benchmarks.py) on the port, reported in Msym/s, plus a
``torch.profiler`` trace for the card's timeline.

The receivers' entries, stages and kernel launchers open host spans
(:func:`span`, :func:`spanned`) named ``qtt.<chain>.<entry or stage>`` and
``qtt.B1`` to ``qtt.B10``. They are recorded only while a ``torch.profiler``
records, on its clock, beside the card's activity; otherwise each costs one
check of the profiler's state. ``SPANS`` lists them.

On a CUDA device the three groups that the reference computes in a kernel
run the port's kernels: ``bps`` kernel B3 (``phase_cuda.bps_search``),
``train_<method>`` kernel B1 (``equaliser_cuda.train_block``) and
``apply_filter`` kernel B2 (``equaliser_cuda.apply_filter``). Their launch
limits raise ``KernelLimit`` to the caller. The other three groups, and
every group on the CPU, are plain PyTorch.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from qampy_tpu_torch.utils import resolve_device

GROUP_METHODS = ("cma", "mcma", "rde", "sbd", "mddma", "dd")
TRAIN_TAPS = 40          # the reference's training groups: 40 taps, os 2, blocks of 64
TRAIN_BLOCK = 64
FILTER_TAPS = 17
BPS_ANGLES = 64
BPS_N = 14
LLR_SNR = 100.0

#: the port's host spans: the blind chain's entries, then its stages in the order a call
#: opens them; the pilot chain's the same; the kernel launchers of ``ops/equaliser_cuda.py``
#: and ``ops/phase_cuda.py`` (B2's whole-capture and frame entries both ``qtt.B2``)
SPANS = ("qtt.rx.forward", "qtt.rx.planes", "qtt.rx.with_taps", "qtt.rx.planes_with_taps",
         "qtt.rx.tracking", "qtt.rx.tracking_planes",
         "qtt.rx.train", "qtt.rx.filter", "qtt.rx.search", "qtt.rx.glue", "qtt.rx.derotate",
         "qtt.pilot.planes", "qtt.pilot.forward", "qtt.pilot.tracking_planes",
         "qtt.pilot.tracking",
         "qtt.pilot.input", "qtt.pilot.prefix", "qtt.pilot.frames", "qtt.pilot.cpe",
         "qtt.pilot.derotate", "qtt.pilot.payload",
         *("qtt.B%d" % k for k in range(1, 11)))

_profiling = torch.autograd._profiler_enabled
#: a record of one host range, cheaper to enter than ``torch.profiler.record_function``;
#: the same event on the host, without its mirror on the card's timeline
_record = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def span(name):
    """A context manager that records the host range ``name`` while a profiler records.

    With no ``torch.profiler`` recording it is a shared no-op, after one
    check of the profiler's state; while one records (``trace``, or any
    ``torch.profiler.profile``) it is a host event of the profiler's own,
    on the clock of the card's activity, so that every stretch of that
    timeline can be put down to the span that was open. Nothing else turns
    spans on or off.
    """
    return _record(name) if _profiling() else _OFF


def spanned(name):
    """Decorator: each call of the function runs inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with _record(name):
                return fn(*args, **kwargs)
        return run
    return wrap


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the block with ``torch.profiler``; write a Chrome trace under ``logdir``.

    The card's activity is traced where there is a card. Yields ``logdir``
    (by default ``qampy_tpu_torch_trace`` in the temporary directory); the
    trace is ``trace.json`` there, for ``chrome://tracing`` or Perfetto.
    The receivers' spans (``SPANS``: entries, stages, kernel launchers) show
    in it as host events around the operations they hold.
    """
    logdir = logdir or os.path.join(tempfile.gettempdir(), "qampy_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _on_card(args):
    for a in args:
        if torch.is_tensor(a) and a.is_cuda:
            return True
        if isinstance(a, (tuple, list)) and _on_card(a):
            return True
    return False


def time_fn(fn, *args, reps=5, warmup=1):
    """Median seconds of ``fn(*args)`` over ``reps`` calls after ``warmup`` calls.

    Wall clock; where an argument lies on the card the device is
    synchronised before and after each call, so that a call's time holds
    its device work.
    """
    card = _on_card(args)
    sync = torch.cuda.synchronize if card else (lambda: None)
    for _ in range(warmup):
        fn(*args)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


class Group(NamedTuple):
    """One benchmark group: ``fn(*args)`` processes ``items`` symbols by ``route``.

    ``route`` is the kernel a CUDA device runs ("B1", "B2", "B3"), or
    "plain" for plain PyTorch (every group on the CPU; ``decision``,
    ``soft_llr`` and ``select_angles`` everywhere, as the reference computes
    them outside any kernel).
    """
    fn: Callable
    args: tuple
    items: int
    route: str


def group_inputs(nsyms=2 ** 18, M=64):
    """The reference's inputs as host arrays, drawn by numpy from seed 0 in its order
    (``qampy_tpu/profiling.py:52-96``): const, z, angles, E2, idx."""
    from qampy_tpu_torch.theory import cal_scaling_factor_qam, cal_symbols_qam
    rng = np.random.default_rng(0)
    const = (cal_symbols_qam(M) / np.sqrt(cal_scaling_factor_qam(M))).astype(np.complex64)
    z = (rng.standard_normal(nsyms) + 1j * rng.standard_normal(nsyms)).astype(np.complex64) * 0.7
    angles = np.linspace(-np.pi / 4, np.pi / 4, BPS_ANGLES, endpoint=False,
                         dtype=np.float32).reshape(1, -1)
    E2 = (rng.standard_normal((2, 2 * nsyms // 4))
          + 1j * rng.standard_normal((2, 2 * nsyms // 4))).astype(np.complex64)
    idx = rng.integers(0, BPS_ANGLES, nsyms).astype(np.int32)
    return const, z, angles, E2, idx


def benchmark_groups(nsyms=2 ** 18, M=64, methods=GROUP_METHODS, device=None):
    """The reference's groups (``qampy_tpu/profiling.py:42-98``) as ``{name: Group}``.

    Inputs from :func:`group_inputs`, on ``device`` (None: the card).
    """
    from qampy_tpu_torch.core import metrics
    from qampy_tpu_torch.ops import equaliser as eqops
    from qampy_tpu_torch.ops import phase as phops
    from qampy_tpu_torch.ops.equaliser_cuda import apply_filter, train_block
    from qampy_tpu_torch.ops.phase_cuda import bps_search

    dev = resolve_device(device)
    card = dev.type == "cuda"
    const, z, angles, E2, idx = group_inputs(nsyms, M)
    zd = torch.as_tensor(z, device=dev)
    constd = torch.as_tensor(const, device=dev)
    groups = {"decision": Group(metrics.decision_idx, (zd, constd), nsyms, "plain")}

    grid = phops.detect_grid(const)
    cos_t, sin_t = (torch.as_tensor(t, device=dev) for t in phops.bps_tables(angles[0], grid))
    points = (torch.as_tensor(phops.gen_points(grid), device=dev) if grid[0] == "gen"
              else None)
    er, ei = zd.real[None].contiguous(), zd.imag[None].contiguous()
    groups["bps"] = Group(bps_search, (er, ei, cos_t, sin_t, grid, BPS_N, points), nsyms,
                          "B3" if card else "plain")

    P2 = eqops.planes(torch.as_tensor(E2, device=dev))
    trs = (E2.shape[-1] - TRAIN_TAPS) // 2
    w0 = torch.as_tensor(eqops._init_taps(TRAIN_TAPS, 2, 2, np.complex64), device=dev)
    for method in methods:
        spec = eqops.err_spec(method, eqops._reshape_symbols(None, method, M, np.complex64, 2))
        groups["train_" + method] = Group(
            lambda *a: train_block(*a, adaptive=True, block_size=TRAIN_BLOCK, points=points),
            (P2, trs, 1, 2, 1e-3, w0, spec), trs * 2, "B1" if card else "plain")

    wx = torch.as_tensor(eqops._init_taps(FILTER_TAPS, 2, 2, np.complex64), device=dev)
    groups["apply_filter"] = Group(apply_filter, (P2, 2, wx), (E2.shape[-1] // 2) * 2,
                                   "B2" if card else "plain")

    bitmap = torch.as_tensor(_bitmap(M), device=dev)
    groups["soft_llr"] = Group(metrics.soft_l_value_demapper, (zd, LLR_SNR, bitmap), nsyms,
                               "plain")
    ang2 = torch.as_tensor(np.tile(angles, (nsyms, 1)), device=dev)
    groups["select_angles"] = Group(phops.select_angles, (ang2, torch.as_tensor(idx, device=dev)),
                                    nsyms, "plain")
    return groups


def run_benchmarks(nsyms=2 ** 18, M=64, reps=5, methods=GROUP_METHODS, device=None,
                   routes=False):
    """The reference's benchmark groups on ``device`` (None: the card): ``{name: Msym/s}``.

    With ``routes=True`` returns (``{name: Msym/s}``, ``{name: route}``),
    the route as in :class:`Group`.
    """
    groups = benchmark_groups(nsyms, M, methods, device)
    res = {name: g.items / time_fn(g.fn, *g.args, reps=reps) / 1e6 for name, g in groups.items()}
    if routes:
        return res, {name: g.route for name, g in groups.items()}
    return res


def _bitmap(M):
    """The (bits, M/2, 2) bit map of Gray-coded M-QAM, from the port's signal object."""
    from qampy_tpu_torch.signals import SignalQAMGrayCoded
    return SignalQAMGrayCoded(M, 64, seed=0, device="cpu").bitmap_mtx


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--nsyms", type=int, default=2 ** 18)
    a = ap.parse_args()
    res, rts = run_benchmarks(nsyms=a.nsyms, device=a.device, routes=True)
    print(json.dumps({k: {"Msym/s": round(v, 2), "route": rts[k]} for k, v in res.items()},
                     indent=1))
