#!/usr/bin/env python3
"""Time the port's trainer kernels B1 and B9 built from two source directories, on one card.

    PYTHONPATH=. python3 tools/torch_compare_trainers.py OLD_CSRC [NEW_CSRC]

``OLD_CSRC`` and ``NEW_CSRC`` (default ``qampy_tpu_torch/csrc``) each hold the
``*.cu`` sources of one state of the kernels, for example an older commit's
unpacked with ``git archive``. Both are built and run in this one process,
in the order old, new, new, old, at the shapes of PERF.md's kernel table:
B9 over the 262,123 training symbols of ``workload.make_tx(2**18)`` (mcma from
the centre taps, rde from the mcma taps) and over 4,096 symbols, B1 over 64
blocks of 256 on ``make_tx(2**20)`` and over 1,023 blocks of 256 (mcma, rde).
Device times with the host hidden behind a spacer kernel; every line ends
with the card's name and power limit. An entry point that an older library
lacks is left out of its binding; sources whose B1 entry has no batch count
are refused.
"""
import pathlib
import subprocess
import sys

import numpy as np
import torch

from qampy_tpu_torch.ops import _build
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops.equaliser_cuda import train_block_cuda, train_seq_cuda
from qampy_tpu_torch.workload import make_tx

SPACER_CYCLES = 200_000_000
SIGNATURES = dict(_build.SIGNATURES)


def use(csrc):
    """Build and bind the kernels of the sources under ``csrc``."""
    _build.library.cache_clear()
    _build.CSRC = pathlib.Path(csrc).resolve()
    text = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    if "qtt_train_block(" in text and "int nbatch" not in text:
        raise SystemExit("%s: B1's C entry there takes no batch count, which the launcher passes; "
                         "sources older than B1's batch axis cannot be timed here" % csrc)
    _build.SIGNATURES.clear()
    _build.SIGNATURES.update({k: v for k, v in SIGNATURES.items() if k + "(" in text})
    _build.library()


def device_ms(fn, reps):
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPACER_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def planes(nsym, dev):
    E, _, _ = make_tx(nsym)
    return torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev), E


def main(argv):
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    old, new = argv[0], argv[1] if len(argv) > 1 else str(_build.CSRC)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    P, E = planes(2 ** 18, dev)
    Pb, _ = planes(2 ** 20, dev)
    w0 = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64), device=dev)
    trs = teq._cal_training_symbol_len(2, 17, E.shape[-1])
    syms = {m: teq._reshape_symbols(None, m, 64, np.complex64, 2) for m in ("mcma", "rde")}
    specs = {m: teq.err_spec(m, syms[m]) for m in syms}
    use(new)
    _, w1, _ = train_seq_cuda(P, trs, 1, 2, 1e-3, w0, syms["mcma"], "mcma", True)
    _, wb1, _ = train_block_cuda(P, trs, 1, 2, 1e-3, w0, specs["mcma"], True, 256)
    # name: (call, repetitions, steps, unit of a step, ms to that unit)
    cases = {
        "B9 mcma, %d symbols" % trs: (
            lambda: train_seq_cuda(P, trs, 1, 2, 1e-3, w0, syms["mcma"], "mcma", True),
            3, trs, "ns per symbol", 1e6),
        "B9 rde, %d symbols" % trs: (
            lambda: train_seq_cuda(P, trs, 1, 2, 1e-3, w1, syms["rde"], "rde", True),
            3, trs, "ns per symbol", 1e6),
        "B9 mcma, 4096 symbols": (
            lambda: train_seq_cuda(P, 4096, 1, 2, 1e-3, w0, syms["mcma"], "mcma", True),
            20, 4096, "ns per symbol", 1e6),
        "B1 mcma, 64 blocks of 256": (
            lambda: train_block_cuda(Pb, 2 ** 14, 1, 2, 1.9e-3, w0, specs["mcma"], True, 256),
            20, 64, "us per block", 1e3),
        "B1 mcma, %d blocks of 256" % (trs // 256): (
            lambda: train_block_cuda(P, trs, 1, 2, 1e-3, w0, specs["mcma"], True, 256),
            5, trs // 256, "us per block", 1e3),
        "B1 rde, %d blocks of 256" % (trs // 256): (
            lambda: train_block_cuda(P, trs, 1, 2, 1e-3, wb1, specs["rde"], True, 256),
            5, trs // 256, "us per block", 1e3),
    }
    times = {}
    for which in (old, new, new, old):
        use(which)
        for name, (fn, reps, _, _, _) in cases.items():
            times.setdefault((name, which), []).append(device_ms(fn, reps))
    for name, (_, _, steps, unit, scale) in cases.items():
        t_old, t_new = times[name, old], times[name, new]
        print("%s: old %.4f, %.4f ms (%.2f %s); new %.4f, %.4f ms (%.2f %s); old / new %.2f [%s]"
              % (name, *t_old, min(t_old) / steps * scale, unit, *t_new,
                 min(t_new) / steps * scale, unit, min(t_old) / min(t_new), card))
    # what the two states compute, on one input
    out = {}
    for which in (old, new):
        use(which)
        out[which] = (train_seq_cuda(P, 4096, 1, 2, 1e-3, w0, syms["mcma"], "mcma", True),
                      train_block_cuda(Pb, 2 ** 14, 1, 2, 1.9e-3, w0, specs["mcma"], True, 256))
    (s_old, b_old), (s_new, b_new) = out[old], out[new]
    print("B9, 4096 symbols: old and new bit-equal: %s"
          % all(torch.equal(a, b) for a, b in zip(s_old, s_new)))
    print("B1, 64 blocks: taps max|d| %.3e, error max|d| %.3e"
          % (float((b_old[1] - b_new[1]).abs().max()), float((b_old[0] - b_new[0]).abs().max())))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
