"""Per-dispatch readings of the program's own host spans in a traced span.

The program names its host spans ``qtt.`` (its C library's prefix): one entry
span a dispatch (``qtt.rx.planes_with_taps``, ``qtt.pilot.tracking_planes``),
its stages' spans inside it (``qtt.rx.train``) and its kernel launchers'
inside those (``qtt.B1``). They are :class:`trace.Trace` ``host`` events like
the harness's spans, the aten operations and the CUDA runtime calls, on the
same clock. An *entry span* is a program span that no other program span
contains; each reading here is per dispatch over the entry spans that start
inside the traced span, and None where there are none (a program without
spans).
"""
from __future__ import annotations

import bisect

from benchmark.lib import trace

#: the program's span names start so; the harness keeps ``bench.`` for its own
PREFIX = "qtt."
#: CUDA runtime and driver calls that enqueue work on the card
LAUNCH_CALLS = ("cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaGraphLaunch")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
#: runtime calls that block the host until the card has done its work
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def is_launch(name):
    return name in LAUNCH_CALLS or name.startswith(LAUNCH_PREFIXES)


def is_sync(name):
    return name in SYNC_CALLS


def entries(tr):
    """(start, end) of the entry spans that start inside the traced span, in order."""
    out = []
    for _, s, e in sorted((h for h in tr.host if h[0].startswith(PREFIX)),
                          key=lambda h: (h[1], -h[2])):
        if not (out and s < out[-1][1] and e <= out[-1][1]):   # not inside the one before
            out.append((s, e))
    return [(s, e) for s, e in out if tr.lo <= s < tr.hi]


def count_per_dispatch(tr, keep):
    """Host events that ``keep`` takes by name and that start inside an entry span, a
    dispatch; None where no entry span started inside the traced span."""
    ents = entries(tr)
    if not ents:
        return None
    starts = sorted(s for n, s, _ in tr.host if keep(n))
    return sum(bisect.bisect_left(starts, hi) - bisect.bisect_left(starts, lo)
               for lo, hi in ents) / len(ents)


def span_ms(tr, name):
    """Host ms a dispatch inside the spans called ``name`` (nested ones counted once),
    clipped to the traced span; None where no such span or no entry span is there."""
    ents = entries(tr)
    if not ents:
        return None
    held = trace.union(trace.clip([(s, e) for n, s, e in tr.host if n == name], tr.lo, tr.hi))
    if not held:
        return None
    return sum(e - s for s, e in held) / 1e3 / len(ents)
