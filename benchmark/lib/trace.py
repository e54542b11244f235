"""The traced span of a window, reduced from ``torch.profiler``'s events.

A :class:`Trace` holds what the per-layer readers read: the device operations
(name, start, end in microseconds), the host spans that the harness opened
(``bench.enqueue``, ``bench.wait``, ``bench.drain``) and the program's host
operations inside them, the span's bounds, the dispatches enqueued in it, the
host time of each dispatch before it, and each stage's (bytes, ops) per
dispatch. Nothing here reads the program: kernel names come from the metric's
own file.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from benchmark.lib import roofline

#: the names of the harness's own host spans; the program's operations nest inside them
SPAN_PREFIX = "bench."


@dataclass
class Trace:
    device: list            # (name, start_us, end_us) of every operation on the card
    host: list              # (name, start_us, end_us) of the host's spans and operations
    lo: float               # the traced span, microseconds, in the events' time base
    hi: float
    dispatches: int         # dispatches enqueued inside the traced span
    host_ms: list = field(default_factory=list)   # host ms of each entry call before it
    work: dict = field(default_factory=dict)      # stage -> (bytes, ops) per dispatch

    @property
    def window_s(self):
        return (self.hi - self.lo) / 1e6


def from_profiler(prof, span_name="bench.trace"):
    """(device ops, host ops, lo, hi) from a finished ``torch.profiler.profile``.

    The span's bounds are those of the host span named ``span_name``, which the
    harness opens after the profiler starts and closes before it stops.
    """
    import torch
    device, host = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(rec)
        elif not (e.name.startswith(SPAN_PREFIX) or getattr(e, "is_user_annotation", False)):
            device.append(rec)      # not the harness's spans, which the trace mirrors on the card
    spans = [h for h in host if h[0] == span_name]
    if not spans:
        raise RuntimeError("the profiler recorded no %r span" % span_name)
    return device, host, spans[0][1], spans[0][2]


def clip(intervals, lo, hi):
    """The parts of (start, end) intervals inside [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def union(intervals):
    """Disjoint sorted intervals covering the same time."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(tr):
    """Seconds of the traced span in which something ran on the card."""
    return sum(e - s for s, e in union(clip([(s, e) for _, s, e in tr.device], tr.lo, tr.hi))) / 1e6


def gaps(tr):
    """(start, end) of every interval of the traced span with nothing on the card."""
    busy = union(clip([(s, e) for _, s, e in tr.device], tr.lo, tr.hi))
    out, t = [], tr.lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < tr.hi:
        out.append((t, tr.hi))
    return out


def host_at(tr, t):
    """What the host was doing at time t: the innermost harness span, and the innermost
    operation inside it (``bench.enqueue/aten::cat``)."""
    around = [h for h in tr.host if h[1] <= t < h[2] and h[0] != "bench.trace"]
    spans = [h for h in around if h[0].startswith(SPAN_PREFIX)]
    if not spans:
        return "outside the harness's spans"
    span = max(spans, key=lambda h: h[1])
    inner = [h for h in around if not h[0].startswith(SPAN_PREFIX) and h[1] >= span[1]]
    if not inner:
        return span[0]
    return "%s/%s" % (span[0], max(inner, key=lambda h: (h[1], -h[2]))[0])


def name_matches(name, kernels):
    """Whether a device operation's name is one of ``kernels`` (whole identifiers)."""
    return any(re.search(r"(?<![A-Za-z0-9_])%s(?![A-Za-z0-9_])" % re.escape(k), name)
               for k in kernels)


def device_s(tr, keep):
    """Seconds on the card, inside the traced span, of the operations whose name ``keep`` takes."""
    return sum(e2 - s2 for n, s, e in tr.device if keep(n)
               for s2, e2 in clip([(s, e)], tr.lo, tr.hi)) / 1e6


def per_dispatch_ms(tr, keep):
    """Device ms per dispatch of the operations ``keep`` takes; None where none ran."""
    if tr.dispatches == 0:
        return None
    t = device_s(tr, keep)
    return t * 1e3 / tr.dispatches if t > 0 else None


def roofline_share(tr, stage, kernels):
    """Percent of the stage's bound in its kernels' device time per dispatch; None where the
    kernels did not run or the cell has no such stage."""
    if stage not in tr.work:
        return None
    ms = per_dispatch_ms(tr, lambda n: name_matches(n, kernels))
    if ms is None:
        return None
    return 100.0 * roofline.bound_s(*tr.work[stage]) * 1e3 / ms


def breakdown(tr, top=10):
    """The contract's ``breakdown``: the device operations that took most time, by name, and
    the longest idle gaps, each named by what the host was doing when it opened."""
    by_name = {}
    for n, s, e in tr.device:
        for s2, e2 in clip([(s, e)], tr.lo, tr.hi):
            by_name[n] = by_name.get(n, 0.0) + (e2 - s2) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[host_at(tr, s), (e - s) / 1e6] for s, e in idle]}
