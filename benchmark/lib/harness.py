"""One run of a cell: set-up, the measured window, the check, the result line.

``measure`` is the whole run after the look for a card, on any device, so that
the CPU tests drive it at small sizes; ``benchmark/run.py`` adds the look, the
environment and the printing.
"""
from __future__ import annotations

import gc
import sys
import time

from benchmark.gen import seeds
from benchmark.lib import loop, spec, trace

#: modules the process must not hold once the window has closed (top-level names, whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "qampy_tpu")
#: the traced span: the profiler starts TRACE_AT seconds into the window and the span lasts
#: TRACE_FOR seconds (a quarter and a half of a shorter window); the dispatches before the
#: profiler's start give host_ms (once the tracer is loaded, every launch costs more)
TRACE_AT, TRACE_FOR = 1.0, 0.5


class Forbidden(RuntimeError):
    pass


def forbidden_modules(modules=None):
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


class Phases:
    """Seconds of each phase of set-up, each ended on the card: ``notes["setup_<phase>_s"]``."""

    def __init__(self, device):
        self.cuda, self.t, self.notes = device.type == "cuda", time.perf_counter(), {}

    def __call__(self, name):
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.notes["setup_%s_s" % name], self.t = t - self.t, t


class _Event:
    def __init__(self, torch):
        self.ev = torch.cuda.Event()
        self.ev.record()

    def wait(self):
        self.ev.synchronize()


class _Done:
    def wait(self):
        pass


def trace_span(seconds):
    if seconds >= 2 * (TRACE_AT + TRACE_FOR):
        return TRACE_AT, TRACE_FOR
    return seconds / 4, seconds / 2


def window(cell, sut, seed, seconds, device, profiler=None):
    """The measured window of the system ``sut``: a :class:`loop.Window` holding the cell's
    sample of outputs, drawn from the seed; traced where a ``profiler`` is given."""
    import torch
    if torch.device(device).type == "cuda":
        def marker():
            return _Event(torch)
    else:
        marker = _Done
    return loop.run(sut.call, sut.pool, sut.nsym, seconds, sut.depth, marker,
                    keep=True, seed=seeds.part(seed, -1),
                    trace_span=None if profiler is None else trace_span(seconds),
                    profiler=profiler)


def measure(cell, seed, seconds, traced, device, t0):
    """Run ``cell`` once: (result dict, compared numbers [(name, value, limit, sense)]).

    ``t0`` is the process's start on ``time.perf_counter``; set-up runs from it
    to the first timed dispatch. Raises :class:`Forbidden` if JAX or the JAX
    package is loaded once the window has closed.
    """
    import torch
    cuda = torch.device(device).type == "cuda"
    mod = spec.system(cell.config["system"], cell.bench)
    if cuda:
        torch.zeros(1, device=device)               # the card's context
    started = time.perf_counter() - t0          # the interpreter, the imports, the context
    sut = mod.System(cell.config, cell.traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    w = window(cell, sut, seed, seconds, device, prof)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise Forbidden("the process holds %s once the window has closed" % ", ".join(found))
    tr = None
    if traced:
        dev_ops, host_ops, lo, hi = trace.from_profiler(w.trace)
        tr = trace.Trace(dev_ops, host_ops, lo, hi, w.traced,
                         [(r - c) * 1e3 for c, r, _, st in w.calls if st == "before"],
                         sut.work())
        w.trace = prof = None
    sut.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    compared = sut.check(w.kept)
    w.kept.clear()
    correct = all(v <= lim if sense == "max" else v >= lim for _, v, lim, sense in compared)
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"], cell.bench).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"msym_s": loop.msym_per_s(w),
               "dispatch_ms_p95": loop.percentile(w.latencies_ms(), 95),
               "setup_s": setup_s}
        # a metric's name is the quantity, then the traffic it is held for (``msym_s.track``)
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    result = {"correct": bool(correct), "attempted": len(w.calls),
              "failed": 0 if correct else sut.pool,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if traced:
        result["device"]["busy_s"] = trace.busy_s(tr)
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = trace.breakdown(tr)
    lat, host = w.latencies_ms(), [(r - c) * 1e3 for c, r, _, _ in w.calls]
    result["notes"] = dict(sut.notes, setup_start_s=started, completed=w.completed(),
                           traced_dispatches=w.traced, host_ms_mean=sum(host) / len(host),
                           **{"dispatch_ms_p%d" % q: loop.percentile(lat, q) for q in (50, 99)},
                           dispatch_ms_max=max(lat),
                           completed_per_s=[sum(1 for _, _, d, _ in w.calls
                                                if s <= d - w.start < s + 1)
                                            for s in range(int(seconds))])
    result["compared"] = {n: {"value": v, "limit": lim, "holds": "<=" if s == "max" else ">="}
                          for n, v, lim, s in compared}
    return result, compared
