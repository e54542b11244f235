"""The measured window: a closed loop with a fixed number of dispatches in flight.

A caller who double-buffers captures enqueues dispatch i + 1 while the card
runs dispatch i; before it enqueues one more, it waits on the oldest
dispatch's completion event. Each dispatch is timed from the harness's call
into the entry to the moment the host sees its completion. The window runs for
a fixed time; the dispatches still in flight when it closes are waited for and
timed, but only those completed inside it count towards the rate.
"""
from __future__ import annotations

import math
import random
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

#: dispatches between the profiler's start and the traced span
WARM_DISPATCHES = 2


@dataclass
class Window:
    seconds: float
    start: float = 0.0                            # the window's opening, s on the clock
    calls: list = field(default_factory=list)    # [t_call, t_ret, t_done, trace state] a dispatch
    nsym: int = 0                                 # symbols returned by each dispatch
    kept: list = field(default_factory=list)     # (dispatch, pool index, outputs): the sample,
                                                  # one dispatch of each capture of the pool
    trace: object = None                          # profiler events of the traced span, if any
    traced: int = 0                               # dispatches enqueued inside the traced span

    def latencies_ms(self):
        return [(d - c) * 1e3 for c, _, d, _ in self.calls]

    def completed(self):
        """Dispatches whose completion the host saw inside the window."""
        return sum(1 for _, _, d, _ in self.calls if d - self.start <= self.seconds)


def percentile(values, q):
    """The nearest-rank q-th percentile: the least value with at least q % of values at or below."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def msym_per_s(w):
    """Millions of symbols a second: those of the dispatches completed inside the window,
    over the window's length."""
    return w.completed() * w.nsym / 1e6 / w.seconds


def run(call, pool, nsym, seconds, depth, marker, keep=False, seed=0, trace_span=None,
        profiler=None, clock=time.perf_counter):
    """Drive ``call(k)`` (k the pool index, cycled in order) for ``seconds``: a :class:`Window`.

    ``marker()`` records a completion event after each call and returns an
    object whose ``wait()`` blocks until the card has reached it. With
    ``keep``, one dispatch of each capture k of the pool is sampled from all
    of k's dispatches by a reservoir seeded with ``seed``. With ``trace_span`` = (a, d) seconds and a ``profiler``
    (``torch.profiler.profile``, not started), the loop starts the profiler at
    the first dispatch boundary a seconds into the window, opens the
    ``bench.trace`` span WARM_DISPATCHES dispatches later (the tracer's first
    launches are slow) and closes both, drained, at the first boundary d
    seconds after the span opened. Each call's record carries the trace state
    it was enqueued in: "before", "warming", "in" or "after".
    """
    if profiler is not None:
        from torch.profiler import record_function as span
    else:
        def span(_name):
            return nullcontext()
    rng = random.Random(seed)
    w = Window(seconds=seconds, nsym=nsym)
    inflight = deque()
    state, outer, t_in, warm = "before", None, None, 0

    def wait_oldest():
        j, ev = inflight.popleft()
        ev.wait()
        w.calls[j][2] = clock()

    def drain():
        with span("bench.drain"):
            while inflight:
                wait_oldest()

    t0 = w.start = clock()
    i = 0
    while True:
        now = clock() - t0
        if now >= seconds and state not in ("warming", "in"):    # a traced span runs to its end
            break
        if trace_span is not None and state == "before" and now >= trace_span[0]:
            profiler.start()
            state, warm = "warming", WARM_DISPATCHES
        elif state == "warming" and warm == 0:
            outer = span("bench.trace")
            outer.__enter__()
            state, t_in = "in", clock()
        elif state == "in" and clock() - t_in >= trace_span[1]:
            drain()
            outer.__exit__(None, None, None)
            profiler.stop()
            state = "after"
        if len(inflight) >= depth:
            with span("bench.wait"):
                wait_oldest()
        k = i % pool
        with span("bench.enqueue"):
            t_call = clock()
            out = call(k)
            t_ret = clock()
            inflight.append((i, marker()))
        w.calls.append([t_call, t_ret, None, state])
        w.traced += state == "in"
        if state == "warming":
            warm -= 1
        if keep:
            if len(w.kept) < pool:
                w.kept.append((i, k, out))
            elif rng.randrange(i // pool + 1) == 0:      # capture k's (i // pool + 1)-th dispatch
                w.kept[k] = (i, k, out)
        del out
        i += 1
    drain()
    if state == "in":
        outer.__exit__(None, None, None)
        profiler.stop()
    if trace_span is not None:
        w.trace = profiler
    return w
