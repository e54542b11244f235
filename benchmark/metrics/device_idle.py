"""device_idle: percent of the traced span with nothing on the card.

The span less the union of the device intervals that torch.profiler recorded,
over the span. Moves msym_s: an idle card is a host that does not keep up.
"""
from benchmark.lib import trace


def read(tr):
    busy = trace.busy_s(tr)
    if busy <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - busy) / tr.window_s
