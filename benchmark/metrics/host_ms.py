"""host_ms: host ms a dispatch in the entry call (the harness's span, no sync added).

The median over the window's dispatches before the profiler starts: once the
tracer is loaded, every launch costs the host more. Moves msym_s wherever the
host sets the pace.
"""
from statistics import median


def read(tr):
    return median(tr.host_ms) if tr.host_ms else None
