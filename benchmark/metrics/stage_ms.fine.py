"""stage_ms.fine: host ms a dispatch inside the blind chain's ``qtt.rx.fine`` span.

The stage: the two-stage search's coarse phase, built from the coarse search's indices,
and the fine search (B8). The span's host time, clipped to the traced span, over the entry
spans that start inside it (``benchmark/lib/spans.py``); None for a program without the
span. A traced reading: the tracer slows every launch, so the stages add up to more than
the untraced host_ms; compare it stage with stage, and parent with change.
"""
from benchmark.lib import spans

STAGE = "fine"


def read(tr):
    return spans.span_ms(tr, "qtt.rx." + STAGE)
