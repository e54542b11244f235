"""stage_ms.search: host ms a dispatch inside the blind chain's ``qtt.rx.search`` span.

The stage: the decimated phase search (B3). The span's host time, clipped to the traced
span, over the entry spans that start inside it (``benchmark/lib/spans.py``). A traced
reading: the tracer slows every launch, so the stages add up to more than the untraced
host_ms; compare it stage with stage, and parent with change.
"""
from benchmark.lib import spans

STAGE = "search"


def read(tr):
    return spans.span_ms(tr, "qtt.rx." + STAGE)
