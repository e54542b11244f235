"""stage_ms.filter: host ms a dispatch inside the blind chain's ``qtt.rx.filter`` span.

The stage: the strided MIMO filter (B2) with its side output. The span's host time,
clipped to the traced span, over the entry spans that start inside it
(``benchmark/lib/spans.py``). A traced reading: the tracer slows every launch, so the
stages add up to more than the untraced host_ms; compare it stage with stage, and parent
with change.
"""
from benchmark.lib import spans

STAGE = "filter"


def read(tr):
    return spans.span_ms(tr, "qtt.rx." + STAGE)
