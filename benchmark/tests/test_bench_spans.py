"""The readers of the program's own spans (``benchmark/lib/spans.py``): launches and syncs
a dispatch, and each blind stage's host ms a dispatch.

On synthetic traces, then on one traced run of the stream cell at the small sizes of
``conftest.SMALL`` on the CPU, where the program's spans are recorded and no CUDA call is.
"""
import time

import pytest

from benchmark.lib import harness, spans, spec, trace

BENCH = spec.BENCH
STAGES = ("train", "filter", "search", "glue", "derotate")


def synthetic():
    """A 1000 us span with two whole dispatches and the tail of one begun before it.

    Dispatch 1 (100-400): train 110-200 (B1 inside it), filter 200-250, glue 300-380, in
    which a stray nested glue span 310-320; dispatch 2 (500-800): filter 520-600, glue
    650-700. Runtime calls inside and outside the entry spans."""
    host = [
        ("bench.trace", 0.0, 1000.0),
        ("qtt.rx.planes_with_taps", -300.0, 50.0),          # begun before the span
        ("qtt.rx.glue", -100.0, 30.0),
        ("cudaLaunchKernel", 20.0, 22.0),                   # inside it, before the span
        ("bench.enqueue", 90.0, 410.0),
        ("qtt.rx.planes_with_taps", 100.0, 400.0),
        ("qtt.rx.train", 110.0, 200.0),
        ("qtt.B1", 120.0, 190.0),
        ("cudaLaunchKernel", 150.0, 151.0),
        ("cudaLaunchKernelExC", 160.0, 161.0),
        ("qtt.rx.filter", 200.0, 250.0),
        ("cuLaunchKernel", 230.0, 231.0),
        ("cudaMemsetAsync", 240.0, 241.0),
        ("qtt.rx.glue", 300.0, 380.0),
        ("qtt.rx.glue", 310.0, 320.0),
        ("cudaMemcpyAsync", 330.0, 331.0),
        ("cudaStreamSynchronize", 350.0, 360.0),
        ("aten::cumsum", 340.0, 345.0),
        ("bench.wait", 420.0, 480.0),
        ("cudaEventSynchronize", 430.0, 470.0),             # the harness's, outside any entry
        ("qtt.rx.planes_with_taps", 500.0, 800.0),
        ("qtt.rx.filter", 520.0, 600.0),
        ("cudaLaunchKernel", 530.0, 531.0),
        ("cudaMemcpy", 560.0, 570.0),
        ("qtt.rx.glue", 650.0, 700.0),
        ("cudaGraphLaunch", 660.0, 661.0),
        ("cudaLaunchKernel", 900.0, 901.0),                 # after the entries
    ]
    return trace.Trace([], host, 0.0, 1000.0, dispatches=2)


def test_entry_spans_are_those_no_program_span_holds():
    tr = synthetic()
    assert spans.entries(tr) == [(100.0, 400.0), (500.0, 800.0)]
    # an idle gap that opens in a launcher is named by its span inside the harness's
    assert trace.host_at(tr, 155.0) == "bench.enqueue/qtt.B1"


def test_launches_and_syncs_count_the_calls_inside_entry_spans():
    tr = synthetic()
    # 1: two kernel launches, a driver launch, a memset, a copy; 2: a launch, a graph
    assert spec.reader("launches.stream", BENCH).read(tr) == pytest.approx(7 / 2)
    # 1: a stream sync; 2: a blocking copy; the harness's event sync is outside the entries
    assert spec.reader("syncs.track", BENCH).read(tr) == pytest.approx(2 / 2)
    assert spans.is_launch("cudaLaunchKernelExC") and not spans.is_launch("cudaMemcpy")
    assert spans.is_sync("cudaMemcpy") and not spans.is_sync("cudaMemcpyAsync")


def test_stage_ms_is_each_stage_a_dispatch_clipped_and_counted_once():
    tr = synthetic()
    read = {st: spec.reader("stage_ms.%s" % st, BENCH).read(tr) for st in STAGES}
    assert read["train"] == pytest.approx(90e-3 / 2)
    assert read["filter"] == pytest.approx(130e-3 / 2)
    # 0-30 of the span begun before, 300-380 (the nested span inside), 650-700
    assert read["glue"] == pytest.approx(160e-3 / 2)
    assert read["search"] is None and read["derotate"] is None
    assert all(spec.reader("stage_ms.%s" % st, BENCH).STAGE == st for st in STAGES)


def test_a_program_without_spans_reads_nothing():
    tr = synthetic()
    tr.host = [h for h in tr.host if not h[0].startswith("qtt.")]
    names = ["launches.stream", "syncs.pilot"] + ["stage_ms.%s" % st for st in STAGES]
    assert all(spec.reader(n, BENCH).read(tr) is None for n in names)
    tr.host = []
    assert spans.entries(tr) == []


def test_a_traced_run_of_the_stream_cell_reads_the_spans(small_root):
    cell = spec.cell(small_root, "blind64-d16.stream", bench=small_root / "benchmark")
    res, _ = harness.measure(cell, 3, 2.0, True, "cpu", time.perf_counter())
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(m["stage_ms.%s" % st] > 0 for st in STAGES), m
    assert m["launches.stream"] == 0 and m["syncs.stream"] == 0      # no CUDA call on the CPU
