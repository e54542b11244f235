"""The reduction of a traced span to the per-layer metrics, on a synthetic profiler trace."""
import pytest

from benchmark.lib import roofline, spec, trace

BENCH = spec.BENCH


def synthetic():
    """A 1000 us span, two dispatches: B2 and B4 kernels, a plain copy, an idle stretch in
    which the host sits in a ``torch.cat`` of the second enqueue."""
    device = [
        ("void apply_filter_kernel<2, 1, 6>(float const*, int)", 100.0, 300.0),
        ("void apply_filter_frames_kernel<2, 10>(float const*)", 250.0, 350.0),   # overlaps
        ("interp_rotate_kernel(float const*)", 350.0, 400.0),
        ("Memcpy DtoD (Device -> Device)", 600.0, 700.0),
        ("void at::native::vectorized_elementwise_kernel<4>(...)", 700.0, 750.0),
        ("before the span", -50.0, 20.0),
    ]
    host = [
        ("bench.trace", 0.0, 1000.0),
        ("bench.enqueue", 10.0, 420.0),
        ("aten::pad", 20.0, 90.0),
        ("bench.enqueue", 430.0, 800.0),
        ("aten::cat", 440.0, 590.0),
        ("aten::empty", 445.0, 450.0),
        ("bench.wait", 800.0, 990.0),
    ]
    return trace.Trace(device, host, 0.0, 1000.0, dispatches=2, host_ms=[0.4, 0.3, 0.5],
                       work={"filter": (3.35e6, 0.0), "derotate": (0.0, 67e6 * 0.5)})


def test_busy_and_idle():
    tr = synthetic()
    # busy: [0, 20] + [100, 400] + [600, 750] = 470 us of the 1000
    assert trace.busy_s(tr) == pytest.approx(470e-6)
    assert spec.reader("device_idle.track", BENCH).read(tr) == pytest.approx(53.0)
    assert trace.gaps(tr) == [(20.0, 100.0), (400.0, 600.0), (750.0, 1000.0)]


def test_kernel_time_per_dispatch_by_whole_names():
    tr = synthetic()
    assert trace.name_matches("void apply_filter_kernel<2>(x)", ["apply_filter_kernel"])
    assert not trace.name_matches("apply_filter_frames_kernel", ["apply_filter_kernel"])
    assert not trace.name_matches("bps_kernel_bf16(x)", ["bps_kernel"])
    ms = trace.per_dispatch_ms(tr, lambda n: trace.name_matches(n, ["apply_filter_kernel"]))
    assert ms == pytest.approx(0.1)          # 200 us over 2 dispatches
    assert trace.per_dispatch_ms(tr, lambda n: "nothing" in n) is None


def test_roofline_share():
    tr = synthetic()
    # filter: 3.35 MB at 3.35 TB/s = 1 us bound; B2 kernels 200 + 100 us over 2 dispatches
    assert spec.reader("roofline.filter.track", BENCH).read(tr) == pytest.approx(100 * 1e-3 / 0.15)
    # derotate: 0.5 * 67 MFLOP at 67 TFLOP/s = 0.5 us; 50 us over 2 dispatches
    assert spec.reader("roofline.derotate.track", BENCH).read(tr) == pytest.approx(100 * 0.5e-3 / 0.025)
    assert roofline.bound_s(3.35e6, 67e6) == pytest.approx(1e-6)
    # a stage the cell does not have, or kernels that did not run, read nothing
    assert spec.reader("roofline.train", BENCH).read(tr) is None
    assert spec.reader("roofline.search.stream", BENCH).read(tr) is None


def test_plain_ms_counts_what_no_port_kernel_does():
    tr = synthetic()
    # the copy (100 us), the elementwise kernel (50) and the part of the early op in the span
    assert spec.reader("plain_ms.track", BENCH).read(tr) == pytest.approx((100 + 50 + 20) / 2 / 1e3)


def test_host_ms_is_the_median_outside_the_span():
    assert spec.reader("host_ms.stream", BENCH).read(synthetic()) == pytest.approx(0.4)


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(synthetic())
    assert b["device_ops"][0] == ["void apply_filter_kernel<2, 1, 6>(float const*, int)",
                                  pytest.approx(200e-6)]
    assert len(b["device_ops"]) == 6
    gaps = b["idle_gaps"]
    # each gap is named by what the host was doing when the card went idle
    assert gaps[0] == ["bench.enqueue", pytest.approx(250e-6)]       # 750 .. 1000
    assert gaps[1] == ["bench.enqueue", pytest.approx(200e-6)]       # 400 .. 600
    assert gaps[2] == ["bench.enqueue/aten::pad", pytest.approx(80e-6)]


def test_gap_labels_name_the_innermost_operation():
    tr = synthetic()
    assert trace.host_at(tr, 446.0) == "bench.enqueue/aten::empty"
    assert trace.host_at(tr, 500.0) == "bench.enqueue/aten::cat"
    assert trace.host_at(tr, 995.0) == "outside the harness's spans"
