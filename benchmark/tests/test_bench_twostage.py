"""The two-stage blind cell: its system, counts, faults, control and new readers, on the CPU.

The system (``systems/blind_twostage.py``) is driven through the whole run after the look
for a card (``harness.measure``) at the small sizes of ``conftest.SMALL``, where the program
runs its plain twins; each fault of ``benchmark/faults_twostage.py`` and the configuration's
control read not correct there. The stage counts are checked against the formulas written
out by hand, and the readers of ``roofline.fine``, ``roofline.unwrap`` and ``stage_ms.fine``
on a synthetic trace.
"""
import time

import pytest

from benchmark import control, faults, faults_twostage
from benchmark.lib import harness, roofline, spec, trace

BENCH = spec.BENCH
CELL = "blind64-twostage.track"
#: the pool's captures lock at the small sizes on this seed (as for the decimated cells)
SEED = 3


def run(root, seconds=0.5):
    cell = spec.cell(root, CELL, bench=root / "benchmark")
    res, compared = harness.measure(cell, SEED, seconds, False, "cpu", time.perf_counter())
    return res, {n: v for n, v, _, _ in compared}


def test_a_sound_run_is_correct(small_root):
    res, numbers = run(small_root)
    assert res["correct"], numbers
    assert numbers["turns"] == 0 and numbers["off"] == 0
    assert set(res["metrics"]) == {"msym_s.track", "dispatch_ms_p95.track", "setup_s"}
    assert res["notes"]["ser"] == 0.0


def test_the_cell_reports_its_metrics():
    cell = spec.cell(BENCH.parent, CELL)
    assert cell.config["system"] == "blind_twostage" and cell.chips == 1
    names = {m["name"] for m in cell.per_layer}
    assert {"roofline.fine", "roofline.unwrap", "stage_ms.fine", "roofline.search.track",
            "roofline.filter.track", "launches.track", "plain_ms.track"} <= names
    assert "roofline.derotate.track" not in names             # B4 does not run here


def test_work_counts_by_hand():
    cell = spec.cell(BENCH.parent, CELL)
    mod = spec.system("blind_twostage")
    sut = mod.System.__new__(mod.System)            # the counts need the shapes, no set-up
    sut.cfg, sut.entry = cell.config, "tracking"
    sut.nsym_capture = 2 ** 22
    sut.lout = 2 ** 22 - 8                          # (2 * 2^22 - 17) // 2 + 1
    n = 2 * sut.lout
    w = sut.work()
    assert set(w) == {"filter", "search", "fine", "unwrap"}
    # the filter: 4 input rows of 2^23 samples, 2 x 2 x 17 complex taps, 4 output rows
    assert w["filter"] == (4 * (4 * 2 ** 23 + 4 * 2 * 17 + 4 * sut.lout),
                           8 * 2 * 17 * 2 * sut.lout)
    # the coarse search: 16 angles, planes in, index out, the angle tables
    assert w["search"] == (4 * (3 * n + 2 * 16), (9 + 17) * 16 * n)
    # the fine search: planes and coarse phase in, phase out; 8 offsets of 9 + 17 + 6
    # operations and the rotation's 8 a sample
    assert w["fine"] == (16 * n, (32 * 8 + 8) * n)
    # the unwrap-derotation: 20 bytes and 6 + 8 operations a sample
    assert w["unwrap"] == (20 * n, 14 * n)
    ms = {k: 1e3 * roofline.bound_s(*v) for k, v in w.items()}
    assert ms["fine"] == pytest.approx(16 * n / 3.35e9)        # bound by bytes: 0.0401 ms
    assert ms["unwrap"] == pytest.approx(20 * n / 3.35e9)      # 0.0501 ms


@pytest.mark.parametrize("fault", faults_twostage.FAULTS, ids=lambda f: f.name)
def test_a_fault_in_the_timed_path_is_caught(small_root, fault):
    with faults.planted(fault):
        res, numbers = run(small_root)
    assert not res["correct"], numbers


def test_the_control_fails_the_limits(small_root):
    c = spec.cell(small_root, CELL, bench=small_root / "benchmark")
    lim = c.config["limits"]
    prog, ctl = control.readings(c, SEED, 0.5, "cpu")
    assert prog["mismatch"] <= lim["mismatch"] < ctl["mismatch"], (prog, ctl)


def test_fault_readings_name_every_fault(small_root, monkeypatch):
    seen = []

    def readings(cell, seed, seconds, device, control=True):
        seen.append((cell.name, seed, control))
        return {"mismatch": 1.0}, None
    monkeypatch.setattr(control, "readings", readings)
    cell = spec.cell(small_root, CELL, bench=small_root / "benchmark")
    out = faults_twostage.fault_readings(cell, 7, 0.5, "cpu")
    assert list(out) == [f.name for f in faults_twostage.FAULTS]
    assert seen == [(CELL, 7, False)] * len(faults_twostage.FAULTS)


def synthetic(with_fine_span=True):
    """A 1000 us span with two dispatches of the two-stage path: B2, B3, the coarse phase's
    elementwise kernel, B8, B7's scratch fill and B7 each, and B10 once (not B7)."""
    device = []
    for t0 in (100.0, 500.0):
        device += [("void (anonymous namespace)::apply_filter_kernel<2, 2, 6>(float const*)",
                    t0, t0 + 60),
                   ("void (anonymous namespace)::bps_kernel<0>(float const*)", t0 + 60, t0 + 140),
                   ("void at::native::vectorized_elementwise_kernel<4>(...)", t0 + 140, t0 + 150),
                   ("void (anonymous namespace)::bps_fine_kernel<0>(float const*)",
                    t0 + 150, t0 + 200),
                   ("void at::native::FillFunctor<long>(...)", t0 + 200, t0 + 202),
                   ("(anonymous namespace)::unwrap_kernel(float const*, long long*)",
                    t0 + 202, t0 + 232)]
    device.append(("(anonymous namespace)::unwrap_slopes_kernel(int const*)", 900.0, 910.0))
    host = [("bench.trace", 0.0, 1000.0)]
    for t0 in (90.0, 490.0):
        host += [("qtt.rx.tracking_planes", t0, t0 + 200),
                 ("qtt.rx.filter", t0 + 10, t0 + 40),
                 ("qtt.rx.search", t0 + 40, t0 + 80)]
        if with_fine_span:
            host.append(("qtt.rx.fine", t0 + 80, t0 + 150))
        host.append(("qtt.rx.derotate", t0 + 150, t0 + 190))
    return trace.Trace(device, host, 0.0, 1000.0, dispatches=2, host_ms=[0.3],
                       work={"fine": (3.35e6, 0.0), "unwrap": (0.0, 67e6 * 0.5)})


def test_the_new_readers_on_a_synthetic_trace():
    tr = synthetic()
    # fine: 3.35 MB at 3.35 TB/s = 1 us bound; B8 50 us a dispatch
    assert spec.reader("roofline.fine").read(tr) == pytest.approx(100 * 1e-3 / 0.05)
    # unwrap: 0.5 * 67 MFLOP at 67 TFLOP/s = 0.5 us; B7 30 us a dispatch (not B10's 10 us)
    assert spec.reader("roofline.unwrap").read(tr) == pytest.approx(100 * 0.5e-3 / 0.03)
    assert spec.reader("stage_ms.fine").read(tr) == pytest.approx(0.07)
    # a program without the fine stage's span reads nothing there, and the rest as before
    bare = synthetic(with_fine_span=False)
    assert spec.reader("stage_ms.fine").read(bare) is None
    assert spec.reader("roofline.fine").read(bare) == pytest.approx(100 * 1e-3 / 0.05)
    # a cell without the stages reads nothing
    tr.work.clear()
    assert spec.reader("roofline.fine").read(tr) is None
    assert spec.reader("roofline.unwrap").read(tr) is None
