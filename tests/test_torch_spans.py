"""The port's host spans (``profiling.span``): where the receivers open them, and that they
are recorded only while a ``torch.profiler`` records.

Small chains on the CPU: the blind decimated16 chain (its full and tracking entries), the
two-stage chains (twostage, twostage-dec: tracking, where the fine stage's span follows the
coarse search's) and the pilot chain (its full and tracking entries, in the serving form and with the phase
trace). Under a profiler each entry call is one span holding its stages' spans, in order;
with none recording the recorder is never entered, and the outputs are the same bit for
bit either way. The kernel launchers' spans are checked on CPU tensors, which each
launcher refuses inside its span.
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch

from qampy_tpu_torch import profiling, workload
from qampy_tpu_torch.ops import equaliser_cuda, phase_cuda
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain

FRAME = 2 ** 14
BLIND = ("qtt.rx.train", "qtt.rx.filter", "qtt.rx.search", "qtt.rx.glue", "qtt.rx.derotate")
TWOSTAGE = ("qtt.rx.filter", "qtt.rx.search", "qtt.rx.fine", "qtt.rx.derotate")
PILOT = ("qtt.pilot.input", "qtt.pilot.frames", "qtt.pilot.cpe", "qtt.pilot.derotate",
         "qtt.pilot.payload")
# entry -> (the entry's span, its stage spans in the order a call opens them)
ENTRIES = {
    "blind planes_with_taps": ("qtt.rx.planes_with_taps", BLIND),
    "blind tracking_planes": ("qtt.rx.tracking_planes", BLIND[1:]),
    "blind twostage tracking_planes": ("qtt.rx.tracking_planes", TWOSTAGE),
    "blind twostage-dec tracking_planes": ("qtt.rx.tracking_planes", TWOSTAGE),
    "pilot planes": ("qtt.pilot.planes", PILOT[:1] + ("qtt.pilot.prefix",) + PILOT[1:]),
    "pilot tracking_planes": ("qtt.pilot.tracking_planes", PILOT),
    "pilot tracking_planes, phase trace": ("qtt.pilot.tracking_planes", PILOT),
}
LAUNCHERS = {
    "qtt.B1": [equaliser_cuda.train_block_cuda], "qtt.B9": [equaliser_cuda.train_seq_cuda],
    "qtt.B2": [equaliser_cuda.apply_filter_cuda, equaliser_cuda.apply_filter_frames_cuda],
    "qtt.B3": [phase_cuda.bps_search_cuda], "qtt.B4": [phase_cuda.interp_rotate_cuda],
    "qtt.B5": [phase_cuda.cpe_coeffs_cuda], "qtt.B6": [phase_cuda.rotate_cuda],
    "qtt.B7": [phase_cuda.unwrap_derotate_cuda], "qtt.B8": [phase_cuda.bps_fine_cuda],
    "qtt.B10": [phase_cuda.unwrap_slopes_cuda],
}


@pytest.fixture(scope="module")
def calls():
    """entry -> a function that calls it once on its small capture and returns its outputs."""
    torch.set_num_threads(2)
    E, _, _ = workload.make_tx(2 ** 13, seed=1)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32))
    blind = make_rx_chain(M=64, Ntaps=17, os=2, bps_angles=64, bps_N=12, block_size=256,
                          TrSyms=2 ** 11, bps_mode="decimated16", device="cpu")
    _, w = blind.planes_with_taps(P)
    tx = workload.make_pilot_tx(4, frame_len=FRAME, seq_len=512, ins_rat=32, seed=3,
                                device="cpu")
    pr, pi = tx.planes[:2], tx.planes[2:]
    out = {"blind planes_with_taps": lambda: blind.planes_with_taps(P),
           "blind tracking_planes": lambda: blind.tracking_planes(P, w)}
    for mode in ("twostage", "twostage-dec"):
        chain = make_rx_chain(M=64, Ntaps=17, os=2, bps_angles=64, bps_N=14, block_size=256,
                              bps_mode=mode, device="cpu")
        assert chain.mode == mode
        out["blind %s tracking_planes" % mode] = lambda c=chain: c.tracking_planes(P, w)
    for rp, suffix in ((False, ""), (True, ", phase trace")):
        pilot = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, FRAME, 32, Ntaps=17,
                                    frames=(0, 1), eq_trainer="ls", return_phase=rp,
                                    device="cpu")
        _, info = pilot.planes(pr, pi)
        state = (info["taps"], info["shift"], info["mode_order"])
        if not rp:
            out["pilot planes"] = lambda c=pilot: c.planes(pr, pi)
        out["pilot tracking_planes" + suffix] = (
            lambda c=pilot, s=state: c.tracking_planes(pr, pi, *s))
    return out


def _profiled(fn, n=1):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = [fn() for _ in range(n)]
    spans = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("qtt."))
    return outs, [(name, s, -ne) for s, ne, name in spans]


def _flat(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    return [t for v in x for t in _flat(v)]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_each_call_is_one_entry_span_holding_its_stages_in_order(calls, entry):
    name, stages = ENTRIES[entry]
    _, spans = _profiled(calls[entry], n=2)
    tops = [s for s in spans if s[0] == name]
    assert len(tops) == 2
    assert {s[0] for s in spans} <= set(profiling.SPANS)
    for _, lo, hi in tops:
        inside = [s for s in spans if lo <= s[1] and s[2] <= hi and s[0] != name]
        assert tuple(s[0] for s in inside) == stages           # in order, each once
        assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))   # none overlaps the next
    # nothing of the program runs outside its entry's span
    assert all(any(lo <= s[1] and s[2] <= hi for _, lo, hi in tops) for s in spans)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_outputs_are_bit_equal_with_the_profiler_on_and_off(calls, entry):
    off = _flat(calls[entry]())
    (on,), _ = _profiled(calls[entry])
    on = _flat(on)
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))


def test_no_recorder_is_entered_without_a_profiler(calls, monkeypatch):
    def refuse(name):
        raise AssertionError("a span was recorded with no profiler running: %s" % name)
    monkeypatch.setattr(profiling, "_record", refuse)
    assert profiling.span("qtt.rx.train") is profiling.span("qtt.pilot.cpe")   # the shared no-op
    for entry in sorted(calls):
        calls[entry]()
    with pytest.raises(AssertionError, match="qtt.rx"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            calls["blind tracking_planes"]()


def _refused(fn):
    """Call a launcher on CPU tensors, one for each parameter without a default."""
    params = [p for p in inspect.signature(fn).parameters.values()
              if p.default is inspect.Parameter.empty]
    with pytest.raises((TypeError, ValueError)):
        fn(*[torch.zeros(2, 8) for _ in params])


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_each_launcher_runs_inside_its_kernels_span(name):
    assert name in profiling.SPANS
    for fn in LAUNCHERS[name]:
        before = fn.launches
        _, spans = _profiled(lambda f=fn: _refused(f))
        assert [s[0] for s in spans] == [name]
        _refused(fn)                                           # and without the profiler
        # the counters stay on the launchers, which are what the modules export
        assert fn.launches == before
        assert getattr(equaliser_cuda if fn.__module__.endswith("equaliser_cuda")
                       else phase_cuda, fn.__name__) is fn


def test_the_chrome_trace_holds_the_stage_spans(calls, tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        calls["blind planes_with_taps"]()
        calls["pilot tracking_planes"]()
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"qtt.rx.planes_with_taps", "qtt.pilot.tracking_planes"} <= names
    assert set(BLIND) <= names and set(PILOT) <= names


@pytest.mark.gpu
def test_b10_opens_inside_the_glue_on_the_card():
    """On CUDA tensors the blind decimated chain's glue is one B10 launch: ``qtt.B10`` opens
    once a call, inside ``qtt.rx.glue``, and the glue opens no other launcher's span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    E, _, _ = workload.make_tx(2 ** 13, seed=1)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    blind = make_rx_chain(M=64, Ntaps=17, os=2, bps_angles=64, bps_N=12, block_size=256,
                          TrSyms=2 ** 11, bps_mode="decimated16", device=dev)
    _, w = blind.planes_with_taps(P)
    _, spans = _profiled(lambda: blind.tracking_planes(P, w), n=2)
    glues = [s for s in spans if s[0] == "qtt.rx.glue"]
    assert len(glues) == 2
    for _, lo, hi in glues:
        inside = [s[0] for s in spans if lo <= s[1] and s[2] <= hi and s[0] != "qtt.rx.glue"]
        assert inside == ["qtt.B10"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["twostage", "twostage-dec"])
def test_b3_and_b8_open_in_their_stages_on_the_card(mode):
    """On CUDA tensors the two-stage chains' ``qtt.rx.search`` holds one B3 launch and nothing
    else, and ``qtt.rx.fine``, which follows it, one B8 launch and nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    E, _, _ = workload.make_tx(2 ** 13, seed=1)
    P = torch.as_tensor(np.concatenate([E.real, E.imag]).astype(np.float32), device=dev)
    chain = make_rx_chain(M=64, Ntaps=17, os=2, bps_angles=64, bps_N=14, block_size=256,
                          TrSyms=2 ** 11, bps_mode=mode, device=dev)
    _, w = chain.planes_with_taps(P)
    _, spans = _profiled(lambda: chain.tracking_planes(P, w), n=2)
    for stage, launcher in (("qtt.rx.search", "qtt.B3"), ("qtt.rx.fine", "qtt.B8")):
        held = [s for s in spans if s[0] == stage]
        assert len(held) == 2
        for _, lo, hi in held:
            assert [s[0] for s in spans if lo <= s[1] and s[2] <= hi and s[0] != stage] \
                == [launcher]
    search = [s for s in spans if s[0] == "qtt.rx.search"]
    fine = [s for s in spans if s[0] == "qtt.rx.fine"]
    assert all(a[2] <= b[1] for a, b in zip(search, fine))
