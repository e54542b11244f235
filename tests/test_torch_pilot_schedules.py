"""The pilot chain's frame schedules in the port against the JAX package's.

``frames_mode`` "vmap", "span", "span_planes" and "auto", ``frames_pack``
and ``frames_unroll`` (reference qampy_tpu/ops/pilot_chain.py:826-960). The
capture is the JAX package's ``SignalWithPilots(64, 2**14, 512, 32,
nframes=6)`` of tests/test_torch_pilot_chain.py, demodulated over frames
0-3 with 17 taps and the LS trainer. Each schedule is held to the port's
``"scan"`` at the reference's own tolerances (tests/test_pilot_chain.py:
span 1e-4 at :126-129, pack 1e-5 at :174-175), and to the reference in the
same schedule (``pallas=True``, its kernels in interpret mode) by
decisions: the reference's Pallas frame filter contracts in bf16 and the
port's in float32, so the payloads differ by ~1e-2 while the decisions
agree.
"""
import numpy as np
import jax
import jax.random as jr
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain as jax_make_pilot_rx_chain
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain

FRAME, SEQ, INS = 2 ** 14, 512, 32
FRAMES = (0, 1, 2, 3)
CFG = dict(os=2, nmodes=2, Ntaps=17, cpe_avg=3, frames=FRAMES, eq_trainer="ls")
SPAN_TOL, PACK_TOL = 1e-4, 1e-5   # the reference's own bounds against its scan
AGREE_MIN = 0.999
SER_MAX = 1e-4


def _decide(d, coded):
    return np.argmin(np.abs(d[..., None] - coded[None, None, :]), axis=-1)


@pytest.fixture(scope="module")
def capture():
    sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=6, nmodes=2, fb=24e9, seed=3)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    s2 = qt.impairments.simulate_transmission(s2, snr=30, dgd=20e-12, theta=np.pi / 4.7,
                                              lwdth=20e3, roll_frame_sync=True,
                                              key=jr.PRNGKey(5))
    E = np.asarray(s2.samples).astype(np.complex64)
    coded = np.asarray(sig.coded_symbols).astype(np.complex64)
    return dict(seq=np.asarray(sig.pilot_seq), ph=np.asarray(sig.ph_pilots), E=E,
                coded=coded, tx=_decide(np.asarray(sig.get_data(frames=list(FRAMES)).samples),
                                        coded))


def _port(capture, **kw):
    chain = make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, device="cpu",
                                **dict(CFG, **kw))
    out, info = chain.forward(torch.as_tensor(capture["E"]))
    return chain, out.numpy(), info


@pytest.fixture(scope="module")
def scans(capture):
    """The port's scan, with and without the phase trace."""
    return {rp: _port(capture, return_phase=rp) for rp in (True, False)}


def _reference(capture, **kw):
    fwd = jax_make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, pallas=True,
                                  **dict(CFG, **kw))
    out, info = jax.jit(fwd)(capture["E"])
    return np.asarray(out), {k: np.asarray(v) for k, v in info.items()}


# schedule -> (chain keywords, the port's schedule, tolerance against the port's scan)
SCHEDULES = {
    "vmap": (dict(frames_mode="vmap"), "frames", 0.0),
    "span": (dict(frames_mode="span"), "span", SPAN_TOL),
    "span serving": (dict(frames_mode="span", return_phase=False), "span", SPAN_TOL),
    "span_planes": (dict(frames_mode="span_planes"), "span", SPAN_TOL),
    "auto": (dict(frames_mode="auto", return_phase=False), "span", SPAN_TOL),
    "pack 2": (dict(frames_pack=2, return_phase=False), "frames", PACK_TOL),
    "unroll 2": (dict(frames_unroll=2), "frames", 0.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_against_scan_and_reference(capture, scans, name):
    kw, schedule, tol = SCHEDULES[name]
    chain, got, info = _port(capture, **kw)
    assert chain.schedule == schedule
    _, scan, sinfo = scans[kw.get("return_phase", True)]
    assert got.shape == scan.shape
    assert np.abs(got - scan).max() <= tol
    if "phase" in sinfo:
        assert np.abs(info["phase"].numpy() - sinfo["phase"].numpy()).max() <= max(tol, 1e-6)
    ref, rinfo = _reference(capture, **kw)
    assert set(info) == set(rinfo)
    dec, rdec = _decide(got, capture["coded"]), _decide(ref, capture["coded"])
    assert np.mean(dec == rdec) >= AGREE_MIN
    for d in (dec, rdec):
        assert np.all(np.mean(d != capture["tx"], axis=-1) < SER_MAX)


def test_pack_drops_the_phase(capture, scans):
    """The reference packs only the serving form, which has no trace: frames_pack=2 there
    gives the scan's payload and no ``info["phase"]``; with the trace asked for, or a pack
    that does not divide the frames, the reference scans, and the trace is kept."""
    chain, got, info = _port(capture, frames_pack=2, return_phase=False)
    assert chain.schedule == "frames" and "phase" not in info
    assert np.array_equal(got, scans[False][1])
    for kw in (dict(frames_pack=2), dict(frames_pack=3)):   # 3 does not divide the 4 frames
        chain, got, info = _port(capture, **kw)
        assert chain.schedule == "frames" and "phase" in info
        assert np.array_equal(got, scans[True][1])


@pytest.mark.parametrize("frames", [(0, 1), (0, 2, 3)])
def test_span_needs_more_than_two_contiguous_frames(capture, frames):
    with pytest.raises(ValueError, match="needs >2 contiguous frames"):
        make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, device="cpu",
                            **dict(CFG, frames=frames, frames_mode="span"))
    with pytest.raises(ValueError, match="needs >2 contiguous frames"):
        jax.jit(jax_make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS,
                                        pallas=True, **dict(CFG, frames=frames,
                                                            frames_mode="span")))(capture["E"])
    chain = make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, device="cpu",
                                **dict(CFG, frames=frames, frames_mode="auto"))
    assert chain.schedule == "frames"


def test_tracking_planes_refuses_span(capture, scans):
    """As the reference asserts (pilot_chain.py:1043-1045); the complex entry serves it."""
    chain, got, info = _port(capture, frames_mode="span")
    E = torch.as_tensor(capture["E"])
    with pytest.raises(ValueError, match="supports frames_mode 'scan'/'vmap'"):
        chain.tracking_planes(E.real, E.imag, info["taps"], info["shift"], info["mode_order"])
    out, _ = chain.tracking(E, info["taps"], info["shift"], info["mode_order"])
    assert torch.equal(out, torch.as_tensor(got))
    fwd = jax_make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, pallas=True,
                                  **dict(CFG, frames_mode="span"))
    with pytest.raises(AssertionError, match="supports frames_mode"):
        fwd.tracking_planes(capture["E"].real, capture["E"].imag, info["taps"].numpy(),
                            info["shift"].numpy())


def test_unknown_mode_and_counts_refused(capture):
    for kw in (dict(frames_mode="scanned"), dict(frames_pack=0), dict(frames_unroll=0)):
        with pytest.raises(ValueError):
            make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, device="cpu",
                                **dict(CFG, **kw))
