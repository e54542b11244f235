"""The port's LS pilot chain against the JAX package's, on one capture each way.

The reference runs ``make_pilot_rx_chain(..., pallas=True, eq_trainer="ls")``
with its Pallas kernels in interpret mode on the CPU; the port runs its
plain versions on CPU tensors. The capture is the JAX package's
``SignalWithPilots(64, 2**14, 512, 32, nframes=6)`` with the impairments of
tests/test_pilot_chain.py::test_ls_trainer_recovers (30 dB, 20 kHz, PMD),
demodulated over frames 0-2 with 17 taps. The reference's frame filter
contracts in bf16 and the port's in float32, so payloads differ by ~1e-2
while the decisions agree.
"""
import numpy as np
import jax
import jax.random as jr
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain as jax_make_pilot_rx_chain
from qampy_tpu_torch import workload
from qampy_tpu_torch.convert import pilot_state_from_jax
from qampy_tpu_torch.ops.pilot_chain import PilotRxChain, make_pilot_rx_chain

FRAME, SEQ, INS = 2 ** 14, 512, 32
CFG = dict(os=2, nmodes=2, Ntaps=17, cpe_avg=3, frames=(0, 1, 2), eq_trainer="ls")
CPU = dict(CFG, device="cpu")
SER_MAX = 1e-4          # the reference test's gate (test_pilot_chain.py:200)
AGREE_MIN = 0.999       # decisions shared with the reference chain
TAPS_TOL = 1e-3         # two float32 LU solves of a Tikhonov system: ~5e-5 measured
PAYLOAD_SAME = 1e-4     # return_phase on/off: the reference's own bound (:534-545)


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
    ref = np.asarray(sig.get_data(frames=[0, 1, 2]).samples)
    return dict(seq=np.asarray(sig.pilot_seq), ph=np.asarray(sig.ph_pilots), E=E,
                pr=np.ascontiguousarray(E.real), pi=np.ascontiguousarray(E.imag),
                coded=coded, tx_idx=_decide(ref, coded))


@pytest.fixture(scope="module", params=[False, True], ids=["serving", "return_phase"])
def runs(request, capture):
    """Both chains on the capture: (JAX payload, JAX info, port chain, port payload, info)."""
    rp = request.param
    fwd = jax_make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, pallas=True,
                                  return_phase=rp, **CFG)
    (dr, di), info = jax.jit(fwd.planes)(capture["pr"], capture["pi"])
    jinfo = {k: np.asarray(v) for k, v in info.items()}
    chain = make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, return_phase=rp,
                                **CPU)
    (tr, ti), tinfo = chain.planes(torch.as_tensor(capture["pr"]), torch.as_tensor(capture["pi"]))
    return dict(rp=rp, jax=np.asarray(dr) + 1j * np.asarray(di), jinfo=jinfo, chain=chain,
                port=(tr, ti), info=tinfo)


def test_acquired_state_agrees(runs):
    info, jinfo = runs["info"], runs["jinfo"]
    assert info["shift"].tolist() == jinfo["shift"].tolist()
    assert info["mode_order"].tolist() == jinfo["mode_order"].tolist()
    assert float(info["sync_corr"]) == pytest.approx(float(jinfo["sync_corr"]), rel=1e-4)
    assert float(info["sync_corr"]) >= workload.SYNC_CORR_MIN
    assert np.abs(info["taps"].numpy() - jinfo["taps"]).max() <= TAPS_TOL
    assert set(info) == set(jinfo)


def test_decisions_and_ser(capture, runs):
    got = torch.complex(*runs["port"]).numpy()
    assert got.shape == runs["jax"].shape == capture["tx_idx"].shape
    dec, jdec = _decide(got, capture["coded"]), _decide(runs["jax"], capture["coded"])
    assert np.mean(dec == jdec) >= AGREE_MIN
    for d in (dec, jdec):
        assert np.all(np.mean(d != capture["tx_idx"], axis=-1) < SER_MAX)


def test_phase_trace(runs):
    if not runs["rp"]:
        assert "phase" not in runs["info"]
        return
    ph, jph = runs["info"]["phase"].numpy(), runs["jinfo"]["phase"]
    assert ph.shape == jph.shape == (2, 3 * FRAME)
    # pilot phases of a bf16- and a float32-filtered frame: ~2e-3 rad measured
    assert np.abs(ph - jph).max() <= 1e-2


def test_return_phase_payload_equals_serving(capture):
    pr, pi = torch.as_tensor(capture["pr"]), torch.as_tensor(capture["pi"])
    out = [make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, return_phase=rp,
                               **CPU).planes(pr, pi)[0] for rp in (False, True)]
    assert np.abs(torch.complex(*out[0]).numpy() - torch.complex(*out[1]).numpy()).max() \
        <= PAYLOAD_SAME


def test_tracking_equals_full_chain(capture, runs):
    chain, info = runs["chain"], runs["info"]
    pr, pi = torch.as_tensor(capture["pr"]), torch.as_tensor(capture["pi"])
    (tr, ti), tinfo = chain.tracking_planes(pr, pi, info["taps"], info["shift"],
                                            info["mode_order"])
    assert torch.equal(tr, runs["port"][0]) and torch.equal(ti, runs["port"][1])
    assert torch.isinf(tinfo["sync_corr"]) and tinfo["taps"] is info["taps"]


def test_tracking_on_reference_state(capture, runs):
    """The port's warm-start entry demodulates with the JAX chain's acquired state."""
    jinfo = runs["jinfo"]
    taps, shift, mo = pilot_state_from_jax(jinfo["taps"], jinfo["shift"], jinfo["mode_order"],
                                           "cpu")
    (tr, ti), _ = runs["chain"].tracking_planes(torch.as_tensor(capture["pr"]),
                                                torch.as_tensor(capture["pi"]), taps, shift, mo)
    dec = _decide(torch.complex(tr, ti).numpy(), capture["coded"])
    assert np.mean(dec == _decide(runs["jax"], capture["coded"])) >= AGREE_MIN
    assert np.all(np.mean(dec != capture["tx_idx"], axis=-1) < SER_MAX)


def test_complex_entries(capture, runs):
    chain = runs["chain"]
    E = torch.as_tensor(capture["E"])
    d, info = chain.forward(E)
    assert torch.equal(d, torch.complex(*runs["port"]))
    d2, _ = chain.tracking(E, info["taps"], info["shift"], info["mode_order"])
    assert torch.equal(d2, d)


def test_mode_swap_folds_into_taps(capture):
    """Swapped polarisations: the mode order is found and folded into the taps' input axis."""
    pr, pi = (torch.as_tensor(capture[k][::-1].copy()) for k in ("pr", "pi"))
    chain = make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, return_phase=False,
                                **CPU)
    (dr, di), info = chain.planes(pr, pi)
    assert info["mode_order"].tolist() == [1, 0]
    dec = _decide(torch.complex(dr, di).numpy(), capture["coded"])
    assert np.all(np.mean(dec != capture["tx_idx"], axis=-1) < SER_MAX)
    (tr, ti), _ = chain.tracking_planes(pr, pi, info["taps"], info["shift"], info["mode_order"])
    assert torch.equal(tr, dr) and torch.equal(ti, di)


def test_port_capture_through_reference_chain():
    """The port's TX statement demodulated by the JAX chain and by the port, under the bench gate."""
    tx = workload.make_pilot_tx(6, frame_len=FRAME, seq_len=SEQ, device="cpu")
    P = tx.planes.numpy()
    fwd = jax_make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, FRAME, INS, pallas=True,
                                  return_phase=False, **CFG)
    (dr, di), info = jax.jit(fwd.planes)(P[:2], P[2:])
    gate = workload.ber_gate(torch.as_tensor(np.array(dr)), torch.as_tensor(np.array(di)),
                             tx, np.asarray(info["sync_corr"]))
    assert gate["ok"], gate
    (pdr, pdi), pinfo = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, FRAME, INS,
                                            return_phase=False, **CPU).planes(tx.planes[:2],
                                                                              tx.planes[2:])
    assert workload.ber_gate(pdr, pdi, tx, pinfo["sync_corr"])["ok"]
    assert pinfo["shift"].tolist() == np.asarray(info["shift"]).tolist()


def test_frames_of_more_than_4096_cpe_pilots():
    """SignalWithPilots(64, 2**15, 1024, 4): 7,936 CPE pilots per frame, more than kernel B5
    first took on the card. The port's CPU chain beside the JAX chain on frame 0."""
    frame, ins = 2 ** 15, 4
    sig = qt.SignalWithPilots(64, frame, 1024, ins, nframes=3, nmodes=2, fb=24e9, seed=3)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    s2 = qt.impairments.simulate_transmission(s2, snr=30, dgd=20e-12, theta=np.pi / 4.7,
                                              lwdth=20e3, roll_frame_sync=True,
                                              key=jr.PRNGKey(5))
    E = np.asarray(s2.samples).astype(np.complex64)
    pr, pi = np.ascontiguousarray(E.real), np.ascontiguousarray(E.imag)
    seq, ph = np.asarray(sig.pilot_seq), np.asarray(sig.ph_pilots)
    cfg = dict(CFG, frames=(0,))
    fwd = jax_make_pilot_rx_chain(seq, ph, frame, ins, pallas=True, return_phase=False, **cfg)
    (dr, di), info = jax.jit(fwd.planes)(pr, pi)
    chain = make_pilot_rx_chain(seq, ph, frame, ins, return_phase=False,
                                **dict(cfg, device="cpu"))
    assert chain.kernel_interp and chain.nblk == 7936
    (tr, ti), tinfo = chain.planes(torch.as_tensor(pr), torch.as_tensor(pi))
    assert tinfo["shift"].tolist() == np.asarray(info["shift"]).tolist()
    assert tinfo["mode_order"].tolist() == np.asarray(info["mode_order"]).tolist()
    coded = np.asarray(sig.coded_symbols).astype(np.complex64)
    tx_idx = _decide(np.asarray(sig.get_data(frames=[0]).samples), coded)
    dec = _decide(torch.complex(tr, ti).numpy(), coded)
    jdec = _decide(np.asarray(dr) + 1j * np.asarray(di), coded)
    assert dec.shape == jdec.shape == tx_idx.shape == (2, 3 * 7936)
    assert np.mean(dec == jdec) >= AGREE_MIN
    for d in (dec, jdec):
        assert np.all(np.mean(d != tx_idx, axis=-1) < SER_MAX)


@pytest.mark.parametrize("kwargs", [dict(frames_mode="span", frames=(0, 2, 4)),
                                    dict(frames_mode="scanned"), dict(frames_pack=0),
                                    dict(eq_trainer="newton")])
def test_not_to_port_options_are_refused(capture, kwargs):
    """What neither package computes is refused: a span of frames that are not contiguous
    (the reference's ValueError), a frame schedule or pack it does not define, an unknown
    trainer. (The schedules themselves are ported: tests/test_torch_pilot_schedules.py.)"""
    with pytest.raises(ValueError):
        make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, **dict(CPU, **kwargs))


def test_module_and_input_checks(capture):
    chain = make_pilot_rx_chain(capture["seq"], capture["ph"], FRAME, INS, **CPU)
    assert isinstance(chain, PilotRxChain) and chain.W == 63 and chain.TrS_eq == 493
    assert {n for n, _ in chain.named_buffers()} >= {"starts", "seq_f", "pil_r", "bases"}
    with pytest.raises(ValueError, match="as long as frame"):
        chain.planes(torch.zeros(2, 1000), torch.zeros(2, 1000))
    with pytest.raises(ValueError, match="modes"):
        chain.planes(torch.zeros(1, 40000), torch.zeros(1, 40000))
    with pytest.raises(ValueError, match="foe_comp=False"):
        chain.tracking_planes(torch.zeros(2, 40000), torch.zeros(2, 40000),
                              torch.zeros(2, 2, 17, dtype=torch.complex64),
                              torch.zeros(2, dtype=torch.int64), foe=0.01)
