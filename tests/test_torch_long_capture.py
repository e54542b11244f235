"""A long capture served by the port, beside the JAX package (tests/test_long_capture.py).

Pilot: a JAX ``SignalWithPilots(64, 2**14, 512, 32, nframes=7)`` capture (the
impairments of tests/test_torch_pilot_chain.py); the JAX chain with
``pallas=True, eq_trainer="ls"`` (Pallas in interpret mode) runs in full
over frames 0-2 and then tracks frames 3-5 at ``_frame_base = 3 * 2^14 *
2``; the port's chain does the same on the same planes. The port's
dispatch at the offset must equal, bit for bit, a port chain built over
frames 3-5 with the same state, and its decisions the reference's. The
reference's frame filter contracts in bf16 and the port's in float32
(tests/test_torch_pilot_chain.py): the payloads are held within that
rounding (2e-2; 9e-3 measured), and within 1e-4 of the reference's float32
frame body (``pallas=False``) tracking at the same offset from its state.

Blind: 2^16 symbols of 16-QAM in 4 chunks of 2^14 with the long-capture
halo, through the port's chain and the JAX chain (its XLA path on the CPU)
chunk by chunk; decisions shared (each mode at its best quarter turn) at
least 99.9 %, every chunk under the long-capture gate (SER < 5e-3 under
one alignment).
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu.ops.chain import make_rx_chain as jax_make_rx_chain
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain as jax_make_pilot_rx_chain
from qampy_tpu_torch.convert import pilot_state_from_jax
from qampy_tpu_torch.ops.chain import make_rx_chain
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
from qampy_tpu_torch.workload import shared_decisions
from torch_examples_util import _common

FRAME, SEQ, INS = 2 ** 14, 512, 32
CFG = dict(os=2, nmodes=2, Ntaps=17, cpe_avg=3, eq_trainer="ls")
BASE = 3 * FRAME * 2                   # dispatch 1 of frames 3-5
PAYLOAD_F32 = 1e-4                     # the port against the reference's float32 body
PAYLOAD_BF16 = 2e-2                    # ... against its bf16 Pallas frame filter (~1e-2)
AGREE_MIN = 0.999
BLIND = dict(M=16, Ntaps=11, os=2, methods=("cma", "sbd"), mu=1e-3, bps_angles=32, bps_N=8,
             TrSyms=2 ** 14, block_size=128)
NSYM, CHUNK, HALO = 2 ** 16, 2 ** 14, 96


def _decide(d, coded):
    return np.argmin(np.abs(d[..., None] - coded[None, None, :]), axis=-1)


@pytest.fixture(scope="module")
def capture():
    sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=7, nmodes=2, fb=24e9, seed=3)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    s2 = qt.impairments.simulate_transmission(s2, snr=30, dgd=20e-12, theta=np.pi / 4.7,
                                              lwdth=20e3, roll_frame_sync=True,
                                              key=jr.PRNGKey(5))
    E = np.asarray(s2.samples).astype(np.complex64)
    return dict(seq=np.asarray(sig.pilot_seq), ph=np.asarray(sig.ph_pilots),
                pr=np.ascontiguousarray(E.real), pi=np.ascontiguousarray(E.imag),
                coded=np.asarray(sig.coded_symbols).astype(np.complex64),
                tx=_decide(np.asarray(sig.get_data(frames=[3, 4, 5]).samples),
                           np.asarray(sig.coded_symbols).astype(np.complex64)))


@pytest.fixture(scope="module")
def runs(capture):
    c = capture
    out = {}
    for pallas in (True, False):
        fwd = jax_make_pilot_rx_chain(c["seq"], c["ph"], FRAME, INS, pallas=pallas,
                                      frames=(0, 1, 2), return_phase=False, **CFG)
        _, info = jax.jit(fwd)(jnp.asarray(c["pr"] + 1j * c["pi"]))
        trk = jax.jit(lambda E, t, s, m: fwd.tracking(E, t, s, m, _frame_base=BASE))
        d, _ = trk(jnp.asarray(c["pr"] + 1j * c["pi"]), info["taps"], info["shift"],
                   info["mode_order"])
        out[pallas] = (np.asarray(d), {k: np.asarray(v) for k, v in info.items()})
    pr, pi = torch.as_tensor(c["pr"]), torch.as_tensor(c["pi"])
    chain = make_pilot_rx_chain(c["seq"], c["ph"], FRAME, INS, frames=(0, 1, 2),
                                return_phase=False, device="cpu", **CFG)
    _, info = chain.planes(pr, pi)
    (tr, ti), _ = chain.tracking_planes(pr, pi, info["taps"], info["shift"], info["mode_order"],
                                        _frame_base=BASE)
    return dict(jax=out, chain=chain, info=info, port=torch.complex(tr, ti), pr=pr, pi=pi)


def test_acquired_state_as_the_reference(runs):
    jinfo = runs["jax"][True][1]
    assert runs["info"]["shift"].tolist() == jinfo["shift"].tolist()
    assert runs["info"]["mode_order"].tolist() == jinfo["mode_order"].tolist()


def test_tracking_at_an_offset_equals_a_chain_over_those_frames(capture, runs):
    info, c = runs["info"], capture
    other = make_pilot_rx_chain(c["seq"], c["ph"], FRAME, INS, frames=(3, 4, 5),
                                return_phase=False, device="cpu", **CFG)
    (r, i), _ = other.tracking_planes(runs["pr"], runs["pi"], info["taps"], info["shift"],
                                      info["mode_order"])
    assert torch.equal(torch.complex(r, i), runs["port"])
    # the full entry demodulates the same frames at that offset, and a 0-d tensor offset is
    # the int
    (fr, fi), _ = runs["chain"].planes(runs["pr"], runs["pi"], _frame_base=BASE)
    assert torch.equal(torch.complex(fr, fi), runs["port"])
    (tr, ti), _ = runs["chain"].tracking_planes(runs["pr"], runs["pi"], info["taps"],
                                                info["shift"], info["mode_order"],
                                                _frame_base=torch.tensor(BASE))
    assert torch.equal(torch.complex(tr, ti), runs["port"])


def test_tracking_at_an_offset_against_the_reference(capture, runs):
    got = runs["port"].numpy()
    jd_bf16, jd_f32 = runs["jax"][True][0], runs["jax"][False][0]
    assert got.shape == jd_f32.shape == capture["tx"].shape
    assert np.abs(got - jd_bf16).max() <= PAYLOAD_BF16
    # the port's tracking from the reference's float32 chain's state: its float32 body
    jinfo = runs["jax"][False][1]
    taps, shift, mo = pilot_state_from_jax(jinfo["taps"], jinfo["shift"], jinfo["mode_order"],
                                           "cpu")
    (r, i), _ = runs["chain"].tracking_planes(runs["pr"], runs["pi"], taps, shift, mo,
                                              _frame_base=BASE)
    assert np.abs(torch.complex(r, i).numpy() - jd_f32).max() <= PAYLOAD_F32
    dec = _decide(got, capture["coded"])
    assert np.array_equal(dec, _decide(jd_bf16, capture["coded"]))
    assert np.all(np.mean(dec != capture["tx"], axis=-1) < 1e-4)


def test_frame_base_past_the_capture_clamps(runs):
    """Windows moved past the capture's end are clamped into it, as the reference's slices are."""
    chain, info = runs["chain"], runs["info"]
    P = chain._planes(runs["pr"], runs["pi"])
    offs = chain.frame_offsets(P, chain._eq_shift(info["shift"]), 10 ** 9)
    assert int(offs.min()) == int(offs.max()) == P.shape[-1] - chain.fr_len


def test_chunked_blind_chain_beside_the_reference():
    ex = _common.load("long_capture_serving")
    sig = qt.SignalQAMGrayCoded(16, NSYM, nmodes=2, fb=25e9, seed=21)
    s2 = qt.impairments.apply_PMD(sig.resample(2 * sig.fb, beta=0.1), np.pi / 5.6, 25e-12)
    s2 = qt.impairments.change_snr(s2, 25, key=jr.PRNGKey(2))
    halo = HALO * 2
    Ep = np.pad(np.asarray(s2.samples).astype(np.complex64), ((0, 0), (halo, halo + 16)))
    jfwd = jax.jit(jax_make_rx_chain(**BLIND))
    chain = make_rx_chain(device="cpu", **BLIND)
    Pp = torch.as_tensor(np.concatenate([Ep.real, Ep.imag]).astype(np.float32))
    const = torch.as_tensor(np.unique(np.asarray(sig.coded_symbols)))
    outs, jouts = [], []
    for c in range(NSYM // CHUNK):
        seg = ex.blind_segment(Pp, c, CHUNK)
        outr, outi = chain.planes(seg)
        outs.append(torch.complex(outr, outi)[:, HALO:HALO + CHUNK])
        lo = c * CHUNK * 2
        jo = np.asarray(jfwd(jnp.asarray(Ep[:, lo:lo + CHUNK * 2 + 2 * halo + 16])))
        jouts.append(torch.as_tensor(np.array(jo[:, HALO:HALO + CHUNK])))
        assert shared_decisions(outs[-1], jouts[-1], const) >= AGREE_MIN
    port_sig = type("S", (), {"symbols": torch.as_tensor(np.array(sig.symbols)),
                              "coded_symbols_host": np.asarray(sig.coded_symbols)})
    sers, same = ex.blind_check(port_sig, outs, CHUNK)
    assert same and max(sers) < 5e-3, sers
