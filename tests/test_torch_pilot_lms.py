"""The port's pilot chain in the reference's other configurations, against the JAX package's.

The LMS trainer (``eq_trainer="lms"``, the default of both packages), its
data-aided stage (``sbd_data``), FOE compensation, the non-blocked CPE
layout (``cpe_pilot_rat=2``) and the reference's float32 body (``pallas=False``),
each on the capture of tests/test_torch_pilot_chain.py
(``SignalWithPilots(64, 2**14, 512, 32, nframes=6)``, 30 dB, 20 kHz, PMD),
demodulated over frames 0-2 with 17 taps. The reference runs its Pallas
kernels in interpret mode on the CPU where ``pallas=True``; the port runs
its plain versions on CPU tensors.

Tolerances: taps within 1e-3 of max|taps| (measured: 1.8e-7 to 2.4e-7,
two float32 block-LMS recurrences); decisions shared at least 0.999 and
per-mode SER below 5e-4 on both sides. The reference's Pallas filter
contracts in bf16 and the port's in float32, so payloads differ by ~1e-2
(measured 8.5e-3 to 9.6e-3) and only decisions are compared; against the
reference's float32 body (``pallas=False``) the payload agrees within 1e-3
(measured 1.1e-5 and, at cpe_pilot_rat=2, 3.5e-6). At cpe_pilot_rat=2 the
CPE averages every other pilot, and both packages read 24 wrong symbols of
46,128 on mode 0 of this capture (SER 5.2e-4): there the port's SER equals
the reference float32 body's, and both stay below 1e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu.ops.pilot_chain import make_pilot_rx_chain as jax_make_pilot_rx_chain
from qampy_tpu_torch.convert import pilot_state_from_jax
from qampy_tpu_torch.core.impairments import add_carrier_offset
from qampy_tpu_torch.ops import equaliser as teq
from qampy_tpu_torch.ops import equaliser_cuda as tec
from qampy_tpu_torch.ops.phase import time_axis
from qampy_tpu_torch.ops.pilot_chain import derotate_planes, make_pilot_rx_chain

FRAME, SEQ, INS = 2 ** 14, 512, 32
FS = 48e9
FOE_HZ = 100e3
CFG = dict(os=2, nmodes=2, Ntaps=17, cpe_avg=3, frames=(0, 1, 2))
TAPS_TOL = 1e-3
AGREE_MIN = 0.999
SER_MAX = 5e-4
SER_MAX_RAT2 = 1e-3
PAYLOAD_TOL = 1e-3
PAYLOAD_TOL_BF16 = 3e-2
FOE_TOL = 1e-6          # cycles per symbol (measured: equal, the same float32 slope fit)

# name: (the port's options, the reference's options, capture)
VARIANTS = {
    "lms": (dict(return_phase=False), dict(pallas=True, return_phase=False), "plain"),
    "lms_phase": (dict(return_phase=True), dict(pallas=True, return_phase=True), "plain"),
    "sbd_data": (dict(return_phase=False, methods=("cma", "sbd_data")),
                 dict(pallas=True, return_phase=False, methods=("cma", "sbd_data")), "plain"),
    "foe": (dict(return_phase=False, foe_comp=True),
            dict(pallas=True, return_phase=False, foe_comp=True), "offset"),
    "rat2": (dict(return_phase=False, cpe_pilot_rat=2),
             dict(pallas=True, return_phase=False, cpe_pilot_rat=2), "plain"),
    "rat2_xla": (dict(return_phase=False, cpe_pilot_rat=2, pallas=False),
                 dict(pallas=False, return_phase=False, cpe_pilot_rat=2), "plain"),
    "xla": (dict(return_phase=True, pallas=False), dict(pallas=False, return_phase=True), "plain"),
}


def _decide(d, coded):
    return np.argmin(np.abs(d[..., None] - coded[None, None, :]), axis=-1)


@pytest.fixture(scope="module")
def captures():
    sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=6, nmodes=2, fb=24e9, seed=3)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    s2 = qt.impairments.simulate_transmission(s2, snr=30, dgd=20e-12, theta=np.pi / 4.7,
                                              lwdth=20e3, roll_frame_sync=True,
                                              key=jr.PRNGKey(5))
    E = np.asarray(s2.samples).astype(np.complex64)
    Eo = add_carrier_offset(torch.as_tensor(E), FOE_HZ, FS).numpy()
    coded = np.asarray(sig.coded_symbols).astype(np.complex64)
    return dict(seq=np.asarray(sig.pilot_seq), ph=np.asarray(sig.ph_pilots), coded=coded,
                E={"plain": E, "offset": Eo},
                tx_idx=_decide(np.asarray(sig.get_data(frames=[0, 1, 2]).samples), coded))


@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request, captures):
    """Both chains on one capture: the JAX payload and info, the port chain, payload and info."""
    name = request.param
    port_kw, jax_kw, which = VARIANTS[name]
    E = captures["E"][which]
    fwd = jax_make_pilot_rx_chain(captures["seq"], captures["ph"], FRAME, INS, **CFG, **jax_kw)
    if jax_kw["pallas"] and not jax_kw.get("cpe_pilot_rat", 1) > 1:
        (dr, di), info = jax.jit(fwd.planes)(np.ascontiguousarray(E.real),
                                             np.ascontiguousarray(E.imag))
        jd = np.asarray(dr) + 1j * np.asarray(di)
    else:
        jd, info = jax.jit(fwd)(E)     # the reference's XLA body has no planes entry
        jd = np.asarray(jd)
    chain = make_pilot_rx_chain(captures["seq"], captures["ph"], FRAME, INS, **CFG, **port_kw,
                                device="cpu")
    pr, pi = torch.as_tensor(E.real.copy()), torch.as_tensor(E.imag.copy())
    (tr, ti), tinfo = chain.planes(pr, pi)
    return dict(name=name, jax=jd, jinfo={k: np.asarray(v) for k, v in info.items()},
                chain=chain, planes=(pr, pi), port=(tr, ti), info=tinfo, E=E)


def test_acquired_state_agrees(run):
    info, jinfo = run["info"], run["jinfo"]
    assert info["shift"].tolist() == jinfo["shift"].tolist()
    assert info["mode_order"].tolist() == jinfo["mode_order"].tolist()
    assert float(info["sync_corr"]) == pytest.approx(float(jinfo["sync_corr"]), rel=1e-4)
    assert np.abs(info["taps"].numpy() - jinfo["taps"]).max() \
        <= TAPS_TOL * np.abs(jinfo["taps"]).max()
    assert set(info) == set(jinfo)
    assert abs(float(info["foe_pil"]) - float(jinfo["foe_pil"])) <= FOE_TOL
    assert abs(float(info["foe"]) - float(jinfo["foe"])) <= FOE_TOL


def test_decisions_and_ser(captures, run):
    got = torch.complex(*run["port"]).numpy()
    assert got.shape == run["jax"].shape
    dec, jdec = _decide(got, captures["coded"]), _decide(run["jax"], captures["coded"])
    assert np.mean(dec == jdec) >= AGREE_MIN
    ser_max = SER_MAX_RAT2 if run["name"].startswith("rat2") else SER_MAX
    sers = [np.mean(d != captures["tx_idx"], axis=-1) for d in (dec, jdec)]
    for s in sers:
        assert np.all(s < ser_max)
    if run["name"] == "rat2_xla":
        assert np.array_equal(sers[0], sers[1])


def test_payload(run):
    """Within 1e-3 of the reference's float32 body; within 3e-2 of its bf16 Pallas filter."""
    f32 = run["name"] in ("xla", "rat2_xla")
    tol = PAYLOAD_TOL if f32 else PAYLOAD_TOL_BF16
    got = torch.complex(*run["port"]).numpy()
    assert np.abs(got - run["jax"]).max() <= tol
    if "phase" in run["info"]:
        assert np.abs(run["info"]["phase"].numpy() - run["jinfo"]["phase"]).max() <= tol


def test_tracking_equals_full_chain(run):
    chain, info = run["chain"], run["info"]
    pr, pi = run["planes"]
    foe = info["foe_pil"] if chain.foe_comp else None
    (tr, ti), tinfo = chain.tracking_planes(pr, pi, info["taps"], info["shift"],
                                            info["mode_order"], foe=foe)
    assert torch.equal(tr, run["port"][0]) and torch.equal(ti, run["port"][1])
    assert torch.isinf(tinfo["sync_corr"])
    if chain.foe_comp:
        assert torch.equal(tinfo["foe_pil"], info["foe_pil"])
    d, _ = chain.tracking(torch.as_tensor(run["E"]), info["taps"], info["shift"],
                          info["mode_order"], foe=foe)
    assert torch.equal(d, torch.complex(tr, ti))


def test_tracking_on_reference_state(captures, run):
    """The port's warm-start entry demodulates with the JAX chain's acquired state."""
    jinfo, chain = run["jinfo"], run["chain"]
    foe = jinfo["foe_pil"] if chain.foe_comp else None
    state = pilot_state_from_jax(jinfo["taps"], jinfo["shift"], jinfo["mode_order"], "cpu",
                                 foe=foe)
    assert len(state) == (4 if chain.foe_comp else 3)
    (tr, ti), _ = chain.tracking_planes(*run["planes"], *state)
    dec = _decide(torch.complex(tr, ti).numpy(), captures["coded"])
    assert np.mean(dec == _decide(run["jax"], captures["coded"])) >= AGREE_MIN


def test_foe_comp_tracking_without_foe_warns(captures):
    chain = make_pilot_rx_chain(captures["seq"], captures["ph"], FRAME, INS, **CFG,
                                return_phase=False, foe_comp=True, device="cpu")
    E = captures["E"]["offset"]
    P = (torch.as_tensor(E.real.copy()), torch.as_tensor(E.imag.copy()))
    with pytest.warns(UserWarning, match="foe_pil"):
        chain.tracking_planes(*P, torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64)),
                              torch.tensor([1000, 1000]))


@pytest.mark.parametrize("kwargs, match", [
    (dict(eq_trainer="ls", foe_comp=True), "foe_comp"),
    (dict(methods=("cma_real", "cma_real")), "complex-valued"),
    (dict(methods=("cma", "dd_data_real")), "complex-valued"),
    (dict(methods=("cma",)), "two methods"),
    (dict(methods=("cma", "nope")), "unknown"),
])
def test_refused_settings(captures, kwargs, match):
    with pytest.raises(ValueError, match=match):
        make_pilot_rx_chain(captures["seq"], captures["ph"], FRAME, INS, **CFG, **kwargs,
                            device="cpu")


def test_stage_routes(captures):
    """B1 trains the stages of every method it computes; sbd_data, which it does not, takes the
    plain block trainer. A launch B1 does not take (blocks of 100: it takes multiples of 32)
    raises KernelLimit when the chain is built for the card, and on the CPU runs B1's plain
    version, as every B1 stage there does."""
    chain = make_pilot_rx_chain(captures["seq"], captures["ph"], FRAME, INS, **CFG,
                                methods=("cma", "sbd_data"), device="cpu")
    assert chain.eq_trainer == "lms" and chain.TrS_eq == 493
    assert [s is not None for s in chain.stage_specs] == [True, True, False]
    assert chain.stage_syms2.shape == (2, 1, SEQ)
    with pytest.raises(tec.KernelLimit, match="multiple of 32"):
        make_pilot_rx_chain(captures["seq"], captures["ph"], FRAME, INS, **CFG, block_size=100,
                            device="cuda")
    odd = make_pilot_rx_chain(captures["seq"], captures["ph"], FRAME, INS, **CFG,
                              block_size=100, device="cpu")
    assert all(s is not None for s in odd.stage_specs)


def test_pallas_is_taken_and_ignored(captures):
    """The reference's two frame filters compute one function, which the port's filter sums in
    float32: ``pallas=False`` builds the serving form as the default does, and its tracking
    output is bit-equal."""
    chains = [make_pilot_rx_chain(captures["seq"], captures["ph"], FRAME, INS, **CFG,
                                  return_phase=False, pallas=p, device="cpu")
              for p in (None, False)]
    assert all(c.kernel_interp for c in chains)
    E = captures["E"]["plain"]
    P = (torch.as_tensor(E.real.copy()), torch.as_tensor(E.imag.copy()))
    w = torch.as_tensor(teq._init_taps(17, 2, 2, np.complex64))
    (ar, ai), (br, bi) = (c.tracking_planes(*P, w, torch.tensor([1000, 1000]))[0]
                          for c in chains)
    assert torch.equal(ar, br) and torch.equal(ai, bi)


def test_time_axis_rounds_as_jnp():
    L = 2 ** 24 + 5
    want = np.asarray(jnp.arange(1, L + 1, dtype=jnp.float32))
    assert np.array_equal(time_axis(L, "cpu").numpy(), want)


def test_derotate_planes_against_the_reference_formula():
    rng = np.random.default_rng(4)
    P = rng.standard_normal((3, 4, 5000)).astype(np.float32)
    foe = np.float32(3.1e-4)
    got = derotate_planes(torch.as_tensor(P), torch.tensor(foe), 2).numpy()
    t = np.asarray(jnp.arange(1, 5001, dtype=jnp.float32))
    th = np.asarray((2 * np.pi * jnp.float32(foe) / 2) * t)
    c, s = np.cos(th), np.sin(th)
    want = np.concatenate([P[:, :2] * c + P[:, 2:] * s, P[:, 2:] * c - P[:, :2] * s], axis=1)
    assert np.abs(got - want).max() <= 1e-5


def test_plain_trainer_batch_rows_are_independent():
    """Per-row taps in one batch of the plain block trainer equal a training per row."""
    rng = np.random.default_rng(2)
    P = torch.as_tensor(rng.standard_normal((3, 4, 1200)).astype(np.float32))
    w0 = torch.as_tensor(rng.standard_normal((3, 1, 2, 9)) * 0.1
                         + 1j * rng.standard_normal((3, 1, 2, 9)) * 0.1).to(torch.complex64)
    spec = teq.err_spec("cma", teq._reshape_symbols(None, "cma", 4, np.complex64, 1))
    err, w, mu = teq.train_block_planes(P, 512, 2, 2, 1e-3, w0, spec, True, 64)
    assert err.shape == (3, 1, 1024) and w.shape == (3, 1, 2, 9) and mu.shape == (3, 1)
    for b in range(3):
        e1, w1, m1 = teq.train_block_planes(P[b], 512, 2, 2, 1e-3, w0[b], spec, True, 64)
        assert torch.allclose(w[b], w1, rtol=0, atol=1e-6)
        assert torch.allclose(err[b], e1, rtol=0, atol=1e-6)


def test_b1_launch_shape_takes_a_batch():
    P = torch.empty((2, 4, 2092), device="meta")
    w = torch.empty((2, 1, 2, 45), dtype=torch.complex64, device="meta")
    assert tec.block_launch_shape(P, 990, 2, w, 256) == (256, 3)
    assert tec.block_launch_shape(P, 990, 2, w[0], 256) == (256, 3)
    with pytest.raises(ValueError, match="batch rows"):
        tec.block_launch_shape(P, 990, 2, torch.empty((3, 1, 2, 45), device="meta"), 256)
    with pytest.raises(tec.KernelLimit, match="batch rows"):
        tec.block_launch_shape(torch.empty((70000, 4, 2092), device="meta"), 990, 2, w[0], 256)


def test_pilot_state_from_jax_refuses_a_foe_per_mode():
    with pytest.raises(ValueError, match="scalar foe"):
        pilot_state_from_jax(np.zeros((2, 2, 3), np.complex64), np.array([1, 2]),
                             np.array([0, 1]), "cpu", foe=np.zeros(2))
