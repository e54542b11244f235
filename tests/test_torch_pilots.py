"""The port's granular pilot API (``ops/pilots.py``) and its helpers, against the JAX package's.

Frame sync, shift handling, the two-stage pilot equaliser, the pilot FOE
and both pilot CPEs on the capture of tests/test_torch_pilot_chain.py
(``SignalWithPilots(64, 2**14, 512, 32, nframes=6)``); the frequency-offset
estimate and compensation (``ops/phase.py``), the moving average
(``core/filter.py``) and the carrier offset (``core/impairments.py``) on
seeded numpy data. Both packages run on the CPU. Tolerances are stated per
test with what was measured.
"""
import numpy as np
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

import qampy_tpu as qt
from qampy_tpu.core import filter as jfilter
from qampy_tpu.core import impairments as jimp
from qampy_tpu.ops import phase as jphase
from qampy_tpu.ops import pilots as jp
from qampy_tpu_torch import workload
from qampy_tpu_torch.core import filter as tfilter
from qampy_tpu_torch.core import impairments as timp
from qampy_tpu_torch.ops import phase as tphase
from qampy_tpu_torch.ops import pilots as tp
from qampy_tpu_torch.ops._build import KernelLimit
from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain

FRAME, SEQ, INS = 2 ** 14, 512, 32


@pytest.fixture(scope="module")
def cap():
    sig = qt.SignalWithPilots(64, FRAME, SEQ, INS, nframes=6, nmodes=2, fb=24e9, seed=3)
    s2 = sig.resample(2 * sig.fb, beta=0.1, renormalise=True)
    s2 = qt.impairments.simulate_transmission(s2, snr=30, dgd=20e-12, theta=np.pi / 4.7,
                                              lwdth=20e3, roll_frame_sync=True,
                                              key=jr.PRNGKey(5))
    E = np.asarray(s2.samples).astype(np.complex64)
    # the sent symbols at 1 sample per symbol, rotated by a random walk, with noise: the
    # input of the CPEs
    S = np.asarray(sig.samples).astype(np.complex64)[:, :2 * FRAME]
    rng = np.random.default_rng(1)
    ph = np.cumsum(rng.normal(scale=2e-3, size=S.shape), axis=-1)
    noise = 0.03 * (rng.standard_normal(S.shape) + 1j * rng.standard_normal(S.shape))
    R = (S * np.exp(1j * ph) + noise).astype(np.complex64)
    _, _, idx_pil = qt.SignalWithPilots._cal_pilot_idx(FRAME, SEQ, INS)
    return dict(E=E, seq=np.asarray(sig.pilot_seq), ph=np.asarray(sig.ph_pilots), R=R,
                pidx=np.nonzero(idx_pil)[0][SEQ:])


@pytest.fixture(scope="module")
def sync(cap):
    want = jp.frame_sync(cap["E"], cap["seq"], 2, frame_len=FRAME)
    got = tp.frame_sync(torch.as_tensor(cap["E"]), cap["seq"], 2, frame_len=FRAME, device="cpu")
    return want, got


def test_frame_sync(sync):
    """Shifts, mode order and the sync flag equal; the coarse FOE equal (an FFT bin); the
    taps of the last window within 1e-5 of max|taps| (measured 1.8e-7: 493 steps of two
    float32 per-symbol recurrences)."""
    want, got = sync
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[2], want[2])
    assert got[4] is want[4] is True
    assert np.array_equal(got[1], np.asarray(want[1]))
    assert got[3].shape == want[3].shape == (2, 2, 17)
    assert np.abs(got[3] - want[3]).max() <= 1e-5 * np.abs(want[3]).max()


@pytest.mark.parametrize("kwargs, match", [(dict(method="cma_real"), "real-valued"),
                                           (dict(method="sbd_data"), "data-aided")])
def test_frame_sync_refuses(cap, kwargs, match):
    with pytest.raises(ValueError, match=match):
        tp.frame_sync(torch.as_tensor(cap["E"]), cap["seq"], 2, frame_len=FRAME,
                      device="cpu", **kwargs)


def test_frame_sync_of_a_short_capture(cap):
    with pytest.raises(ValueError, match="as long as frame"):
        tp.frame_sync(torch.as_tensor(cap["E"][:, :20000]), cap["seq"], 2, frame_len=FRAME,
                      device="cpu")


@pytest.mark.parametrize("shifts, ntaps", [([1000, 1002], (17, 45)), ([0, 7], (17, 21)),
                                           ([5], (9, 13))])
def test_correct_shifts(shifts, ntaps):
    assert np.array_equal(tp.correct_shifts(shifts, ntaps, 2),
                          jp.correct_shifts(shifts, ntaps, 2))


def test_correct_shifts_refuses():
    with pytest.raises(ValueError, match="improperly"):
        tp.correct_shifts([4, 4], (17, 44), 2)


@pytest.mark.parametrize("shifts", [[3, 11], [7], [0, 0]])
def test_shift_signal(cap, shifts):
    """Exact: a roll."""
    E = cap["E"][:, :5000] if len(shifts) > 1 else cap["E"][0, :5000]
    got = tp.shift_signal(torch.as_tensor(E), shifts, device="cpu").numpy()
    assert np.array_equal(got, np.asarray(jp.shift_signal(E, shifts)))


@pytest.mark.parametrize("foe_comp, spread", [(False, 0), (True, 0), (True, 2)],
                         ids=["one_shift", "foe", "per_mode"])
def test_equalize_pilot_sequence(cap, sync, foe_comp, spread):
    """Both on the CPU's exact per-symbol trainer (``backend="auto"``), 3 passes a stage:
    taps within 1e-4 of max|taps| (measured 6e-8); the pilot FOE within 1e-9 cycles per
    symbol (measured 2e-12 of 2.2e-5). ``per_mode``: shifts that differ train mode by mode."""
    sh = jp.correct_shifts(sync[0][0], (17, 45), 2) + np.array([0, spread])
    want = jp.equalize_pilot_sequence(cap["E"], cap["seq"], sh, 2, Niter=3, foe_comp=foe_comp)
    got = tp.equalize_pilot_sequence(torch.as_tensor(cap["E"]), cap["seq"], sh, 2, Niter=3,
                                     foe_comp=foe_comp, device="cpu")
    assert got[0].shape == want[0].shape == (2, 2, 45)
    assert np.abs(got[0] - want[0]).max() <= 1e-4 * np.abs(want[0]).max()
    assert np.abs(got[1] - want[1]).max() <= 1e-9
    assert (np.abs(got[1]).max() > 0) == foe_comp


def test_pilot_based_foe(cap):
    """The slope fit of the two packages: within 1e-9 cycles per symbol (measured 0 for the
    mean, 2.9e-11 per mode) and the intercept within 1e-6 rad (measured 8.9e-8)."""
    rec = cap["R"][:, :SEQ] * np.exp(2j * np.pi * 3e-4 * np.arange(SEQ)).astype(np.complex64)
    want = jp.pilot_based_foe(rec, cap["seq"])
    got = tp.pilot_based_foe(torch.as_tensor(rec), cap["seq"], device="cpu")
    assert abs(float(got[0]) - float(want[0])) <= 1e-9
    assert float(got[0]) == pytest.approx(3e-4, abs=2e-5)
    assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 1e-9
    assert np.abs(got[2].numpy() - np.asarray(want[2])).max() <= 1e-6


@pytest.mark.parametrize("kwargs", [dict(num_average=3), dict(num_average=5, use_pilot_ratio=2),
                                    dict(num_average=7, nframes=2),
                                    dict(num_average=3, max_num_blocks=400)])
def test_pilot_based_cpe(cap, kwargs):
    """Output and trace within 5e-5 (measured up to 1.0e-5 over two frames): the reference
    averages by a difference of float32 cumulative sums, the port sums each window."""
    want = jp.pilot_based_cpe(cap["R"], cap["ph"], cap["pidx"], FRAME, **kwargs)
    got = tp.pilot_based_cpe(torch.as_tensor(cap["R"]), cap["ph"], cap["pidx"], FRAME,
                             device="cpu", **kwargs)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 5e-5
    assert tp.pilot_based_cpe_new is tp.pilot_based_cpe


def test_pilot_based_cpe_even_average_warns(cap):
    with pytest.warns(UserWarning, match="odd"):
        tp.pilot_based_cpe(torch.as_tensor(cap["R"]), cap["ph"], cap["pidx"], FRAME,
                           num_average=4, device="cpu")
    with pytest.raises(ValueError, match="at least 3"):
        tp.pilot_based_cpe(torch.as_tensor(cap["R"]), cap["ph"], cap["pidx"], FRAME,
                           device="cpu")


@pytest.mark.parametrize("kwargs", [dict(num_average=3), dict(num_average=5, use_pilot_ratio=2),
                                    dict(num_average=4, max_num_blocks=300,
                                         remove_phase_pilots=False)])
def test_pilot_based_cpe_legacy(cap, kwargs):
    """Data and trace within 2e-5 (measured 3e-6), the cumulative sums as above."""
    rec = cap["R"][:, SEQ:FRAME]
    want = jp.pilot_based_cpe_legacy(rec, cap["ph"], INS, **kwargs)
    got = tp.pilot_based_cpe_legacy(torch.as_tensor(rec), cap["ph"], INS, device="cpu",
                                    **kwargs)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 2e-5


@pytest.mark.parametrize("entry", ["frame_sync", "shift_signal", "equalize_pilot_sequence",
                                   "pilot_based_foe", "pilot_based_cpe",
                                   "pilot_based_cpe_legacy"])
def test_entries_default_to_the_card(cap, entry):
    """With no ``device`` each entry takes its signal, a host array here, to the card; without
    one that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    E, R = cap["E"], cap["R"]
    calls = {
        "frame_sync": lambda: tp.frame_sync(E, cap["seq"], 2, frame_len=FRAME),
        "shift_signal": lambda: tp.shift_signal(E, [3, 11]),
        "equalize_pilot_sequence": lambda: tp.equalize_pilot_sequence(E, cap["seq"], [100, 100],
                                                                      2, Niter=1),
        "pilot_based_foe": lambda: tp.pilot_based_foe(R[:, :SEQ], cap["seq"]),
        "pilot_based_cpe": lambda: tp.pilot_based_cpe(R, cap["ph"], cap["pidx"], FRAME,
                                                      num_average=3),
        "pilot_based_cpe_legacy": lambda: tp.pilot_based_cpe_legacy(R[:, SEQ:FRAME], cap["ph"],
                                                                    INS, num_average=3),
    }
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
        calls[entry]()


def test_frame_sync_on_the_card_refuses_what_b9_does_not_take(cap):
    """65 taps per output mode over 2 modes is 130 taps, past B9's 128: ``KernelLimit`` from
    the shapes, before the capture is moved, rather than the plain trainer on the card."""
    with pytest.raises(KernelLimit, match="128"):
        tp.frame_sync(cap["E"], cap["seq"], 2, frame_len=FRAME, Ntaps=65, device="cuda")


@pytest.mark.parametrize("shape, N", [((2, 3000), 5), ((3000,), 3), ((2, 3, 100), 7)])
def test_moving_average(shape, N):
    """Within 1e-5 of the reference's cumulative sums (measured 2.5e-6 and 3.3e-6 at 3,000
    samples), and within an ulp-scale 1e-6 of the float64 window mean (measured 1.8e-7)."""
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    got = tfilter.moving_average(torch.as_tensor(x), N).numpy()
    want = np.asarray(jfilter.moving_average(x, N))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    ref = np.stack([x[..., k:k + x.shape[-1] - N + 1].astype(np.float64)
                    for k in range(N)]).mean(axis=0)
    assert np.abs(got - ref).max() <= 1e-6


@pytest.mark.parametrize("os_", [1, 2])
def test_find_and_comp_freq_offset(cap, os_):
    """The estimate equal (an FFT bin of a power-of-2 axis); the compensated signal within
    1e-6 (measured 2.5e-7: cos, sin and the complex product rounded apart)."""
    Z = (cap["R"] * np.exp(2j * np.pi * 0.013 * np.arange(cap["R"].shape[-1]))
         ).astype(np.complex64)
    want = np.asarray(jphase.find_freq_offset(Z, os=os_))
    got = tphase.find_freq_offset(torch.as_tensor(Z), os=os_)
    assert np.array_equal(got.numpy(), want)
    assert float(got[0, 0]) == pytest.approx(0.013 * os_, abs=1e-4)
    per = tphase.find_freq_offset(torch.as_tensor(Z), os=os_, average_over_modes=False)
    assert np.array_equal(per.numpy(), np.asarray(jphase.find_freq_offset(
        Z, os=os_, average_over_modes=False)))
    comp = tphase.comp_freq_offset(torch.as_tensor(Z), got, os=os_).numpy()
    assert np.abs(comp - np.asarray(jphase.comp_freq_offset(Z, want, os=os_))).max() <= 1e-6
    one = tphase.comp_freq_offset(torch.as_tensor(Z[0]), float(want[0, 0]), os=os_).numpy()
    assert one.shape == Z[0].shape and np.abs(one - comp[0]).max() == 0


def test_add_carrier_offset():
    """Within 2e-6 of the float64 product (measured 9.1e-7, the complex64 rounding of values
    up to |x| ~ 5) and within 1e-4 of the reference at 2^15 samples (measured 3.7e-5): the
    port reckons the phase in float64 cycles, the reference in float32, whose phase of up to
    86 rad here is rounded to 7.6e-6 rad."""
    x = (np.random.default_rng(7).standard_normal((2, 2 ** 15))
         + 1j * np.random.default_rng(8).standard_normal((2, 2 ** 15))).astype(np.complex64)
    got = timp.add_carrier_offset(torch.as_tensor(x), 20e6, 48e9).numpy()
    exact = x * np.exp(2j * np.pi * np.arange(2 ** 15) * (20e6 / 48e9))
    assert np.abs(got - exact).max() <= 2e-6
    assert np.abs(got - np.asarray(jimp.add_carrier_offset(x, 20e6, 48e9))).max() <= 1e-4


def test_pilot_tx_with_freq_off_needs_foe_comp():
    """A 20 MHz offset on the port's own capture: the LMS chain with ``foe_comp`` passes the
    bench's BER gate and reads the offset (8.33e-4 cycles per symbol at 24 GBd, within
    5e-5); the same chain without it fails the gate."""
    tx = workload.make_pilot_tx(6, frame_len=FRAME, seq_len=SEQ, freq_off=20e6, seed=1,
                                device="cpu")
    cfg = dict(os=2, nmodes=2, Ntaps=17, sync_mu=5e-3, cpe_avg=3, frames=(0, 1),
               block_size=256, return_phase=False)
    gates = []
    for foe_comp in (True, False):
        chain = make_pilot_rx_chain(tx.pilot_seq, tx.ph_pilots, FRAME, INS, foe_comp=foe_comp,
                                    device="cpu", **cfg)
        (dr, di), info = chain.planes(tx.planes[:2], tx.planes[2:])
        gates.append(workload.ber_gate(dr, di, tx, info["sync_corr"])["ok"])
        if foe_comp:
            assert float(info["foe_pil"]) == pytest.approx(20e6 / 24e9, abs=5e-5)
    assert gates == [True, False]


def test_new_modules_import_no_jax():
    """``ops.pilots`` and ``core.filter`` import torch and numpy only, as the whole port does."""
    import subprocess
    import sys
    code = ("import sys, qampy_tpu_torch.ops.pilots, qampy_tpu_torch.core.filter; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'qampy_tpu', 'triton')]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
