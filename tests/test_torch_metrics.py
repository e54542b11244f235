"""The port's metrics, sync, helpers, utils, theory, special functions and PRBS against JAX's.

Inputs are made from a seed with numpy and handed to both packages. A
function without randomness and without float sums in another order is
compared exactly; float32 reductions that the two packages sum in another
order within the stated rtol; the Monte-Carlo GMI, whose noise comes from
``jax.random`` in the reference and from a ``torch.Generator`` in the port,
by its statistics.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qampy_tpu import helpers as rhelp
from qampy_tpu import prbs as rprbs
from qampy_tpu import theory as rtheory
from qampy_tpu import utils as rutils
from qampy_tpu.core import metrics as rmet
from qampy_tpu.core import special as rspec
from qampy_tpu.core import sync as rsync
from qampy_tpu_torch import helpers as thelp
from qampy_tpu_torch import prbs as tprbs
from qampy_tpu_torch import theory as ttheory
from qampy_tpu_torch import utils as tutils
from qampy_tpu_torch.core import metrics as tmet
from qampy_tpu_torch.core import special as tspec
from qampy_tpu_torch.core import sync as tsync
from test_torch_signals import first_vml_call  # noqa: F401 (autouse fixture)

# float32 sums of a few thousand terms in another order
RTOL_SUM = 2e-5


def _const(M):
    return (rtheory.cal_symbols_qam(M) / np.sqrt(rtheory.cal_scaling_factor_qam(M))).astype(
        np.complex64)


def _noisy(M, L, snr_db, seed, nmodes=2):
    rng = np.random.default_rng(seed)
    c = _const(M)
    tx = c[rng.integers(0, M, (nmodes, L))]
    n = (rng.standard_normal((nmodes, L)) + 1j * rng.standard_normal((nmodes, L))) / np.sqrt(2)
    return (tx + 10 ** (-snr_db / 20) * n).astype(np.complex64), tx, c


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# core/metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4, 16, 64])
def test_make_decision(M):
    """Decided symbols, indices exact; distances within an ulp."""
    E, _, c = _noisy(M, 4096, 14, seed=M)
    d_r, dist_r, i_r = rmet.make_decision(E, c)
    d_t, dist_t, i_t = tmet.make_decision(torch.as_tensor(E), torch.as_tensor(c))
    assert np.array_equal(_np(i_r), _np(i_t)) and np.array_equal(_np(d_r), _np(d_t))
    np.testing.assert_allclose(_np(dist_t), _np(dist_r), rtol=1e-6, atol=1e-7)
    s_r, q_r = rmet.det_symbol(E[0, 5], c)
    s_t, q_t = tmet.det_symbol(torch.as_tensor(E[0, 5]), torch.as_tensor(c))
    assert complex(_np(s_r)) == complex(_np(s_t))
    np.testing.assert_allclose(float(q_t), float(q_r), rtol=1e-6)


@pytest.mark.parametrize("M", [4, 16, 64, 256])
def test_bitmapping_mtx(M):
    """The bit map is host numpy in both: equal."""
    c = _const(M)
    enc = ((np.arange(M)[:, None] >> np.arange(int(np.log2(M)) - 1, -1, -1)) & 1).astype(bool)
    assert np.array_equal(rmet.generate_bitmapping_mtx(c, enc.ravel(), M),
                          tmet.generate_bitmapping_mtx(c, enc.ravel(), M))


@pytest.mark.parametrize("M, snr", [(4, 10), (16, 12), (64, 20)])
def test_estimate_snr(M, snr):
    """SNR, S0 and N0 per mode within RTOL_SUM (segment sums in another order)."""
    E, tx, c = _noisy(M, 8192, snr, seed=3)
    for m in range(2):
        ref = [float(v) for v in rmet.estimate_snr(E[m], tx[m], c)]
        got = [float(v) for v in tmet.estimate_snr(torch.as_tensor(E[m]), torch.as_tensor(tx[m]),
                                                   torch.as_tensor(c))]
        np.testing.assert_allclose(got, ref, rtol=RTOL_SUM)
    batched = tmet.estimate_snr(torch.as_tensor(E), torch.as_tensor(tx), torch.as_tensor(c))[0]
    np.testing.assert_allclose(_np(batched), [float(rmet.estimate_snr(E[m], tx[m], c)[0])
                                              for m in range(2)], rtol=RTOL_SUM)


@pytest.mark.parametrize("minmax", [False, True], ids=["exact", "minmax"])
@pytest.mark.parametrize("M", [4, 16, 64])
def test_soft_demappers(M, minmax):
    """L-values within 1e-4 relative to their scale; chunked past 2^16 samples as one pass."""
    E, _, c = _noisy(M, 2 ** 16 + 300, 15, seed=7, nmodes=1)
    enc = ((np.arange(M)[:, None] >> np.arange(int(np.log2(M)) - 1, -1, -1)) & 1).astype(bool)
    bmap = rmet.generate_bitmapping_mtx(c, enc.ravel(), M)
    snr = 10 ** 1.5
    fr = rmet.soft_l_value_demapper_minmax if minmax else rmet.soft_l_value_demapper
    ft = tmet.soft_l_value_demapper_minmax if minmax else tmet.soft_l_value_demapper
    ref = _np(fr(E[0], snr, bmap))
    got = _np(ft(torch.as_tensor(E[0]), snr, torch.as_tensor(bmap)))
    assert got.shape == ref.shape == (E.shape[1], int(np.log2(M)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("M", [16, 64, 1.32])
def test_blind_estimators(M):
    """cal_snr_qam, cal_s0, norm_to_s0, gamma: float32 means over the capture, RTOL_SUM."""
    E, _, _ = _noisy(16 if M == 1.32 else M, 8192, 18, seed=5)
    assert tmet._cal_gamma(M) == rmet._cal_gamma(M)
    for fn in ("cal_snr_qam", "cal_s0"):
        np.testing.assert_allclose(float(getattr(tmet, fn)(torch.as_tensor(E), M)),
                                   float(getattr(rmet, fn)(E, M)), rtol=RTOL_SUM)
    np.testing.assert_allclose(_np(tmet.norm_to_s0(torch.as_tensor(E), M)),
                               _np(rmet.norm_to_s0(E, M)), rtol=RTOL_SUM, atol=1e-6)


def test_blind_qpsk_snr():
    """cal_snr_blind_qpsk in dB within 1e-4 dB."""
    E, _, _ = _noisy(4, 8192, 15, seed=9, nmodes=1)
    np.testing.assert_allclose(float(tmet.cal_snr_blind_qpsk(torch.as_tensor(E[0]))),
                               float(rmet.cal_snr_blind_qpsk(E[0])), atol=1e-4)


@pytest.mark.parametrize("known", [False, True], ids=["blind", "known"])
@pytest.mark.parametrize("M", [16, 64])
def test_cal_evm(M, known):
    """EVM blind and against known symbols, RTOL_SUM."""
    E, tx, _ = _noisy(M, 4096, 18, seed=11, nmodes=1)
    k = tx[0] if known else None
    np.testing.assert_allclose(
        float(tmet.cal_evm(torch.as_tensor(E[0]), M, None if k is None else torch.as_tensor(k))),
        float(rmet.cal_evm(E[0], M, k)), rtol=RTOL_SUM)


@pytest.mark.parametrize("M", [4, 16, 64])
def test_cal_ser_qam(M):
    """The same errors counted."""
    E, tx, _ = _noisy(M, 4096, 10 + M // 4, seed=13, nmodes=1)
    assert float(tmet.cal_ser_qam(torch.as_tensor(E[0]), torch.as_tensor(tx[0]), M)) == \
        float(rmet.cal_ser_qam(E[0], tx[0], M))


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "mc"])
@pytest.mark.parametrize("M", [4, 16])
def test_cal_mi(M, fast):
    """Mutual information within 1e-5 relative (means of float32 logs in chunks)."""
    E, tx, c = _noisy(M, 3000, 8, seed=17, nmodes=1)
    N0 = 10 ** -0.8
    np.testing.assert_allclose(
        float(tmet.cal_mi(torch.as_tensor(E[0]), torch.as_tensor(tx[0]), torch.as_tensor(c), N0,
                          fast)),
        float(rmet.cal_mi(E[0], tx[0], c, N0, fast)), rtol=1e-5)


def test_cal_mi_mc_chunks_as_one():
    """The port's chunked Monte-Carlo MI over 2^16 + 5 draws is one mean over all of them."""
    rng = np.random.default_rng(1)
    z = ((rng.standard_normal(2 ** 16 + 5) + 1j * rng.standard_normal(2 ** 16 + 5)) * 0.2
         ).astype(np.complex64)
    c = _const(4)
    np.testing.assert_allclose(float(tmet.cal_mi_mc(torch.as_tensor(z), torch.as_tensor(c), 0.08)),
                               float(rmet.cal_mi_mc(z, c, 0.08)), rtol=1e-5)


@pytest.mark.parametrize("M, snr", [(4, 5.0), (16, 12.0)])
def test_cal_gmi_mc_statistics(M, snr):
    """Monte-Carlo GMI: other noise draws, the same distribution.

    Both at 2e4 draws from five seeds each: the means agree within four
    standard errors of their difference, and each lies within 0.02 bit of
    the other package's.
    """
    from qampy_tpu.signals import SignalQAMGrayCoded as RS
    s = RS(M, 16, nmodes=1)
    syms, bmap = np.asarray(s.coded_symbols), np.asarray(s.bitmap_mtx)
    snr_lin = 10 ** (snr / 10)
    r = np.array([float(rmet.cal_gmi_mc(syms, snr_lin, 20000, bmap, seed=k)) for k in range(5)])
    t = np.array([float(tmet.cal_gmi_mc(torch.as_tensor(syms), snr_lin, 20000,
                                        torch.as_tensor(bmap), seed=k)) for k in range(5)])
    se = np.sqrt(r.var(ddof=1) / 5 + t.var(ddof=1) / 5)
    assert abs(r.mean() - t.mean()) <= max(4 * se, 1e-3) and abs(r.mean() - t.mean()) < 0.02
    assert len(set(t.tolist())) == 5 and float(tmet.cal_gmi_mc(
        torch.as_tensor(syms), snr_lin, 20000, torch.as_tensor(bmap), seed=2)) == t[2]


# ---------------------------------------------------------------------------
# core/sync
# ---------------------------------------------------------------------------

@pytest.fixture
def seqs():
    rng = np.random.default_rng(42)
    return (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)


@pytest.mark.parametrize("shift", [0, 1, 43, 1000, -43])
def test_find_sequence_offset(seqs, shift):
    y = np.roll(seqs, shift)
    assert int(tsync.find_sequence_offset(torch.as_tensor(seqs), torch.as_tensor(y))) == \
        int(rsync.find_sequence_offset(seqs, y))
    ac_t = tsync.find_sequence_offset(torch.as_tensor(seqs), torch.as_tensor(y), show_cc=True)[1]
    ac_r = rsync.find_sequence_offset(seqs, y, show_cc=True)[1]
    np.testing.assert_allclose(_np(ac_t), _np(ac_r), atol=2e-2)


@pytest.mark.parametrize("rot", [0, 1, 2, 3])
@pytest.mark.parametrize("shift", [0, 200])
def test_find_sequence_offset_complex(seqs, rot, shift):
    """Offset and quarter turn equal, the turned sequence exactly equal, the peak within 1e-5."""
    y = np.roll(seqs, shift) * (1j ** rot)
    i_r, y_r, ii_r, a_r = rsync.find_sequence_offset_complex(seqs, y.astype(np.complex64))
    yt = torch.as_tensor(y.astype(np.complex64))
    i_t, y_t, ii_t, a_t = tsync.find_sequence_offset_complex(torch.as_tensor(seqs), yt)
    assert (i_t, ii_t) == (int(i_r), int(ii_r))
    assert np.array_equal(_np(y_t), _np(y_r))
    np.testing.assert_allclose(a_t, float(a_r), rtol=1e-5)


def test_find_sequence_offset_real():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1000).astype(np.float32)
    y = np.roll(x, 17)
    i_r, _, ii_r, a_r = rsync.find_sequence_offset_complex(x, y)
    i_t, _, ii_t, a_t = tsync.find_sequence_offset_complex(torch.as_tensor(x), torch.as_tensor(y))
    assert (i_t, ii_t) == (int(i_r), int(ii_r)) and np.isclose(a_t, float(a_r), rtol=1e-5)


@pytest.mark.parametrize("adjust", ["tx", "rx"])
@pytest.mark.parametrize("lens", [(4096, 4096), (4096, 3000), (3000, 4096)],
                         ids=["equal", "tx longer", "rx longer"])
def test_sync_and_adjust(seqs, adjust, lens):
    """Every branch: the adjusted pair equal to the reference's."""
    y = (np.roll(seqs, 321) * 1j).astype(np.complex64)
    tx, rx = seqs[:lens[0]], y[:lens[1]]
    (t_r, r_r), a_r = rsync.sync_and_adjust(tx, rx, adjust=adjust)
    (t_t, r_t), a_t = tsync.sync_and_adjust(torch.as_tensor(tx), torch.as_tensor(rx),
                                            adjust=adjust)
    assert np.array_equal(_np(t_t), _np(t_r)) and np.array_equal(_np(r_t), _np(r_r))
    np.testing.assert_allclose(a_t, float(a_r), rtol=1e-5)


@pytest.mark.parametrize("method", [None, "truncate", "extend"])
@pytest.mark.parametrize("offset", [0, 7])
def test_adjust_data_length(method, offset):
    a = np.arange(10, dtype=np.float32)
    b = np.arange(23, dtype=np.float32)
    for x, y in ((a, b), (b, a), (a, a)):
        r = rsync.adjust_data_length(x, y, method=method, offset=offset)
        t = tsync.adjust_data_length(torch.as_tensor(x), torch.as_tensor(y), method=method,
                                     offset=offset)
        assert all(np.array_equal(_np(p), _np(q)) for p, q in zip(t, r))
    for back in (True, False):
        assert np.array_equal(_np(tsync._adjust_to(torch.as_tensor(a), 27, back)),
                              _np(rsync._adjust_to(a, 27, back)))


def test_cal_ber_helpers():
    """cal_ber_syncd, cal_ber_nosyncd (with an inverted stream), sync_rx2tx, sync_tx2rx."""
    tx = rprbs.make_prbs_extXOR(15, 5000, seed=None)
    rx = np.roll(tx, 311)[:4000].copy()
    rx[::97] ^= True
    assert tsync.cal_ber_nosyncd(rx, tx) == rsync.cal_ber_nosyncd(rx, tx)
    assert tsync.cal_ber_nosyncd(~rx, tx) == rsync.cal_ber_nosyncd(~rx, tx)
    assert tsync.cal_ber_syncd(rx, rx) == rsync.cal_ber_syncd(rx, rx)
    with pytest.raises(ValueError, match="wrong sync"):
        tsync.cal_ber_syncd(rx, ~rx)
    data = np.random.default_rng(0).integers(0, 256, 3000).astype(np.uint8)
    rolled = np.roll(data, 55)
    for fn in ("sync_rx2tx", "sync_tx2rx"):
        o_t, a_t = getattr(tsync, fn)(data, rolled, 32)
        o_r, a_r = getattr(rsync, fn)(data, rolled, 32)
        assert o_t == o_r and np.array_equal(a_t, a_r)
    with pytest.raises(tsync.DataSyncError):
        tsync.sync_rx2tx(data, np.full(3000, 7, np.uint8), 32, imax=3)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1000), (1000,)], ids=["2-D", "1-D"])
def test_helpers(shape):
    rng = np.random.default_rng(21)
    E = (rng.standard_normal(shape) * 3 + 1 + 1j * (rng.standard_normal(shape) - 2)
         ).astype(np.complex64)
    T = torch.as_tensor(E)
    np.testing.assert_allclose(_np(thelp.normalise_and_center(T)),
                               _np(rhelp.normalise_and_center(E)), rtol=RTOL_SUM, atol=1e-6)
    np.testing.assert_allclose(_np(thelp.set_mid_point(T, 0.5)), _np(rhelp.set_mid_point(E, 0.5)),
                               atol=1e-6)
    np.testing.assert_allclose(_np(thelp.rescale_signal(T, 2)), _np(rhelp.rescale_signal(E, 2)),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(thelp.set_mid_and_rescale(T, 0.1, 3)),
                               _np(rhelp.set_mid_and_rescale(E, 0.1, 3)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(thelp.get_center_shift_fac(T)).reshape(-1),
                               _np(rhelp.get_center_shift_fac(E)).reshape(-1), rtol=RTOL_SUM)
    assert np.array_equal(_np(thelp.dump_edges(T, 10)), _np(rhelp.dump_edges(E, 10)))
    assert np.array_equal(_np(thelp.cabssquared(T)), _np(rhelp.cabssquared(E)))
    idx = np.arange(0, shape[-1], 7)
    np.testing.assert_allclose(_np(thelp.normalise_and_center_pil(T, idx)),
                               _np(rhelp.normalise_and_center_pil(E, idx)), rtol=RTOL_SUM,
                               atol=1e-6)


def test_helpers_units_and_pilot_mask():
    for x in (3.0, np.array([1.0, 20.0])):
        np.testing.assert_allclose(thelp.dB2lin(x), _np(rhelp.dB2lin(x)), rtol=1e-6)
        np.testing.assert_allclose(thelp.lin2dB(x), _np(rhelp.lin2dB(x)), rtol=1e-6)
    np.testing.assert_allclose(_np(thelp.dB2lin(torch.tensor([3.0]))), [10 ** 0.3], rtol=1e-6)
    for args in ((2, 2 ** 12, 2, 256, 32), (3, 1024, 1, 64, 16)):
        assert np.array_equal(thelp.find_pilot_idx(*args), rhelp.find_pilot_idx(*args))


def test_helpers_object_aware():
    """A helper given a signal returns a signal with the attributes carried over."""
    from qampy_tpu_torch.signals import SignalQAMGrayCoded
    s = SignalQAMGrayCoded(16, 1000, nmodes=2, fb=25e9, seed=1, device="cpu") * 3
    out = thelp.normalise_and_center(s)
    assert isinstance(out, SignalQAMGrayCoded) and out.fb == 25e9 and out.M == 16
    np.testing.assert_allclose(_np(out.samples.abs().pow(2).mean(-1)), [1, 1], rtol=1e-5)
    assert thelp.dump_edges(s, 5).shape == (2, 990)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_utils_bits():
    rng = np.random.default_rng(2)
    for _ in range(5):
        x = rng.integers(0, 2, 40).astype(bool)
        assert tutils.bool2bin(x) == rutils.bool2bin(x)
    data = rng.integers(0, 9, 500).astype(np.int32)
    assert tutils.find_offset(data[123:140], data) == rutils.find_offset(data[123:140], data)
    assert np.array_equal(tutils.linspacestep(1.5, 0.25, 9), rutils.linspacestep(1.5, 0.25, 9))
    assert [tutils.factorial(n) for n in range(8)] == [rutils.factorial(n) for n in range(8)]
    i, q = rng.integers(0, 2, 101), rng.integers(0, 2, 97)
    for nbits in (2, 3, 4, 6):
        assert np.array_equal(tutils.convert_iqtosinglebitstream(i, q, nbits),
                              rutils.convert_iqtosinglebitstream(i, q, nbits))
    g_t, g_r = tutils.lfsr_int(0b1011, 2 ** 7 + 2 ** 6 + 1), rutils.lfsr_int(0b1011,
                                                                            2 ** 7 + 2 ** 6 + 1)
    assert [next(g_t) for _ in range(300)] == [next(g_r) for _ in range(300)]
    e_t, e_r = tutils.lfsr_ext(0b1110011, (7, 6), 7), rutils.lfsr_ext(0b1110011, (7, 6), 7)
    assert [next(e_t) for _ in range(300)] == [next(e_r) for _ in range(300)]


@pytest.mark.parametrize("wrap", [False, True])
def test_rolling_window(wrap):
    x = np.arange(2 * 50, dtype=np.float32).reshape(2, 50)
    assert np.array_equal(_np(tutils.rolling_window(torch.as_tensor(x), 7, wrap)),
                          _np(rutils.rolling_window(x, 7, wrap)))


@pytest.mark.parametrize("end", ["cut", "pad", "wrap"])
@pytest.mark.parametrize("axis", [-1, 0, None])
def test_segment_axis(end, axis):
    x = np.arange(3 * 23, dtype=np.float32).reshape(3, 23)
    if axis == 0:
        x = x.T.copy()
    r = rutils.segment_axis(x, 5, 2, axis=axis, end=end, endvalue=-1)
    t = tutils.segment_axis(torch.as_tensor(x), 5, 2, axis=axis, end=end, endvalue=-1)
    assert np.array_equal(_np(t), _np(r))


# ---------------------------------------------------------------------------
# theory and core/special
# ---------------------------------------------------------------------------

def test_theory_curves():
    """SER/BER curves in float32, within 1e-6 relative of the reference's."""
    snr = np.array([1.0, 3.0, 10.0, 30.0], dtype=np.float32)
    for M in (16, 64):
        for fn in ("ser_vs_es_over_n0_qam", "ber_vs_es_over_n0_qam"):
            np.testing.assert_allclose(_np(getattr(ttheory, fn)(snr, M)),
                                       _np(getattr(rtheory, fn)(snr, M)), rtol=1e-5)
        np.testing.assert_allclose(_np(ttheory.ber_vs_evm_qam(np.array([-20.0, -15.0]), M)),
                                   _np(rtheory.ber_vs_evm_qam(np.array([-20.0, -15.0]), M)),
                                   rtol=1e-5)
    for M in (4, 8, 16):
        np.testing.assert_allclose(_np(ttheory.ser_vs_es_over_n0_psk(snr, M)),
                                   _np(rtheory.ser_vs_es_over_n0_psk(snr, M)), rtol=1e-5)
        np.testing.assert_allclose(ttheory.cal_symbols_psk(M), rtheory.cal_symbols_psk(M))
    np.testing.assert_allclose(_np(ttheory.ser_vs_es_over_n0_4pam(snr)),
                               _np(rtheory.ser_vs_es_over_n0_4pam(snr)), rtol=1e-5)
    np.testing.assert_allclose(_np(ttheory.q_function(np.array([0.5, 2.0]))),
                               _np(rtheory.q_function(np.array([0.5, 2.0]))), rtol=1e-6)
    np.testing.assert_allclose(_np(ttheory.hybrid_qam_ber_vs_esn0(np.array([10., 15.]), 1.3, 0.5,
                                                                  16, 64)),
                               _np(rtheory.hybrid_qam_ber_vs_esn0(np.array([10., 15.]), 1.3, 0.5,
                                                                  16, 64)), rtol=1e-5)
    # the verify skill's anchor: 16-QAM SER at Es/N0 = 12 dB
    assert abs(float(ttheory.ser_vs_es_over_n0_qam(10 ** 1.2, 16)) - 1.09e-1) < 1e-3


def test_probabilistic_shaping():
    """Probabilities exact; the shaped symbols the same draws, normalised within RTOL_SUM."""
    c = _const(64)
    for nu in (0.0, 0.1):
        st, pt = ttheory.cal_ps_probablts(c, nu)
        sr, pr = rtheory.cal_ps_probablts(c, nu)
        assert np.array_equal(st, sr) and np.array_equal(pt, pr)
    for norm in (False, True):
        t = ttheory.generate_ps_symbols(2000, st, pt, normalize=norm, seed=4)
        r = np.asarray(rtheory.generate_ps_symbols(2000, sr, pr, normalize=norm, seed=4))
        np.testing.assert_allclose(t, r, rtol=RTOL_SUM, atol=1e-6)


def test_sim_mi_mc():
    """The reference's numpy noise from one seed: within 1e-5 relative."""
    c = _const(16)
    np.testing.assert_allclose(ttheory.sim_mi_mc(c, 10.0, 3000, seed=2, device="cpu"),
                               rtheory.sim_mi_mc(c, 10.0, 3000, seed=2), rtol=1e-5)


def test_theory_cal_gmi_statistics():
    """Monte-Carlo GMI of 16-QAM at 10 and 15 dB: within 0.03 bit of the reference's."""
    t = ttheory.cal_gmi(16, np.array([10.0, 15.0]), N=5000, seed=1, device="cpu")
    r = rtheory.cal_gmi(16, np.array([10.0, 15.0]), N=5000, seed=1)
    assert t.shape == r.shape == (2,) and np.all(np.abs(t - r) < 0.03) and t[1] > t[0]


def test_special_functions():
    t = np.linspace(-5, 5, 41, dtype=np.float32)
    for fn, args in (("ttanh", (1.5, 0.2, 2.0)), ("gauss", (1.5, 0.2, 2.0)),
                     ("supergauss", (1.5, 0.2, 2.0, 3)), ("sech", (1.5, 0.2, 2.0)),
                     ("rcos_time", (0.25, 1.0)), ("rcos_freq", (0.25, 1.0)),
                     ("rrcos_freq", (0.25, 1.0)), ("rrcos_time", (0.25, 1.0)),
                     ("rcos_freq", (0.0, 1.0))):
        x = t / 4 if "freq" in fn else t
        np.testing.assert_allclose(_np(getattr(tspec, fn)(x, *args)),
                                   _np(getattr(rspec, fn)(jnp.asarray(x), *args)),
                                   rtol=2e-5, atol=2e-6, err_msg=fn)
    np.testing.assert_allclose(_np(tspec.q_function(t)), _np(rspec.q_function(t)), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# prbs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [7, 15, 23, 31])
def test_prbs_ext(order):
    for seed in (None, 0b1011, np.ones(order, bool)):
        assert np.array_equal(tprbs.make_prbs_extXOR(order, 5000, seed),
                              rprbs.make_prbs_extXOR(order, 5000, seed))
    assert np.array_equal(tprbs.make_prbs_extXOR(order, 5), rprbs.make_prbs_extXOR(order, 5))


@pytest.mark.parametrize("order", [7, 15])
def test_prbs_int(order):
    assert np.array_equal(tprbs.make_prbs_intXOR(order, 3000), rprbs.make_prbs_intXOR(order, 3000))
    with pytest.raises(ValueError, match="Only orders"):
        tprbs.make_prbs_intXOR(9, 10)
