"""The transmitter models: ``core/impairments.py``'s rest, ``core/digital_pre_compensation.py``.

Held to the JAX package: the quantisers and ``find_sym_patterns`` exactly
(the quantiser levels are rounded as the reference rounds them), the
modulator, ``cal_lut`` and the deterministic models within 1e-6 (float32
arithmetic in another order), the filters within 1e-5 of the rms. The
random ones (ENOB noise, SNR) by the statistics of their noise, and the
same output for the same generator seed.
"""
import jax.random as jr
import numpy as np
import pytest
import torch

from qampy_tpu.core import digital_pre_compensation as jdpc
from qampy_tpu.core import impairments as jimp
from qampy_tpu_torch.core import digital_pre_compensation as tdpc
from qampy_tpu_torch.core import impairments as timp

TOL = 1e-6


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rms_close(got, want, rel=1e-5):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.sqrt(np.mean(np.abs(want) ** 2))


@pytest.mark.parametrize("num", [4, 16, 64, 256])
@pytest.mark.parametrize("start, stop", [(-1, 1), ("mid", "mid")])
def test_float32_linspace_is_the_references(num, start, stop):
    import jax.numpy as jnp
    if start == "mid":
        d = 2 / num
        start, stop = -1 + d / 2, 1 - d / 2
    want = np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32))
    assert np.array_equal(timp.float32_linspace(start, stop, num), want)


@pytest.mark.parametrize("nbits", [2, 4, 6, 8])
@pytest.mark.parametrize("kw", [dict(), dict(rescale=False, re_normalize=False)])
def test_quantize_signal_exact(nbits, kw):
    x = _x((2, 5000), nbits, 0.4)
    want = np.asarray(jimp.quantize_signal(x, nbits=nbits, **kw))
    got = timp.quantize_signal(torch.as_tensor(x), nbits=nbits, **kw)
    if kw:
        assert np.array_equal(_np(got), want)
    else:
        # re-normalised: a mean and a power summed in other orders
        assert np.abs(_np(got) - want).max() <= TOL


@pytest.mark.parametrize("nbits", [3, 6])
@pytest.mark.parametrize("kw", [dict(), dict(rescale_in=False, rescale_out=False)])
def test_quantize_signal_new_exact(nbits, kw):
    x = _x((2, 5000), 10 + nbits, 0.3)
    want = np.asarray(jimp.quantize_signal_New(x, nbits=nbits, **kw))
    got = _np(timp.quantize_signal_New(torch.as_tensor(x), nbits=nbits, **kw))
    assert np.array_equal(got, want)


def test_quantizers_on_a_real_signal():
    x = np.random.default_rng(3).standard_normal((1, 3000)).astype(np.float32)
    got = _np(timp.quantize_signal_New(torch.as_tensor(x), nbits=5))
    want = np.asarray(jimp.quantize_signal_New(x, nbits=5))
    assert np.array_equal(got, want)
    got = _np(timp.quantize_signal(torch.as_tensor(x), nbits=5, re_normalize=False))
    assert np.array_equal(got, np.asarray(jimp.quantize_signal(x, nbits=5, re_normalize=False)))


@pytest.mark.parametrize("kw", [dict(), dict(dcbias=0.9, gfactr=0.95, cfactr=0.1),
                                dict(dcbias=1 + 0.8j, gfactr=0.9 + 0.97j, cfactr=0.05 - 0.1j,
                                     dcbias_out=0.4, gfactr_out=0.9)])
def test_modulator_response(kw):
    x = _x((2, 4000), 4, 0.5)
    want = np.asarray(jimp.modulator_response(x, **kw))
    got = _np(timp.modulator_response(torch.as_tensor(x), **kw))
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() <= TOL


def test_transmitter_scalings():
    x = _x((2, 3000), 5, 2.0)
    t = torch.as_tensor(x)
    assert np.abs(_np(timp.ideal_amplifier_response(t, 1.3))
                  - np.asarray(jimp.ideal_amplifier_response(x, 1.3))).max() <= TOL
    assert timp.er_to_g(13.0) == jimp.er_to_g(13.0)
    assert np.abs(_np(tdpc.clipper(t, 1.5)) - np.asarray(jdpc.clipper(x, 1.5))).max() == 0
    y = _x((2, 3000), 6, 0.3)
    y = (np.tanh(y.real) + 1j * np.tanh(y.imag)).astype(np.complex64)     # arcsin's domain
    assert np.abs(_np(tdpc.comp_mod_sin(torch.as_tensor(y), 1.14 + 0.9j))
                  - np.asarray(jdpc.comp_mod_sin(y, 1.14 + 0.9j))).max() <= TOL
    theta = 0.37
    assert np.abs(_np(timp.rotate_field(t, theta))
                  - np.asarray(jimp.rotate_field(x, theta))).max() <= TOL


def test_H_PMD():
    omega = np.linspace(-3e11, 3e11, 1001).astype(np.float32)
    H_w, h3_w = jimp.H_PMD(0.4, 20e-12, omega)
    H_g, h3_g = timp.H_PMD(0.4, 20e-12, torch.as_tensor(omega))
    assert np.abs(_np(H_g) - np.asarray(H_w)).max() <= TOL
    assert np.abs(_np(h3_g) - np.asarray(h3_w)).max() <= TOL


def test_add_dispersion():
    """Against the formula in float64 within 1e-5 of the rms; the reference's float32
    phase (~omega^2 beta2 L / 2 of up to 3e3 rad here) is off by up to ~2e-4 rad."""
    x = _x((2, 4096), 7)
    fs, D, L = 80e9, 17e-6, 20e3
    omega = np.fft.fftfreq(4096, 1 / fs) * 2 * np.pi
    beta2 = D * 1550e-9 ** 2 / (2.99792458e8 * 2 * np.pi)
    H = np.exp(-0.5j * omega ** 2 * beta2 * L)
    want = np.fft.fftshift(np.fft.ifft(np.fft.fft(np.fft.ifftshift(x, axes=-1), axis=-1) * H,
                                       axis=-1), axes=-1)
    got = timp.add_dispersion(torch.as_tensor(x), fs, D, L)
    _rms_close(got, want)
    _rms_close(got, jimp.add_dispersion(x, fs, D, L), rel=1e-3)


@pytest.mark.parametrize("fn", [False, True])
def test_apply_DAC_filter(tmp_path, fn):
    x = _x((2, 3000), 8)
    kw = {}
    if fn:
        f = np.linspace(0, 40e9, 400)
        resp = np.stack([f, np.exp(-(f / 20e9) ** 2), -f / 1e11], axis=1)
        path = tmp_path / "dac.npz"
        np.savez(path, dac_res_ch1=resp)
        kw = dict(fn=str(path), ch=1)
        assert np.array_equal(timp.load_dac_response(str(path), 80e9, 3000),
                              jimp.load_dac_response(str(path), 80e9, 3000))
    want = jimp.apply_DAC_filter(x, 80e9, cutoff=16e9, **kw)
    _rms_close(timp.apply_DAC_filter(torch.as_tensor(x), 80e9, cutoff=16e9, **kw), want)


@pytest.mark.parametrize("kw", [dict(clip_rat=1.0), dict(clip_rat=0.8, quant_bits=6)])
def test_sim_dac_and_tx_response_without_noise(kw):
    x = _x((2, 3000), 9)
    want = jimp.sim_DAC_response(x, 80e9, enob=0, cutoff=16e9, **kw)
    got = timp.sim_DAC_response(torch.as_tensor(x), 80e9, enob=0, cutoff=16e9, **kw)
    _rms_close(got, want)
    dac = dict(cutoff=16e9, fn=None, ch=None)
    want = jimp.sim_tx_response(x, 80e9, enob=0, tgt_v=0.9, dac_params=dac, **kw)
    got = timp.sim_tx_response(torch.as_tensor(x), 80e9, enob=0, tgt_v=0.9, dac_params=dac, **kw)
    assert np.abs(_np(got) - np.asarray(want)).max() <= 1e-5


def test_enob_noise_statistics():
    """The noise power 2 step^2 / 12, step = peak / 2^(enob-1): within 2 % on 2 x 2^16
    samples (its standard error there ~0.4 %); the SNR the ENOB allows equal to the
    reference's; one generator seed, one output."""
    x = _x((2, 2 ** 16), 11)
    enob = 5
    t = torch.as_tensor(x)
    out, snr = timp.apply_enob_as_awgn(t, enob, verbose=True, generator=_gen(1))
    _, snr_ref = jimp.apply_enob_as_awgn(x, enob, verbose=True, key=jr.PRNGKey(1))
    assert abs(float(snr) - float(snr_ref)) <= 1e-4
    step = max(np.abs(x.real).max(), np.abs(x.imag).max()) / 2 ** (enob - 1)
    p = np.mean(np.abs(_np(out) - x) ** 2)
    assert abs(p / (2 * step ** 2 / 12) - 1) < 0.02
    again = timp.apply_enob_as_awgn(t, enob, generator=_gen(1))
    assert torch.equal(again, out)
    dac = timp.sim_DAC_response(t, 80e9, enob=enob, generator=_gen(1))
    assert torch.equal(dac, out)


def test_change_snr_statistics():
    x = _x((2, 2 ** 16), 12) / np.sqrt(2)
    out = timp.change_snr(torch.as_tensor(x), 20, 20e9, 40e9, _gen(3))
    p_s = np.mean(np.abs(x) ** 2)
    p_n = np.mean(np.abs(_np(out) - x) ** 2)
    assert abs(10 * np.log10(p_s / p_n) - (20 - 10 * np.log10(2))) < 0.1


@pytest.mark.parametrize("M, N", [(4, 3), (8, 2), (16, 3)])
def test_find_sym_patterns_exact(M, N):
    ref = np.linspace(-1, 1, M).astype(np.float32)
    rng = np.random.default_rng(M + N)
    s = (ref[rng.integers(0, M, 3000)] + 0.05 * rng.standard_normal(3000)).astype(np.float32)
    want = np.asarray(jdpc.find_sym_patterns(s, ref, N))
    got = tdpc.find_sym_patterns(torch.as_tensor(s), ref, N)
    assert got.dtype == torch.int64 and np.array_equal(_np(got), want)
    _, pt = tdpc.find_sym_patterns(torch.as_tensor(s), ref, N, ret_ptrns=True)
    assert np.array_equal(pt, jdpc.find_sym_patterns(s, ref, N, ret_ptrns=True)[1])


def test_find_sym_patterns_past_int32():
    """256^4 = 2^32: the weights overflow int32; the port's int64 index is the pattern's."""
    rng = np.random.default_rng(4)
    ref = np.arange(256).astype(np.float32)
    idx = rng.integers(0, 256, 500)
    got = _np(tdpc.find_sym_patterns(torch.as_tensor(ref[idx]), ref, 4))
    ext = np.concatenate([idx, idx[:3]])
    want = sum(ext[k:k + 500].astype(np.int64) * 256 ** (3 - k) for k in range(4))
    assert np.array_equal(got, want) and got.max() > 2 ** 31


@pytest.mark.parametrize("real_ptrns", [True, False])
def test_cal_lut(real_ptrns):
    syms = np.array([-3, -1, 1, 3], dtype=np.float32)
    ref = (syms[:, None] + 1j * syms[None, :]).flatten().astype(np.complex64)
    rng = np.random.default_rng(5)
    tx = ref[rng.integers(0, 16, 4000)]
    rx = (tx + 0.1 * (rng.standard_normal(4000) + 1j * rng.standard_normal(4000))
          + 0.05 * np.roll(tx, 1)).astype(np.complex64)
    mask = rng.random(4000) > 0.2
    want = jdpc.cal_lut(tx, rx, ref, mem_len=3, idx_data=mask, real_ptrns=real_ptrns)
    got = tdpc.cal_lut(torch.as_tensor(tx), torch.as_tensor(rx), ref, mem_len=3, idx_data=mask,
                       real_ptrns=real_ptrns)
    assert np.array_equal(_np(got[1]), np.asarray(want[1]))
    assert np.array_equal(_np(got[2]), np.asarray(want[2]))
    assert np.abs(_np(got[0]) - np.asarray(want[0])).max() <= TOL
    assert torch.equal(tdpc.cal_lut_avg(torch.as_tensor(rx[:1000]), got[1], got[2],
                                        got[0].numel()),
                       tdpc.cal_lut_avg(torch.as_tensor(rx[:1000]), got[1], got[2],
                                        got[0].numel()))


def test_cal_lut_refuses_2d_signals():
    with pytest.raises(ValueError, match="1d"):
        tdpc.cal_lut(torch.zeros(2, 10, dtype=torch.complex64),
                     torch.zeros(2, 10, dtype=torch.complex64), np.ones(4))


def test_comp_dac_resp():
    """Within 1e-5 of its peak: the RRC spectrum is float32 in both (cos of another
    library), and the Wiener ratio carries its rounding (measured 3.7e-6)."""
    want = jdpc.comp_dac_resp(32e9, 4096, 0.1)
    got = tdpc.comp_dac_resp(32e9, 4096, 0.1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
