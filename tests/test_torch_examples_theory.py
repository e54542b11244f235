"""``examples_torch``: every example ported, and the analytic and noise-only ones on the CPU.

Every example of ``examples/`` (less ``_common.py``) has a port of the same
file name with ``main`` and ``GATES``, imports nothing of JAX, quotes no TPU
figure, and raises without a card unless given ``device="cpu"``. Then the
examples whose output is a function of their inputs alone are held to the
JAX functions they call, on the same inputs; those that draw noise are run
at a reduced size under their gates and held to the JAX example's figure
at that size (its flow on the JAX package, in the test) within a stated
factor: the two packages draw different noise.
"""
import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import qampy_tpu as qt
from qampy_tpu import impairments as jimp
from qampy_tpu import theory as jtheory
from torch_examples_util import (EXAMPLES, _common, one_thread, run,  # noqa: F401 (a fixture)
                                 within_factor)

REF_EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NAMES = sorted(p.stem for p in REF_EXAMPLES.glob("*.py") if p.stem != "_common")


def test_every_example_is_ported():
    assert NAMES == list(_common.NAMES) and len(NAMES) == 26


@pytest.mark.parametrize("name", NAMES)
def test_example_source(name):
    src = (EXAMPLES / (name + ".py")).read_text()
    tree = ast.parse(src)
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.split(".")[0] in ("jax", "qampy_tpu") for m in mods), mods
    assert "TPU" not in src and "v5e" not in src and "PRNGKey" not in src
    doc = ast.get_docstring(tree)
    assert "examples/%s.py" % name in doc and "--device cpu" in doc
    mod = _common.load(name)
    assert callable(mod.main) and mod.GATES


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_a_card(name, tmp_path):
    mod = _common.load(name)
    kw = {"mat": mod.write_test_file(str(tmp_path / "x.mat"), N=64)} \
        if name == "64qam_data_test" else {}
    with pytest.raises((AssertionError, RuntimeError)):
        mod.main(**kw)


def test_command_line():
    """``--device cpu`` on the command line (without it, ``main`` raises: the test above)."""
    script = str(EXAMPLES / "tx_distortion_test.py")
    out = subprocess.run([sys.executable, script, "--device", "cpu"], capture_output=True,
                         text=True)
    assert out.returncode == 0 and "overdriven MZM" in out.stdout


def test_theory_curves():
    _, res = run("theory_curves")
    snr = 10 ** (np.asarray(res["snr_db"]) / 10)
    for M in (4, 16, 64):
        np.testing.assert_allclose(res["ser"][M], np.asarray(jtheory.ser_vs_es_over_n0_qam(snr, M)),
                                   rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(res["ber"][M], np.asarray(jtheory.ber_vs_es_over_n0_qam(snr, M)),
                                   rtol=1e-5, atol=1e-30)
    # Monte-Carlo GMI over 500 symbols: the packages draw differently
    want = np.asarray(jtheory.cal_gmi(16, np.array([10., 15., 20.]), N=500))
    np.testing.assert_allclose(res["gmi16"], want, atol=0.1)


def _jax_noise_signal(M, N, snr_db, key, seed, **kw):
    sig = qt.SignalQAMGrayCoded(M, N, nmodes=1, seed=seed, **kw)
    return jimp.change_snr(sig, snr_db, key=jr.PRNGKey(key))


def test_modulation_formats():
    N = 2 ** 15
    _, res = run("modulation_formats", N=N)
    mod = _common.load("modulation_formats")
    for i, (M, snr_db) in enumerate(mod.CASES):
        n = _jax_noise_signal(M, N, snr_db, M, M, fb=25e9)
        np.testing.assert_allclose(res["ser_theory"][i],
                                   float(jtheory.ser_vs_es_over_n0_qam(10 ** (snr_db / 10), M)),
                                   rtol=1e-5)
        # counted errors: a factor of 2 either way, less 5 symbols' (bits') worth
        within_factor(res["ser"][i], float(np.mean(np.asarray(n.cal_ser()))), 2, 5 / N)
        within_factor(res["ber"][i], float(np.mean(np.asarray(n.cal_ber()))), 2,
                      5 / (N * np.log2(M)))


def test_ber_vs_evm():
    N = 2 ** 15
    _, res = run("ber_vs_evm", N=N)
    sig = qt.SignalQAMGrayCoded(16, N, nmodes=1, seed=7)
    for snr, ber, evm, ber_evm in zip(res["snr_db"], res["ber"], res["evm"], res["ber_evm"]):
        # the analytic part on the port's own EVM
        assert ber_evm == pytest.approx(float(jtheory.ber_vs_evm_qam(20 * np.log10(evm), 16)),
                                        rel=1e-5)
        n = jimp.change_snr(sig, snr, key=jr.PRNGKey(int(snr)))
        within_factor(ber, float(np.asarray(n.cal_ber(synced=True))[0]), 1.5, 10 / (4 * N))
        within_factor(evm, float(np.asarray(n.cal_evm(synced=True, blind=False))[0]), 1.05, 0)


def test_probabilistic_shaping():
    _, res = run("probabilistic_shaping", N=2 ** 14)
    assert res["label"][0] == "uniform 64-QAM" and len(res["mi"]) == 3
    # the uniform 64-QAM at 18 dB: about 5.4 bits in both packages (a noise draw)
    assert 5.2 <= res["mi"][0] <= 5.6


def test_tx_model():
    _, res = run("tx_model", N=2 ** 14)
    assert len(res["snr_db"]) == 4


def test_tx_distortion_test():
    _, res = run("tx_distortion_test", N=2 ** 14)
    # the quantiser and the analytic noise power on the JAX package's signal: the same samples
    sig = qt.SignalQAMGrayCoded(16, 2 ** 14, nmodes=1, fb=20e9, seed=1).resample(40e9, beta=0.2)
    x = sig.samples
    from qampy_tpu.core import impairments as jci
    delta = float(jnp.maximum(jnp.abs(x.real).max(), jnp.abs(x.imag).max())) / 2 ** 5
    sq = jci.quantize_signal_New(x, nbits=6, rescale_in=True, rescale_out=True)
    ratio = float(jnp.mean(jnp.abs(sq - x) ** 2)) / 2 / (delta ** 2 / 12)
    assert res["quantiser_ratio"] == pytest.approx(ratio, rel=1e-3)
    assert res["snr_theory_db"] == pytest.approx(
        float(10 * np.log10(float(jnp.mean(jnp.abs(x.real) ** 2)) * 12 / delta ** 2)), abs=1e-3)


def test_phase_recovery():
    N = 2 ** 15
    _, res = run("phase_recovery", N=N)
    from qampy_tpu import helpers as jh, phaserec as jph
    sig = qt.SignalQAMGrayCoded(64, N, fb=40e9, seed=3)
    sig = jimp.apply_phase_noise(jimp.change_snr(sig, 30, key=jr.PRNGKey(2)), 100e3,
                                 key=jr.PRNGKey(3))
    rec, _ = jph.bps_twostage(sig, 32, 14, B=8)
    ser = np.asarray(rec.replace(samples=jh.dump_edges(rec.samples, 20)).cal_ser())
    within_factor(res["ser"], ser, 2, 5 / N)


def test_phase_recovery_sweep():
    _, res = run("phase_recovery_sweep", N=2 ** 15, linewidths=(100.0, 10e3))
    assert len(res["twostage_ser"]) == len(res["onestage_ser"]) == 2
