"""``examples_torch``: the blind equalisation and serving examples on the CPU at a reduced size.

Each runs through its ``main`` with ``device="cpu"`` under its gates. The
BASELINE examples that draw noise are also held to the JAX example's flow at
the same size (in the test, on the JAX package) within a stated factor: the
two packages draw different noise. The others hold their gates only, to
keep the JAX side of this file small (the JAX equalisers compile their
scans on the CPU): ``64_qam_equalisation`` and ``mrde_equaliser`` run MRDE,
``higher_order_qam`` and ``32_qam_equalisation`` the cross and dense grids,
and the serving scripts the chains that tests/test_torch_chain*.py,
test_torch_grid_chain.py, test_torch_pilot_chain.py and
test_torch_long_capture.py hold to the JAX chains (the serving examples:
tests/test_torch_examples_serving.py).
"""
import jax.random as jr
import numpy as np

import qampy_tpu as qt
from qampy_tpu import equalisation as jeqz
from qampy_tpu import helpers as jh
from qampy_tpu import impairments as jimp
from torch_examples_util import one_thread, run, within_factor  # noqa: F401 (a fixture)


def test_cma_equaliser():
    N = 2 ** 13
    _, res = run("cma_equaliser", N=N)
    fb = 40e9
    sig = qt.SignalQAMGrayCoded(4, N, nmodes=2, fb=fb, seed=1).resample(2 * fb, beta=0.1)
    sig = jimp.apply_PMD(jimp.change_snr(sig, 14, key=jr.PRNGKey(0)), np.pi / 5.65, 100e-12)
    E, _, _ = jeqz.equalise_signal(sig, 1e-3, Ntaps=17, method="cma", adaptive_stepsize=True,
                                   apply=True)
    E = E.replace(samples=jh.normalise_and_center(E.samples))
    # symbol errors where the filter hangs off the capture's ends (6 of 16,384 on a JAX mode
    # and none on the port's at 2^14): within ten symbols' worth either way
    within_factor(res["ser"], np.asarray(E.cal_ser()), 2, 10 / N)
    # the EVM after the equaliser: within 0.3 dB (two noise draws over 2^13 symbols)
    assert np.all(np.abs(np.asarray(res["evm_db"]) - 20 * np.log10(np.asarray(E.cal_evm())))
                  <= 0.3)


def test_64_qam_equalisation():
    run("64_qam_equalisation", N=2 ** 15)


def test_32_qam_equalisation():
    run("32_qam_equalisation", N=2 ** 13)


def test_mrde_equaliser():
    _, res = run("mrde_equaliser", N=2 ** 14)
    assert all(o < i for o, i in zip(res["evm_out_pct"], res["evm_in_pct"]))


def test_higher_order_qam():
    run("higher_order_qam", N=2 ** 13)


def test_ber_vs_evm_with_equalisation():
    _, res = run("ber_vs_evm_with_equalisation", N=2 ** 12, snrs_db=(10.0, 20.0))
    assert len(res["ser"]) == 4 and res["ber_over_theory"]
