"""``examples_torch``: the serving examples, the matlab-file one and the QPSK link, on the CPU.

Each runs through its ``main`` with ``device="cpu"`` at a reduced size under
its gates; ``qpsk_simulation`` also against the JAX example's flow at the
same size within a stated factor (tests/test_torch_examples_blind.py's
rule). The serving examples' chains are held to the JAX chains in tests/test_torch_chain*.py,
test_torch_grid_chain.py, test_torch_pilot_chain.py and
test_torch_long_capture.py; ``64qam_data_test`` reads a matlab file of
random 64-QAM symbols written by ``scipy.io.savemat`` (the reference's
capture is not in the repository).
"""
import jax.random as jr
import numpy as np

import qampy_tpu as qt
from qampy_tpu import equalisation as jeqz
from qampy_tpu import helpers as jh
from qampy_tpu import impairments as jimp
from qampy_tpu import phaserec as jph
from torch_examples_util import _common, one_thread, run, within_factor  # noqa: F401 (a fixture)


def test_qpsk_simulation():
    N, snrs = 2 ** 14, (8,)
    _, res = run("qpsk_simulation", N=N, snrs=snrs)
    fb = 25e9
    for snr_db, ber in zip(snrs, res["ber"]):
        sig = qt.SignalQAMGrayCoded(4, N, nmodes=2, fb=fb, seed=1)
        s2 = sig.resample(2 * fb, beta=0.1, renormalise=True)
        s2 = jimp.apply_phase_noise(s2, 50e3, key=jr.PRNGKey(2))
        s2 = jimp.change_snr(jimp.apply_PMD(s2, np.pi / 4.7, 30e-12), snr_db,
                             key=jr.PRNGKey(snr_db))
        E, _, _ = jeqz.equalise_signal(s2, 2e-3, Ntaps=17, method="cma", adaptive_stepsize=True,
                                       apply=True)
        rec, _ = jph.viterbiviterbi(E, 41)
        rec = rec.replace(samples=jh.dump_edges(rec.samples, 30))
        within_factor(ber, float(np.mean(np.asarray(rec.cal_ber()))), 2, 10 / (4 * N))


def test_64qam_data_test(tmp_path):
    mod = _common.load("64qam_data_test")
    fn = mod.write_test_file(str(tmp_path / "x.mat"), N=2 ** 13)
    res = mod.main(device="cpu", mat=fn)
    assert not _common.gate_failures(mod.GATES, res)


def test_fused_rx_serving():
    run("fused_rx_serving", N=2 ** 14, TrSyms=2 ** 12, nframes=4, frames=(0, 1))


def test_general_alphabet_serving():
    run("general_alphabet_serving", N=2 ** 15, TrSyms=2 ** 14, nframes=3)


def test_long_capture_serving():
    _, res = run("long_capture_serving", Nsym=2 ** 16, chunk_sym=2 ** 14, n_per=2, ndisp=3,
                 frame_len=2 ** 14, Ntaps=17)
    assert len(res["blind_chunk_ser"]) == 4 and len(res["pilot_ser"]) == 3
