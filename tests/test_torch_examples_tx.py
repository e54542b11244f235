"""``examples_torch``: the transmitter-model pilot examples and the multi-rank one, on the CPU.

At a reduced size, under their gates: ``constant_ase_noise_model`` with
frames of 2^12 symbols, a 256-symbol pilot sequence and 3 passes of the
frame search (tests/test_torch_examples_pilot.py says why), and
``tx_model_full_compensation`` at frames of 2^13 with 256 pilots (its frame
sync fails at 2^12 on its one mode) and at full drive only. Their figures
come from the transmitter models that tests/test_torch_tx_impairments.py
holds to the JAX package's, and the receiver that
tests/test_torch_baseline.py holds. ``multichip_scaling`` starts its four
gloo ranks on the CPU, at 2^15 symbols and frames of 2^12; the sharded
receivers are held to the JAX package's in tests/test_torch_parallel.py.
"""
from torch_examples_util import one_thread, run  # noqa: F401 (a fixture)

SMALL = dict(frame_len=2 ** 12, seq_len=256, sync_Niter=3)


def test_constant_ase_noise_model():
    run("constant_ase_noise_model", **SMALL)


def test_tx_model_full_compensation():
    _, res = run("tx_model_full_compensation", frame_len=2 ** 13, seq_len=256, sync_Niter=3,
                 drives=(7.0,))
    assert len(res["ser"]) == 2


def test_multichip_scaling():
    _, res = run("multichip_scaling", N=2 ** 15, frame_len=2 ** 12)
    assert res["ranks"] == 4
