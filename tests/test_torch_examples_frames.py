"""``examples_torch``: ``pilot_tests`` and ``tx_impairment_simulation`` on the CPU, reduced.

Under all their gates, with frames of 2^12 symbols, a 256-symbol pilot
sequence and 3 passes of the frame search (tests/test_torch_examples_pilot.py
says why those sizes). Their receivers are the one that
tests/test_torch_baseline.py holds to the JAX package's at this size
(``tx_impairment_simulation``'s chain is BASELINE config 5 there).
"""
from torch_examples_util import one_thread, run  # noqa: F401 (a fixture)

SMALL = dict(frame_len=2 ** 12, seq_len=256, sync_Niter=3)


def test_pilot_tests():
    run("pilot_tests", **SMALL)


def test_tx_impairment_simulation():
    run("tx_impairment_simulation", N=2 ** 12, P=256, roll=1000, sync_Niter=3)
