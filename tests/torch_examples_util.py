"""Helpers of the tests of ``examples_torch``: loading a script, running it on the CPU, gating."""
import pathlib
import sys

import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples_torch"
if str(EXAMPLES) not in sys.path:
    sys.path.insert(0, str(EXAMPLES))

import _common  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Each example test on one intra-op thread: the examples' plain loops are many small ops,
    which several threads per worker, on a host whose cores the other workers share, spend
    waiting (a 2^14-symbol serving run took 45 s under six workers against 0.4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(name, skip=(), **sizes):
    """(module, result) of the example ``name``'s ``main`` on the CPU at ``sizes``; every gate
    of the example is held but those named in ``skip``."""
    mod = _common.load(name)
    res = mod.main(device="cpu", **sizes)
    gates = {k: v for k, v in mod.GATES.items() if k not in skip}
    assert not _common.gate_failures(gates, res), _common.gate_failures(gates, res)
    return mod, res


def within_factor(port, ref, factor, floor):
    """Each figure of ``port`` within ``factor`` of ``ref``'s, either way, less ``floor``
    (the count of a few events at this size): port <= f ref + floor and ref <= f port + floor."""
    port, ref = np.atleast_1d(np.asarray(port, float)), np.atleast_1d(np.asarray(ref, float))
    assert port.shape == ref.shape
    ok = np.all(port <= factor * ref + floor) and np.all(ref <= factor * port + floor)
    assert ok, "port %s, JAX %s (factor %s, floor %s)" % (port, ref, factor, floor)
