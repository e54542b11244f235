"""A run with the timed path broken underneath comes out not correct; so does the control.

Each test drives the whole run after the look for a card (``harness.measure``)
on the CPU, where the program runs its plain twins, at the small sizes of
``conftest.SMALL``, with one fault of ``benchmark/faults.py`` planted in the
program's own code: a step that returns its state unchanged, half of the batch
left out, the derotation or the blind glue's unwrap left undone, an answer
altered where it is produced. (The cells run on one card: there is no exchange
between cards to leave out.) The seeds are ones on which the receivers lock at
these sizes, as the sound run beside the faults shows.
"""
import time

import pytest
import torch

from benchmark import control, faults
from benchmark.lib import harness, spec

SEED = {"blind64-d16.stream": 3, "blind64-d16.track": 3, "pilot64.track": 1}


def run(root, cell_name, seconds=0.5):
    cell = spec.cell(root, cell_name, bench=root / "benchmark")
    res, compared = harness.measure(cell, SEED[cell_name], seconds, False, "cpu",
                                    time.perf_counter())
    return res["correct"], {n: v for n, v, _, _ in compared}


FAULTS = [(cell, f) for cell in sorted(SEED)
          for f in faults.FAULTS["pilot" if cell.startswith("pilot") else "blind"]]


@pytest.mark.parametrize("cell", sorted(SEED))
def test_a_sound_run_is_correct(small_root, cell):
    ok, numbers = run(small_root, cell)
    assert ok, numbers


@pytest.mark.parametrize("cell,fault", FAULTS, ids=["%s-%s" % (c, f.name) for c, f in FAULTS])
def test_a_fault_in_the_timed_path_is_caught(small_root, cell, fault):
    with faults.planted(fault):
        ok, numbers = run(small_root, cell)
    assert not ok, numbers


@pytest.mark.parametrize("cell", sorted(SEED))
def test_the_control_fails_the_limits(small_root, cell):
    c = spec.cell(small_root, cell, bench=small_root / "benchmark")
    lim = c.config["limits"]
    prog, ctl = control.readings(c, SEED[cell], 0.5, "cpu")
    name = "mismatch" if "mismatch" in lim else "gap"      # the number the control fails
    assert prog[name] <= lim[name] < ctl[name], (prog, ctl)
    torch.set_num_threads(2)
