"""Faults planted in the program's timed path, to show that ``correct`` comes out false.

Each fault replaces one function of the program, where the chain's module looks
it up, for the length of a ``with planted(fault):`` block. ``FAULTS`` names them
by the system they break:

- ``unchanged_taps``: the trainer returns its taps as it got them;
- ``half_the_modes`` / ``half_the_frames``: the filter leaves half of its batch out;
- ``left_undone``: the derotation returns its input;
- ``unwrap_skipped``: the blind glue takes the decimated phase without its pi/2 unwrap;
- ``one_answer_altered``: one output symbol in 256 of the first mode is moved by about a
  level spacing, where the derotation produces it.

``benchmark/tests/test_bench_faults.py`` runs them on the CPU at small sizes;
``benchmark/control.py --faults`` reads them at a cell's own size.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Callable, NamedTuple

BLIND = "qampy_tpu_torch.ops.chain"
PILOT = "qampy_tpu_torch.ops.pilot_chain"
#: the share of the first mode's symbols that ``one_answer_altered`` moves
ALTERED_SHARE = 1 / 256


class Fault(NamedTuple):
    name: str
    module: str
    attr: str
    make: Callable


@contextlib.contextmanager
def planted(fault):
    """Replace ``fault.module.fault.attr`` by ``fault.make(original)`` for the duration."""
    mod = importlib.import_module(fault.module)
    orig = getattr(mod, fault.attr)
    setattr(mod, fault.attr, fault.make(orig))
    try:
        yield
    finally:
        setattr(mod, fault.attr, orig)


def unchanged_taps(orig):
    def train_block(P, TrSyms, Niter, os, mu, wx, spec, *a, **k):
        return None, wx, None
    return train_block


def left_undone(orig):
    def rotate(er, ei, a, b, dx, sign=-1):
        return er.clone(), ei.clone()
    return rotate


def half_the_modes(orig):
    def apply_filter(P, os, wx, dec=None):
        out = orig(P, os, wx, dec)
        for x in (out if isinstance(out, tuple) else (out,)):
            n = x.shape[0] // 2
            x[n // 2:n] = 0
            x[n + n // 2:] = 0
        return out
    return apply_filter


def half_the_frames(orig):
    def apply_filter_frames(P, os, wx, offs, frame_len, pilots=None):
        out = orig(P, os, wx, offs, frame_len, pilots)
        for x in (out if isinstance(out, tuple) else (out,)):
            x[:, :, x.shape[2] // 2:] = 0
        return out
    return apply_filter_frames


def unwrap_skipped(orig):
    import torch

    def decimated_derotation_inputs(eqr, eqi, idxd, lo_a, step_a, dec):
        er, ei, _, _ = orig(eqr, eqi, idxd, lo_a, step_a, dec)
        phd = lo_a + step_a * idxd.to(torch.float32)
        b = torch.nn.functional.pad(phd[:, 1:] - phd[:, :-1], (0, 1)) / dec
        return er, ei, phd, b
    return decimated_derotation_inputs


def one_answer_altered(orig):
    def rotate(er, ei, a, b, dx, sign=-1):
        outr, outi = orig(er, ei, a, b, dx, sign)
        n = max(1, int(outr.shape[-1] * ALTERED_SHARE))
        outr[0, 1000:1000 + n] += 0.3          # about a level spacing at unit power
        return outr, outi
    return rotate


FAULTS = {
    "blind": [Fault("unchanged_taps", BLIND, "train_block", unchanged_taps),
              Fault("half_the_modes", BLIND, "apply_filter", half_the_modes),
              Fault("left_undone", BLIND, "interp_rotate", left_undone),
              Fault("unwrap_skipped", BLIND, "decimated_derotation_inputs", unwrap_skipped),
              Fault("one_answer_altered", BLIND, "interp_rotate", one_answer_altered)],
    "pilot": [Fault("half_the_frames", PILOT, "apply_filter_frames", half_the_frames),
              Fault("left_undone", PILOT, "interp_rotate", left_undone),
              Fault("one_answer_altered", PILOT, "interp_rotate", one_answer_altered)],
}
