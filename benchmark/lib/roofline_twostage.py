"""Operations and bytes of the two-stage receiver's fine search and its unwrap-derotation.

The counts that ``lib/roofline.py`` lacks, frozen in the same way from the
port's ``chip_smoke.py`` (its ``b8_record``: ``bps_ops(..., fine=True)`` and
the rotation of each sample by its coarse phase; its ``b7_record``: 20 bytes
a sample); the coarse search is ``roofline.search`` at the coarse angles.
Each input byte is counted as read once and each output byte as written once;
the operations are those the algorithm needs, in float32.
"""
from __future__ import annotations

from benchmark.lib.roofline import F32, OPS_BPS_SEARCH, OPS_DECIDE_SQUARE, OPS_ROTATE

OPS_FINE_ANGLE = 6       # per sample and offset: ph1 + offset by angle addition
OPS_UNWRAP = 6           # difference, quarter-turn count, prefix sum


def fine(samples, offsets):
    """(bytes, ops) of the fine search on a square grid over ``samples`` (all modes): the
    planes and the coarse phase in, the phase out; sin and cos of each coarse phase, then per
    offset the angle, the rotation, the decision and the running window."""
    ops = ((OPS_BPS_SEARCH + OPS_DECIDE_SQUARE + OPS_FINE_ANGLE) * offsets + OPS_ROTATE) * samples
    return F32 * 4 * samples, ops


def unwrap(samples):
    """(bytes, ops) of the pi/2 unwrap and derotation: planes and phase in, planes out."""
    return F32 * 5 * samples, (OPS_UNWRAP + OPS_ROTATE) * samples
