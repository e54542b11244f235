"""roofline.filter: percent of the filter stage's bound in its kernels' time.

The kernels: the filter B2 (csrc/equaliser.cu) and its frame entry. The bound is the
larger of the stage's bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s,
counted from the cell's shapes by ``benchmark/lib/roofline.py`` (the stage's own work,
each byte read or written once), whatever kernel later does that work.
"""
from benchmark.lib import trace

STAGE = "filter"
KERNELS = ("apply_filter_kernel", "apply_filter_frames_kernel")


def read(tr):
    return trace.roofline_share(tr, STAGE, KERNELS)
