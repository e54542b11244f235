"""roofline.derotate: percent of the derotate stage's bound in its kernels' time.

The kernels: interp-rotate B4 (csrc/phase.cu). The bound is the larger of the stage's
bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s, counted from the cell's
shapes by ``benchmark/lib/roofline.py`` (the stage's own work, each byte read or written
once), whatever kernel later does that work.
"""
from benchmark.lib import trace

STAGE = "derotate"
KERNELS = ("interp_rotate_kernel",)


def read(tr):
    return trace.roofline_share(tr, STAGE, KERNELS)
