"""roofline.search: percent of the search stage's bound in its kernels' time.

The kernels: the blind phase search B3 (csrc/phase.cu), with float32 or bf16 windows.
The bound is the larger of the stage's bytes over 3.35 TB/s and its float32 operations
over 67 TFLOP/s, counted from the cell's shapes by ``benchmark/lib/roofline.py`` (the
stage's own work, each byte read or written once), whatever kernel later does that work.
"""
from benchmark.lib import trace

STAGE = "search"
KERNELS = ("bps_kernel", "bps_kernel_bf16")


def read(tr):
    return trace.roofline_share(tr, STAGE, KERNELS)
