"""roofline.fine: percent of the fine stage's bound in its kernels' time.

The kernels: the two-stage search's fine stage B8 (csrc/phase.cu), with float32 or bf16
windows. The bound is the larger of the stage's bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s, counted from the cell's shapes by
``benchmark/lib/roofline_twostage.py`` (the stage's own work, each byte read or written
once), whatever kernel later does that work.
"""
from benchmark.lib import trace

STAGE = "fine"
KERNELS = ("bps_fine_kernel", "bps_fine_kernel_bf16")


def read(tr):
    return trace.roofline_share(tr, STAGE, KERNELS)
