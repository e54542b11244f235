"""plain_ms: device ms a dispatch of work that no hand-written kernel does.

Every device operation (kernels, copies, fills) whose name is none of the
kernels of the port's ``csrc/`` library below: the blind glue, the CMA guard,
the pilot entry's concatenation of the capture and the payload gather.
"""
from benchmark.lib import trace

#: the __global__ functions of csrc/equaliser.cu, csrc/phase.cu and csrc/probe.cu
CSRC_KERNELS = ("train_block_kernel", "train_seq_kernel", "div_check_kernel",
                "apply_filter_kernel", "apply_filter_frames_kernel", "bps_kernel",
                "bps_kernel_bf16", "bps_fine_kernel", "bps_fine_kernel_bf16",
                "interp_rotate_kernel", "rotate_kernel", "cpe_coeffs_kernel", "unwrap_kernel",
                "latency_kernel", "empty_kernel", "copy_kernel", "argmin_kernel",
                "deinterleave_kernel")


def read(tr):
    return trace.per_dispatch_ms(tr, lambda name: not trace.name_matches(name, CSRC_KERNELS))
