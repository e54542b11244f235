"""Filters (counterpart of ``qampy_tpu/core/filter.py``): so far the moving average.

The rest of the reference module (pulse shaping, IIR filters, resampling
filters) is ROADMAP item A9.
"""
from __future__ import annotations

import torch

from qampy_tpu_torch.ops.phase_cuda import moving_average as _window_mean

__all__ = ["moving_average"]


def moving_average(sig, N=3):
    """Moving average of length N over the valid region (reference core/filter.py:323-336).

    out[..., l] = (sig[..., l] + ... + sig[..., l+N-1]) / N for l = 0, ...,
    len - N, on a real tensor of any leading shape. Summed directly, last
    term first, as the port's pilot CPE sums it (``phase_cuda.moving_average``):
    the reference forms the same average as a difference of cumulative sums,
    whose float32 rounding grows with the length of the row.
    """
    sig = torch.as_tensor(sig)
    N = int(N)
    if N < 1 or N > sig.shape[-1]:
        raise ValueError("moving average of %d over %d samples" % (N, sig.shape[-1]))
    return _window_mean(sig, N, sig.shape[-1] - N + 1)
