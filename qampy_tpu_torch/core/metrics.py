"""Symbol decisions (counterpart of ``qampy_tpu/core/metrics.py``, the part the gates use)."""
from __future__ import annotations

import torch


def decision_idx(E, symbols):
    """Index of the nearest constellation point for every sample (reference metrics.py:40).

    E: (..., N) complex; symbols: (M,) complex on E's device. The distance
    is |s|^2 - 2 Re(E conj(s)): |E|^2 does not change the argmin. Returns
    int32 (..., N); the first of equal distances wins.
    """
    Er = torch.stack([E.real, E.imag], dim=-1)                  # (..., N, 2)
    S = torch.stack([symbols.real, symbols.imag]).to(Er.dtype)  # (2, M)
    d = (S * S).sum(0) - 2 * (Er @ S)
    return torch.argmin(d, dim=-1).to(torch.int32)
