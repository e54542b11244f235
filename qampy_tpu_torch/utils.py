"""Bit-level helpers (counterpart of ``qampy_tpu/utils.py``) and the device rule of the port."""
import torch


def bin2gray(value):
    """Convert binary value(s) to gray code (reference core/utils.py:195-200)."""
    return value ^ (value >> 1)


def resolve_device(device):
    """The device an entry point runs on: the card unless the caller names another.

    ``None`` is ``torch.device("cuda")``; on a machine without a card the
    first tensor moved there raises, and nothing carries on on the CPU.
    """
    return torch.device("cuda" if device is None else device)
