"""Bit-level helpers (counterpart of ``qampy_tpu/utils.py``)."""


def bin2gray(value):
    """Convert binary value(s) to gray code (reference core/utils.py:195-200)."""
    return value ^ (value >> 1)
