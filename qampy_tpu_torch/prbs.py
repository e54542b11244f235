"""Pseudo-random bit sequences from LFSRs (counterpart of ``qampy_tpu/prbs.py``), host numpy.

The Fibonacci (external-XOR) LFSR's output obeys out[n] = XOR_t out[n-t],
so after its first ``order`` bits it is generated in chunks of the smallest
tap distance (prbs.py:37-71). The Galois (internal-XOR) form carries its
whole register from bit to bit and runs as a Python loop; the reference's
optional C helper (``qampy_tpu/native``) is not used.
"""
from __future__ import annotations

import numpy as np

from qampy_tpu_torch.utils import bool2bin

#: taps of the external-XOR LFSR per order (prbs.py:18)
_TAPDICT = {7: (7, 6), 15: (15, 14), 23: (23, 18), 31: (31, 28)}
#: masks of the internal-XOR LFSR per order (prbs.py:20-25)
_MASKS = {
    7: 2 ** 7 + 2 ** 6 + 1,
    15: 2 ** 15 + 2 ** 14 + 1,
    23: 2 ** 23 + 2 ** 18 + 1,
    31: 2 ** 31 + 2 ** 28 + 1,
}


def _seed_to_int(seed, order):
    if seed is None:
        return bool2bin(np.ones(order))
    try:
        return bool2bin(seed)
    except TypeError:
        return int(seed)


def prbs_ext(seed, taps, nbits, N):
    """External-XOR (Fibonacci) LFSR bit stream of N bits as uint8 (prbs.py:37-71).

    Each step's output bit is the XOR of register bits ``nbits - t``, and
    the register shifts right with that bit entering at the top.
    """
    taps = tuple(int(t) for t in taps)
    out = np.zeros(max(N, nbits), dtype=np.uint8)
    sr = int(seed)
    for i in range(min(N, nbits)):
        xor = 0
        for t in taps:
            if (sr & (1 << (nbits - t))) != 0:
                xor ^= 1
        sr = (xor << (nbits - 1)) + (sr >> 1)
        out[i] = xor
    chunk = min(taps)
    i = nbits
    while i < N:
        m = min(chunk, N - i)
        acc = out[i - taps[0]:i - taps[0] + m].copy()
        for t in taps[1:]:
            acc ^= out[i - t:i - t + m]
        out[i:i + m] = acc
        i += m
    return out[:N]


def prbs_int(seed, mask, nbits, N):
    """Internal-XOR (Galois) LFSR bit stream of N bits as uint8 (prbs.py:74-95)."""
    out = np.zeros(N, dtype=np.uint8)
    state = int(seed)
    for i in range(N):
        state = state << 1
        xor = state >> nbits
        if xor != 0:
            state ^= mask
        out[i] = xor
    return out


def make_prbs_extXOR(order, nbits, seed=None):
    """PRBS of the given order from a Fibonacci LFSR (prbs.py:98-103)."""
    if order not in _TAPDICT:
        raise ValueError("Only orders 7, 15, 23, 31 are implemented")
    return prbs_ext(_seed_to_int(seed, order), _TAPDICT[order], order, int(nbits)).astype(bool)


def make_prbs_intXOR(order, nbits, seed=None):
    """PRBS of the given order from a Galois LFSR (prbs.py:106-110)."""
    if order not in _MASKS:
        raise ValueError("Only orders 7, 15, 23, 31 are implemented")
    return prbs_int(_seed_to_int(seed, order), _MASKS[order], order, int(nbits)).astype(bool)
