"""Pilot frame layout and Gray mapping (two pieces of ``qampy_tpu/signals.py``).

Host-side numpy, as in the reference: the pilot chain builds its static
geometry from :func:`cal_pilot_idx`, and the pilot workload maps indices to
symbols and bits with :func:`generate_mapping`. The signal classes
themselves are ROADMAP item A9.
"""
from __future__ import annotations

import numpy as np

from qampy_tpu_torch.theory import cal_symbols_qam, gray_code_qam


def cal_pilot_idx(frame_len, pilot_seq_len, pilot_ins_rat):
    """Frame layout (reference ``SignalWithPilots._cal_pilot_idx``, signals.py:1045-1057).

    A frame opens with ``pilot_seq_len`` pilot symbols; after it, every
    ``pilot_ins_rat``-th symbol is a phase pilot, starting with the first.
    Returns (idx, idx_dat, idx_pil): the symbol positions and the boolean
    payload and pilot masks.
    """
    idx = np.arange(frame_len)
    idx_pil_seq = idx < pilot_seq_len
    if pilot_ins_rat == 0 or pilot_ins_rat is None:
        idx_pil = idx_pil_seq
    else:
        if (frame_len - pilot_seq_len) % pilot_ins_rat != 0:
            raise ValueError("Frame without pilot sequence divided by pilot rate needs to be "
                             "an integer")
        idx_ph_pil = ((idx - pilot_seq_len) % pilot_ins_rat != 0) & (idx - pilot_seq_len > 0)
        idx_pil = ~idx_ph_pil
    idx_dat = ~idx_pil
    return idx, idx_dat, idx_pil


def generate_mapping(M, scale, dtype=np.complex64):
    """Gray-coded M-QAM mapping (reference ``SignalQAMGrayCoded._generate_mapping``, :479-493).

    Returns (coded_symbols, graycode, encoding): ``coded_symbols[i]`` is the
    symbol of coded index i, scaled by 1/``scale``, and ``encoding[i]`` its
    log2(M) bits, the binary of i with the most significant bit first.
    """
    Nbits = int(np.log2(M))
    symbols = cal_symbols_qam(M).astype(dtype)
    symbols /= scale
    graycode = gray_code_qam(M)
    u = np.zeros_like(graycode)
    u[graycode] = np.arange(u.size)
    coded_symbols = symbols[u]
    encoding = ((np.arange(graycode.size)[:, None] >> np.arange(Nbits - 1, -1, -1)) & 1
                ).astype(bool)
    return coded_symbols, graycode, encoding
