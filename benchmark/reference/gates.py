"""The gates against the sent symbols, and the gaps between the program and the reference.

``ser`` is the blind benches' SER gate on a square grid (the port's
``workload.ser_gate``): after a 200-sample trim at both ends each output mode is
decided per axis on the constellation's levels under each quarter turn and
compared with every sent mode at delays 3-5; a symbol is wrong when its decision
lies more than d0/4 from the sent one; each mode keeps its best pairing and the
modes are averaged. ``ber`` is the pilot bench's BER gate (``workload.ber_gate``):
nearest-point decisions on the coded constellation, bit errors from the
Hamming distances of the coded indices' bits. Imports nothing of the program.
"""
from __future__ import annotations

import torch

TRIM = 200


def _levels(const):
    lv = torch.unique(torch.round(const.real.double() * 1e6) / 1e6)
    return float(lv[1] - lv[0]), float(lv[0]), int(lv.numel())


def ser(outr, outi, idx, const):
    """Symbol error rate of the outputs (nmodes, Lout) against the sent indices (nmodes, N)."""
    d0, lo, n = _levels(const)
    sent = const[idx.long()]
    o = torch.complex(outr, outi)[:, TRIM:-TRIM]
    L = o.shape[1]

    def q(x):
        return lo + d0 * torch.clamp(torch.round((x - lo) / d0), 0, n - 1)
    sers = []
    for m in range(o.shape[0]):
        best = None
        for rot in range(4):
            z = o[m] * (1j ** rot)
            dec = torch.complex(q(z.real), q(z.imag))
            for rm in range(sent.shape[0]):
                for off in (3, 4, 5):
                    r = sent[rm, TRIM + off: TRIM + off + L]
                    e = float(((dec - r).abs() > d0 / 4).double().mean())
                    best = e if best is None else min(best, e)
        sers.append(best)
    return sum(sers) / len(sers)


def decisions(z, coded, chunk=2 ** 20):
    """Index of the nearest point of ``coded`` (M,) for every element of the 1-D complex z."""
    out = []
    for zc in z.split(chunk):
        out.append(torch.argmin((zc[:, None] - coded[None, :]).abs(), dim=-1))
    return torch.cat(out)


def ber(payload, idx, coded, bits):
    """(BER, SER) of a payload (nmodes, frames * nd) against the sent indices (nmodes, nd)."""
    ham = (bits[:, None, :] != bits[None, :, :]).sum(-1)
    nmodes, nd = idx.shape
    bit_err = sym_err = 0
    for m in range(nmodes):
        rx = decisions(payload[m], coded).reshape(-1, nd)
        sent = idx[m].expand_as(rx)
        bit_err += int(ham[rx, sent].sum())
        sym_err += int((rx != sent).sum())
    nsym = payload.numel()
    return bit_err / (nsym * bits.shape[1]), sym_err / nsym


def block_turn_gap(pr, pi, rr, ri, tau, block):
    """(share, turns, widest): the share of samples whose gap to the reference exceeds
    ``tau``, the quarter-turn changes between adjacent blocks, and the widest gap.

    Each block of ``block`` samples of a mode is taken at the quarter turn that fits it best
    (the last block may be shorter): a blind receiver has no absolute phase, and where two
    sound ones resolve a tie of the phase search differently one of them slips by a quarter
    turn there, which moves every later sample of the row. Such a slip costs part of one
    block in the share; ``turns`` counts it, and every other change of the best turn from
    one block to the next, summed over the modes from turn 0 at each row's start. A broken
    pi/2 unwrap slips at every wrap of the phase and shows there.
    """
    p, r = torch.complex(pr, pi), torch.complex(rr, ri)
    bad = total = turns = 0
    widest = 0.0
    for m in range(p.shape[0]):
        prev = torch.zeros(1, dtype=torch.int64, device=p.device)
        for b0 in range(0, p.shape[1], block * 256):       # bounded memory: 256 blocks at a time
            pm = p[m, b0:b0 + block * 256]
            rm = r[m, b0:b0 + block * 256]
            n = pm.shape[0]
            pad = (-n) % block
            gaps = torch.stack([torch.nn.functional.pad((pm * (1j ** k) - rm).abs(), (0, pad))
                                for k in range(4)]).reshape(4, -1, block)
            count = (gaps > tau).sum(-1)                   # (4, blocks)
            best = count.argmin(0)
            bad += int(count.gather(0, best[None]).sum())
            turns += int((best != torch.cat([prev, best[:-1]])).sum())
            prev = best[-1:]
            widest = max(widest, float(gaps.gather(0, best[None, :, None].expand(1, -1, block))
                                       .max()))
            total += n
    return bad / total, turns, widest


def taps_gap(wp, wr):
    """The widest gap of two tap sets, relative to the reference's largest tap."""
    return float((wp - wr).abs().max() / wr.abs().max())
