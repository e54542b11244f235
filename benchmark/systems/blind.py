"""The blind receiver's cells: the program's ``RxChain`` on captures made from the seed.

Set-up makes the pool of captures on the card, builds the chain, trains the
taps of the tracking entry (``planes_with_taps`` on each capture) and runs
every capture through the timed entry once, so that every kernel is built and
every shape warmed before the window. The entries:

- ``full``: ``planes_with_taps``, the whole receiver (``planes`` with the taps
  it trained returned beside its output, so that they can be judged);
- ``tracking``: ``tracking_planes`` with the capture's set-up taps.

``check`` judges the sampled dispatches against the plain reference
(``reference/blind.py``), which trains its own taps on each capture and runs its
filter, search, glue and derotation on them.
"""
from __future__ import annotations

import math

import torch

from benchmark.gen import blind_tx, seeds
from benchmark.lib import roofline
from benchmark.lib.harness import Phases
from benchmark.reference import blind as ref
from benchmark.reference import gates

#: a symbol whose recovered value lies farther than this from the reference's (at unit power)
#: counts as a mismatch: float32 rounding moves an output by ~1e-6, a phase search that picks
#: the next angle (pi/128 away) by ~2.5e-2
MISMATCH_TAU = 1e-3
#: the symbols a mode of the output is aligned with the reference in, each at its best quarter
#: turn: a slip at a tie of the phase search moves the rest of the row by a quarter turn
TURN_BLOCK = 256
#: copies of a capture's training prefix moved by one float32 rounding step, each trained by the
#: reference in float64 and in float32 beside its trainings on the capture itself
ROUNDING_DRAWS = 8


class System:
    def __init__(self, cfg, traffic, seed, device, chain=None):
        from qampy_tpu_torch.ops.chain import make_rx_chain
        self.cfg, self.device, self.seed = cfg, torch.device(device), seed
        sizes = traffic["sizes"]["blind"]
        self.pool, self.depth, self.entry = traffic["pool"], traffic["in_flight"], traffic["entry"]
        kw = dict(cfg["chain"], **(chain or {}))
        kw["methods"] = tuple(kw["methods"])
        if self.entry not in ("full", "tracking"):
            raise ValueError("the blind entries are 'full' and 'tracking', got %r" % self.entry)
        clock = Phases(self.device)
        self.nsym_capture = int(sizes["symbols"])
        self.tx = [blind_tx.make(self.nsym_capture, seeds.part(seed, k), M=kw["M"],
                                 device=self.device, **cfg["capture"])
                   for k in range(self.pool)]
        clock("captures")
        self.chain = make_rx_chain(device=self.device, **kw)
        self.taps = None
        if self.entry == "tracking":
            self.taps = [self.chain.planes_with_taps(t.planes)[1] for t in self.tx]
        clock("chain")
        for k in range(self.pool):
            self.call(k)
        clock("warm")
        self.lout = (2 * self.nsym_capture - kw["Ntaps"]) // kw["os"] + 1
        self.nsym = 2 * self.lout
        self.notes = clock.notes

    def call(self, k):
        P = self.tx[k].planes
        if self.entry == "full":
            (outr, outi), w = self.chain.planes_with_taps(P)
            return outr, outi, w
        return self.chain.tracking_planes(P, self.taps[k])

    def work(self):
        """Each stage's (bytes, ops) per dispatch, from the cell's shapes."""
        c = self.cfg["chain"]
        dec = int(c["bps_mode"][len("decimated"):] or 8)
        ld = math.ceil(self.lout / dec)
        out = {
            "filter": roofline.fir(2 * self.nsym_capture, 2, 2, c["Ntaps"], self.lout, ld),
            "search": roofline.search(2 * ld, c["bps_angles"]),
            "derotate": roofline.interp_rotate(2 * ld * dec, 2 * ld)}
        if self.entry == "full":
            out["train"] = roofline.add(
                roofline.train(2, 2, c["Ntaps"], c["os"], c["TrSyms"], 1),
                roofline.train(2, 2, c["Ntaps"], c["os"], c["TrSyms"], 1,
                               roofline.OPS_DECIDE_SQUARE))
        return out

    def release(self):
        """Drop the program's state; the captures and the set-up taps stay for the check."""
        self.chain = None

    def check(self, kept):
        """The numbers compared, each (name, value, limit, "max" or "min").

        Per sampled capture the reference trains its own taps on the capture, in float32 and
        in float64, and on ROUNDING_DRAWS copies of the capture moved by one float32 rounding
        step, in float64 and in float32 each: where the training's outcome hangs on rounding,
        these land apart, and the program's float32 training may land on any of them. The
        program's taps are matched to the nearest of these trainings (the widest gap over
        the largest tap). Where that gap is within the ``taps_gap`` limit, the capture is
        judged on the reference's filter, search, glue and derotation (in float32) run on
        the taps of that training:

        ``mismatch``: the share of output symbols farther than MISMATCH_TAU from the
        reference's, each block of TURN_BLOCK symbols at its best quarter turn, the worst
        judged capture's; ``turns``: the changes of that best quarter turn from block to
        block, the worst judged capture's.

        A capture whose taps leave every reference training by more is ``off``; ``off``
        counts them, and ``off_ser`` is the most by which such a capture's SER against the
        sent symbols exceeds that of the reference's output on its own float32 taps. With
        no capture judged, ``mismatch`` reads 1. ``notes["captures"]`` lists each capture as
        [capture, the widest gap of a reference training from the float64 one, the
        program's gap to the nearest, the index of that training]; the widest program gap
        of the judged captures, the widest output gap and the SER go to ``notes`` too.
        """
        ref.no_tf32()
        lim = self.cfg["limits"]
        rcfg = ref.reference_config(self.cfg["chain"], self.tx[0].const.cpu().numpy())
        n = ref.training_prefix(rcfg)
        worst = {"ser": 0.0, "mismatch": 0.0, "turns": 0, "taps_gap": 0.0, "widest_gap": 0.0,
                 "off_ser": 0.0}
        captures, judged, off = [], 0, 0
        for _, k, out in kept:
            t = self.tx[k]
            wp = (out[2] if self.entry == "full" else self.taps[k]).to(torch.complex128)
            inputs = [t.planes[:, :n], t.planes[:, :n].double()]
            for j in range(ROUNDING_DRAWS):
                draw = seeds.part(self.seed, 1000 + ROUNDING_DRAWS * k + j)
                x = ref.rounding_step(t.planes, draw, n)
                inputs += [x, x.float()]
            trainings = [ref.blind_taps(x, rcfg).to(torch.complex128) for x in inputs]
            gaps = [gates.taps_gap(wp, w) for w in trainings]
            near = min(range(len(gaps)), key=gaps.__getitem__)
            spread = max(gates.taps_gap(w, trainings[1]) for w in trainings)
            captures.append([k, spread, gaps[near], near])
            ser = gates.ser(out[0], out[1], t.idx, t.const)
            worst["ser"] = max(worst["ser"], ser)
            if gaps[near] > lim["taps_gap"]:
                off += 1
                (rr, ri), _ = ref.demodulate(t.planes, rcfg, trainings[0].to(torch.complex64))
                worst["off_ser"] = max(worst["off_ser"], ser - gates.ser(rr, ri, t.idx, t.const))
                continue
            judged += 1
            (rr, ri), _ = ref.demodulate(t.planes, rcfg, trainings[near].to(torch.complex64))
            share, turns, widest = gates.block_turn_gap(out[0], out[1], rr, ri, MISMATCH_TAU,
                                                        TURN_BLOCK)
            del rr, ri
            for key, v in (("mismatch", share), ("turns", turns), ("taps_gap", gaps[near]),
                           ("widest_gap", widest)):
                worst[key] = max(worst[key], v)
        if not judged:
            worst["mismatch"] = 1.0
        self.notes.update(ser=worst["ser"], widest_gap=worst["widest_gap"], captures=captures,
                          taps_gap=worst["taps_gap"])
        return [("mismatch", worst["mismatch"], lim["mismatch"], "max"),
                ("turns", worst["turns"], lim["turns"], "max"),
                ("off", off, lim["off"], "max"),
                ("off_ser", worst["off_ser"], lim["off_ser"], "max")]
