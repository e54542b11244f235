"""The blind two-stage receiver's cells: the program's ``RxChain`` in ``twostage`` mode.

Set-up, the entries, ``call`` and ``release`` are the blind receiver's
(``systems/blind.py``): the same captures, the same chain entry, the taps of
the tracking entry trained in set-up. What differs is the carrier recovery
after the filter, which ``work`` counts and ``check`` judges: the coarse search
(B3, over the coarse angles with half-window 60), the fine search around its
phase (B8), the pi/2 unwrap and derotation (B7), all at full rate.

``check`` judges the sampled dispatches as the blind cells do, against the
plain two-stage reference (``reference/blind_twostage.py``) run on the
reference's own taps.
"""
from __future__ import annotations

import torch

from benchmark.gen import seeds
from benchmark.lib import roofline, roofline_twostage
from benchmark.reference import blind as ref
from benchmark.reference import blind_twostage as ref2
from benchmark.reference import gates
from benchmark.systems import blind


class System(blind.System):
    def work(self):
        """Each stage's (bytes, ops) per dispatch, from the cell's shapes."""
        c = self.cfg["chain"]
        n = 2 * self.lout                       # filtered samples over both modes
        out = {"filter": roofline.fir(2 * self.nsym_capture, 2, 2, c["Ntaps"], self.lout),
               "search": roofline.search(n, ref2.coarse_angles(c["bps_angles"])),
               "fine": roofline_twostage.fine(n, ref2.B),
               "unwrap": roofline_twostage.unwrap(n)}
        if self.entry == "full":
            out["train"] = roofline.add(
                roofline.train(2, 2, c["Ntaps"], c["os"], c["TrSyms"], 1),
                roofline.train(2, 2, c["Ntaps"], c["os"], c["TrSyms"], 1,
                               roofline.OPS_DECIDE_SQUARE))
        return out

    def check(self, kept):
        """The numbers compared, each (name, value, limit, "max" or "min"): ``mismatch``,
        ``turns``, ``off`` and ``off_ser`` as the blind cells define them
        (``systems/blind.py``), with the two-stage reference's coarse and fine searches,
        unwrap and derotation in place of the decimated ones."""
        ref.no_tf32()
        lim = self.cfg["limits"]
        rcfg = ref2.reference_config(self.cfg["chain"], self.tx[0].const.cpu().numpy())
        n = ref.training_prefix(rcfg)
        worst = {"ser": 0.0, "mismatch": 0.0, "turns": 0, "taps_gap": 0.0, "widest_gap": 0.0,
                 "off_ser": 0.0}
        captures, judged, off = [], 0, 0
        for _, k, out in kept:
            t = self.tx[k]
            wp = (out[2] if self.entry == "full" else self.taps[k]).to(torch.complex128)
            inputs = [t.planes[:, :n], t.planes[:, :n].double()]
            for j in range(blind.ROUNDING_DRAWS):
                x = ref.rounding_step(t.planes, seeds.part(
                    self.seed, 1000 + blind.ROUNDING_DRAWS * k + j), n)
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
                (rr, ri), _ = ref2.demodulate(t.planes, rcfg, trainings[0].to(torch.complex64))
                worst["off_ser"] = max(worst["off_ser"], ser - gates.ser(rr, ri, t.idx, t.const))
                continue
            judged += 1
            (rr, ri), _ = ref2.demodulate(t.planes, rcfg, trainings[near].to(torch.complex64))
            share, turns, widest = gates.block_turn_gap(out[0], out[1], rr, ri,
                                                        blind.MISMATCH_TAU, blind.TURN_BLOCK)
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
