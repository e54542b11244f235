"""The pilot receiver's cells: the program's ``PilotRxChain`` on captures made from the seed.

The pool is a receiver's links, each a transmitter with its own pilots and a
capture from it. Set-up acquires them: it makes a candidate link on the card,
builds a chain over the dispatch's frames for its pilots and runs one full
``planes`` dispatch, whose frame sync and training give the capture's taps,
shift and mode order and warm every kernel the tracking entry runs. A
candidate joins the pool when the program reports lock (its weakest pilot
correlation peak at least ``lock_corr``, the pilot bench's trust threshold);
QAMpy's frame sync misses some captures, in the reference as well, and a
receiver serving after lock acquires again. The window then cycles
``tracking_planes`` over the links with each one's state.

``check`` judges the sampled dispatches against the plain reference
(``reference/pilot.py``), which finds each capture's shift, mode order and taps
by its own frame sync and training, and runs the reference's frame sync on each
candidate the program turned down: the reference may not lock where the
program did not.
"""
from __future__ import annotations

import torch

from benchmark.gen import pilot_tx, seeds
from benchmark.lib import roofline
from benchmark.lib.harness import Phases
from benchmark.reference import gates
from benchmark.reference import pilot as ref
from benchmark.reference.blind import no_tf32

#: a symbol farther than this from the reference's (at unit power) counts as a mismatch
MISMATCH_TAU = 1e-3
#: candidates acquisition makes at most before it gives up (at a miss rate of 0.3, fewer
#: than four locks in sixteen comes once in ~3 x 10^4 runs)
MAX_CANDIDATES = 16


class Acquisition(RuntimeError):
    pass


class System:
    def __init__(self, cfg, traffic, seed, device):
        from qampy_tpu_torch.ops.pilot_chain import make_pilot_rx_chain
        self.cfg, self.device, self.seed = cfg, torch.device(device), seed
        sizes = traffic["sizes"]["pilot"]
        self.pool, self.depth = traffic["pool"], traffic["in_flight"]
        if traffic["entry"] != "tracking":
            raise ValueError("the pilot cells serve the tracking entry, got %r" % traffic["entry"])
        frame = cfg["frame"]
        clock = Phases(self.device)
        self.nframes = int(sizes["frames"])
        self.frames = list(range(int(sizes["dispatch_frames"])))
        self.tx, self.pilots, self.chains, self.state = [], [], [], []
        self.sync_corr, self.rejected = [], []
        for j in range(MAX_CANDIDATES):
            if len(self.tx) == self.pool:
                break
            pilots, t = self.candidate(j)
            chain = make_pilot_rx_chain(pilots.seq, pilots.phase, frame["frame_len"],
                                        frame["ins_rat"], M=cfg["M"], frames=self.frames,
                                        device=self.device, **cfg["chain"])
            _, info = chain.planes(t.planes[:2], t.planes[2:])
            corr = float(info["sync_corr"])
            if corr >= cfg["lock_corr"]:
                self.tx.append(t)
                self.pilots.append(pilots)
                self.chains.append(chain)
                self.state.append((info["taps"], info["shift"], info["mode_order"]))
                self.sync_corr.append(corr)
            else:
                self.rejected.append(j)
            del t, info, chain
        if len(self.tx) < self.pool:
            raise Acquisition("the program locked on %d of %d candidate links"
                              % (len(self.tx), MAX_CANDIDATES))
        clock("acquire")
        for k in range(self.pool):
            self.call(k)
        clock("warm")
        self.g = ref.geometry(cfg["chain"], frame["frame_len"], frame["seq_len"], frame["ins_rat"])
        self.nsym = 2 * len(self.frames) * int(self.tx[0].idx.shape[1])
        self.notes = dict(clock.notes, candidates_rejected=len(self.rejected))

    def candidate(self, j):
        """Candidate link j: (its transmitter's pilots, its capture), each from the seed."""
        pilots = pilot_tx.draw_pilots(seeds.part(self.seed, 2 * j), device=self.device,
                                      **self.cfg["frame"])
        return pilots, pilot_tx.make(pilots, self.nframes, seeds.part(self.seed, 2 * j + 1),
                                     M=self.cfg["M"], device=self.device, **self.cfg["frame"],
                                     **self.cfg["capture"])

    def call(self, k):
        t, (taps, shift, order) = self.tx[k], self.state[k]
        (dr, di), _ = self.chains[k].tracking_planes(t.planes[:2], t.planes[2:], taps, shift,
                                                     order)
        return dr, di

    def work(self):
        """Each stage's (bytes, ops) per dispatch, from the cell's shapes."""
        g, nf = self.g, len(self.frames)
        rows, nbt = g["n"] * nf, g["F"] // g["R"]
        return {
            "filter": roofline.fir(nf * g["F"] * g["os"] + g["ntaps"] - 1, g["n"], g["n"],
                                   g["ntaps"], nf * g["F"], nf * g["nph"]),
            "cpe": roofline.cpe(rows, g["nph"], g["n"] * g["nph"], nbt),
            "derotate": roofline.interp_rotate(rows * g["F"], rows * nbt)}

    def release(self):
        self.chains = None

    def reference(self, k, dtype=torch.float32):
        """The reference's (payload, taps, shift, mode order, sync_corr) of capture k."""
        P, pilots = self.tx[k].planes, self.pilots[k]
        taps, shift, order, corr = ref.prefix(P, self.cfg["chain"], pilots.seq, self.g)
        pay = ref.body(P, taps, shift, order, pilots.phase, self.frames, self.g, dtype)
        return pay, taps, shift, order, corr

    def check(self, kept):
        """The numbers compared, each (name, value, limit, "max" or "min"); the taps' gap and
        the share of symbols off by more than MISMATCH_TAU go to ``notes``."""
        no_tf32()
        lim = self.cfg["limits"]
        worst = {"ber": 0.0, "sync_mismatch": 0, "gap": 0.0, "taps_gap": 0.0, "mismatch": 0.0}
        ref_corr = []
        for _, k, (dr, di) in kept:
            pay, taps, shift, order, corr = self.reference(k)
            ptaps, pshift, porder = self.state[k]
            same = (list(map(int, pshift.tolist())) == list(shift)
                    and list(map(int, porder.tolist())) == list(order))
            worst["sync_mismatch"] += 0 if same else 1
            if same:
                worst["taps_gap"] = max(worst["taps_gap"], gates.taps_gap(ptaps, taps))
            ref_corr.append(corr)
            gap = (torch.complex(dr, di) - pay).abs()
            worst["gap"] = max(worst["gap"], float(gap.max()))
            worst["mismatch"] = max(worst["mismatch"], float((gap > MISMATCH_TAU).double().mean()))
            t = self.tx[k]
            worst["ber"] = max(worst["ber"], gates.ber(torch.complex(dr, di), t.idx, t.coded,
                                                       t.bits)[0])
        # a candidate the program turned down: the reference may not lock on it either
        locked_by_reference = 0
        for j in self.rejected:
            pilots, t = self.candidate(j)
            _, _, corr = ref.frame_sync(t.planes, self.cfg["chain"], pilots.seq, self.g)
            locked_by_reference += corr >= self.cfg["lock_corr"]
            del t
        self.notes.update(reference_sync_corr=ref_corr, taps_gap=worst["taps_gap"],
                          mismatch=worst["mismatch"], program_sync_corr=self.sync_corr)
        return [("ber", worst["ber"], lim["ber"], "max"),
                ("sync_mismatch", worst["sync_mismatch"], lim["sync_mismatch"], "max"),
                ("lock_disagree", locked_by_reference, lim["lock_disagree"], "max"),
                ("gap", worst["gap"], lim["gap"], "max")]
