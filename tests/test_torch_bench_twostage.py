"""The two-stage blind chain against the benchmark's plain two-stage reference, on the CPU.

``make_rx_chain(bps_mode="twostage", device="cpu")`` (the kernels' plain twins)
beside ``benchmark/reference/blind_twostage.py`` on one capture of the
benchmark's own generator that trains (2^15 symbols a mode, 2^14 training
symbols), both on the reference's taps: the outputs agree as the benchmark's
check judges them (``mismatch`` within the configuration's limit, no quarter-turn
slip), and on the program's filtered planes the coarse and the fine indices are
the reference's but at near-ties (the window sums in another order).
"""
import json
from pathlib import Path

import pytest
import torch

from benchmark.gen import blind_tx
from benchmark.reference import blind as ref
from benchmark.reference import blind_twostage as ref2
from benchmark.reference import gates
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.chain import TWOSTAGE_B, TWOSTAGE_N1, make_rx_chain

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "blind64-twostage.json").read_text())
#: a capture of seed 3 locks at this size (the benchmark's CPU tests take the same seed)
NSYM, SEED = 2 ** 15, 3
TIE_REL = 1e-5


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(2)
    c = CONFIG["chain"]
    tx = blind_tx.make(NSYM, SEED, M=c["M"], device="cpu", **CONFIG["capture"])
    rcfg = ref2.reference_config(c, tx.const.numpy())
    w = ref.blind_taps(tx.planes[:, :ref.training_prefix(rcfg)], rcfg)
    chain = make_rx_chain(device="cpu", **dict(c, methods=tuple(c["methods"])))
    return tx, rcfg, w, chain


def test_the_configuration_is_the_chains_two_stage_search(run):
    _, rcfg, _, chain = run
    assert chain.mode == "twostage" and chain.bps_win == "f32"
    assert (rcfg["coarse_angles"], rcfg["N1"], ref2.B) == (chain.A, TWOSTAGE_N1, TWOSTAGE_B)
    assert chain.search_N == TWOSTAGE_N1 and chain.bps_N == rcfg["bps_N"]


def test_the_outputs_agree_with_the_reference_on_its_taps(run):
    tx, rcfg, w, chain = run
    outr, outi = chain.tracking_planes(tx.planes, w)
    (rr, ri), _ = ref2.demodulate(tx.planes, rcfg, w)
    share, turns, _ = gates.block_turn_gap(outr, outi, rr, ri, 1e-3, 256)
    assert share <= CONFIG["limits"]["mismatch"] and turns == 0, (share, turns)
    assert gates.ser(outr, outi, tx.idx, tx.const) == 0.0     # the capture locks


def test_the_coarse_and_fine_indices_are_the_references_off_near_ties(run):
    tx, rcfg, w, chain = run
    eqp, _ = chain.equalise(tx.planes, w)
    no = eqp.shape[0] // 2
    idx1 = chain.phase_search(eqp)
    ph1 = chain.lo_a + chain.step_a * idx1.to(torch.float32)
    grid = chain.search_grid
    dist = phops.bps_fine_distances(eqp[:no], eqp[no:], ph1, chain.fine_cos, chain.fine_sin,
                                    grid)
    idx2 = phops.select_angle_index(dist, chain.bps_N)
    g, A1 = ref.grid(rcfg["const"]), rcfg["coarse_angles"]
    ties1 = phops.bps_near_ties(eqp[:no], eqp[no:], chain.bps_cos, chain.bps_sin, grid,
                                TWOSTAGE_N1, TIE_REL)
    ties2 = phops.bps_fine_near_ties(eqp[:no], eqp[no:], ph1, chain.fine_cos, chain.fine_sin,
                                     grid, chain.bps_N, TIE_REL)
    differ1 = differ2 = 0
    for m in range(no):
        r1 = ref2.coarse(eqp[m], eqp[no + m], g, A1, TWOSTAGE_N1)
        r2, _ = ref2.fine(eqp[m], eqp[no + m], ph1[m], g, A1, chain.bps_N)
        d1, d2 = r1 != idx1[m], r2 != idx2[m]
        assert not (d1 & ~ties1[m]).any() and not (d2 & ~ties2[m]).any()
        differ1, differ2 = differ1 + int(d1.sum()), differ2 + int(d2.sum())
    # on this capture 1 coarse and 1 fine position of the 65,520 is near-tied; none differed
    # where this was written, another CPU's summation order may flip those two
    assert (int(ties1.sum()), int(ties2.sum())) == (1, 1)
    assert differ1 <= 1 and differ2 <= 1
