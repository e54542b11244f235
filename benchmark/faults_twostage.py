"""Faults planted in the two-stage receiver's timed path, and their readings at a cell's size.

    python3 benchmark/faults_twostage.py --workload blind64-twostage.track --seeds 1,2 [--seconds 2]

Each fault replaces one function of the program where its chain module looks it
up, as ``benchmark/faults.py`` does for the decimated receiver:

- ``unchanged_taps``: the trainer returns its taps as it got them;
- ``half_the_modes``: the filter leaves half of its modes out;
- ``left_undone``: the unwrap-derotation returns its input;
- ``unwrap_skipped``: the planes are rotated by the fine phase without its pi/2 unwrap;
- ``fine_skipped``: the fine search returns the coarse phase plus its first offset;
- ``one_answer_altered``: one output symbol in 256 of the first mode is moved by about a
  level spacing, where the unwrap-derotation produces it.

For each seed, each fault is planted in turn over the cell's set-up, a short
window and the check (``control.readings``); one JSON line a seed holds every
fault's numbers. ``benchmark/tests/test_bench_twostage.py`` reads them on the
CPU at small sizes. The benchmark's own runs never plant a fault.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control, faults  # noqa: E402
from benchmark.faults import BLIND, Fault  # noqa: E402


def left_undone(orig):
    def unwrap_derotate(er, ei, ph):
        return er.clone(), ei.clone()
    return unwrap_derotate


def unwrap_skipped(orig):
    import torch

    def unwrap_derotate(er, ei, ph):
        c, s = torch.cos(ph), torch.sin(ph)
        return er * c - ei * s, er * s + ei * c
    return unwrap_derotate


def fine_skipped(orig):
    def bps_fine(er, ei, ph1, cd, sd, grid, N, d0f, ddf, points=None, bf16_tile=None):
        return ph1 + d0f
    return bps_fine


def one_answer_altered(orig):
    def unwrap_derotate(er, ei, ph):
        outr, outi = orig(er, ei, ph)
        n = max(1, int(outr.shape[-1] * faults.ALTERED_SHARE))
        outr[0, 1000:1000 + n] += 0.3          # about a level spacing at unit power
        return outr, outi
    return unwrap_derotate


FAULTS = [Fault("unchanged_taps", BLIND, "train_block", faults.unchanged_taps),
          Fault("half_the_modes", BLIND, "apply_filter", faults.half_the_modes),
          Fault("left_undone", BLIND, "unwrap_derotate", left_undone),
          Fault("unwrap_skipped", BLIND, "unwrap_derotate", unwrap_skipped),
          Fault("fine_skipped", BLIND, "bps_fine", fine_skipped),
          Fault("one_answer_altered", BLIND, "unwrap_derotate", one_answer_altered)]


def fault_readings(cell, seed, seconds, device):
    """{fault's name: the numbers of ``cell`` at ``seed`` with that fault planted}."""
    out = {}
    for f in FAULTS:
        with faults.planted(f):
            out[f.name] = control.readings(cell, seed, seconds, device, control=False)[0]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark.lib import spec
    cell = spec.cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = {"workload": cell.name, "seed": seed,
                "faults": fault_readings(cell, seed, args.seconds, args.device)}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
