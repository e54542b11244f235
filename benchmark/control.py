"""Readings of a cell's compared numbers: the program's sound runs, its control's, its faults'.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--faults]

For each seed, in one process: the cell's set-up and a short window at the
cell's own load, then the check of its sample, as ``run.py`` makes them; then
the control, put in the program's place at the same seed and judged by the
same check. The control is named by the configuration's ``control`` entry:
``chain`` rebuilds the program's chain with those settings (the program's own
lower-precision path), ``body_dtype`` has the reference's own frame body,
computed in that type, stand for the program's outputs. With ``--faults``, each
fault that ``benchmark/faults.py`` names for the cell's system is planted in
turn and read the same way. Prints one JSON line a seed with every set of
numbers. The limits in the configuration are set from these readings
(``PERF.md``); the benchmark's own runs never run the control or a fault.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fault_readings(cell, seed, seconds, device):
    """{fault's name: the numbers of ``cell`` at ``seed`` with that fault planted}."""
    from benchmark import faults
    out = {}
    for f in faults.FAULTS[cell.config["system"]]:
        with faults.planted(f):
            out[f.name] = readings(cell, seed, seconds, device, control=False)[0]
    return out


def readings(cell, seed, seconds, device, control=True):
    """(the program's numbers, the control's numbers or None) of ``cell`` at ``seed``."""
    import torch

    from benchmark.lib import harness, spec
    mod = spec.system(cell.config["system"], cell.bench)
    ctl = cell.config["control"]

    def window(**kw):
        sut = mod.System(cell.config, cell.traffic, seed, device, **kw)
        w = harness.window(cell, sut, seed, seconds, device)
        sut.release()
        gc.collect()
        return sut, w.kept

    def numbers(sut, kept):
        out = {n: v for n, v, _, _ in sut.check(kept)}
        out.update({k: v for k, v in sut.notes.items() if isinstance(v, (int, float, list))})
        return out

    sut, kept = window()
    prog = numbers(sut, kept)
    if not control:
        return prog, None
    if "chain" in ctl:
        del kept
        return prog, numbers(*window(chain=ctl["chain"]))
    dtype = getattr(torch, ctl["body_dtype"])
    kept = [(i, k, _planes(sut.reference(k, dtype)[0])) for i, k, _ in kept]
    return prog, numbers(sut, kept)


def _planes(z):
    return z.real.contiguous(), z.imag.contiguous()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", action="store_true", help="also read each planted fault")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import spec
    cell = spec.cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        prog, ctl = readings(cell, seed, args.seconds, args.device)
        line = {"workload": cell.name, "seed": seed, "program": prog, "control": ctl}
        if args.faults:
            line["faults"] = fault_readings(cell, seed, args.seconds, args.device)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
