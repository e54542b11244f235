"""Run one cell of the benchmark of ``qampy_tpu_torch`` and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up makes the cell's captures on the card from the seed, builds the
program's chain and warms every shape the window uses; the window drives the
entry for ``--seconds`` with two dispatches in flight; then the program's
state is freed and a sample of the window's outputs is judged against the
plain reference under ``benchmark/reference``. The last line of standard
output is the result as one JSON object; the last lines of standard error are
the numbers compared, each beside its limit. With ``--trace 1`` a span of the
window runs under ``torch.profiler`` and the result carries the per-layer
metrics, the device's busy and traced seconds and the breakdown.

Exits 2, printing no result, without a card (or with fewer than the cell's),
without the program, or when JAX or the JAX package is loaded once the window
has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_line():
    """The card's name and power limit, as nvidia-smi reads them ("" where it cannot)."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import harness, spec
    cell = spec.cell(ROOT, args.workload)
    try:
        import qampy_tpu_torch  # noqa: F401
    except ImportError as e:
        print("benchmark: the program qampy_tpu_torch is not here: %s" % e, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("benchmark: the cell %s needs %d CUDA card(s); found %d"
              % (cell.name, cell.chips, torch.cuda.device_count() if torch.cuda.is_available()
                 else 0), file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    try:
        result, compared = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                                           "cuda", T0)
    except harness.Forbidden as e:
        print("benchmark: %s" % e, file=sys.stderr)
        return 2
    card = card_line()
    result["card"] = card
    result["compared"] = result.pop("compared")          # the numbers compared come last
    print("card: %s" % card, file=sys.stderr)
    for name, value, limit, sense in compared:
        print("compared %s %r %s %r" % (name, value, "<=" if sense == "max" else ">=", limit),
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
