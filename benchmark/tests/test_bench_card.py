"""On the card: each cell runs end to end and its result line holds to the contract.

Skips without a CUDA card (decided inside the test). Run on the card with
``python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py -q``.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from benchmark.lib import spec  # noqa: E402

CELLS = [w["name"] for w in spec.load(ROOT)["workloads"] if w["chips"] == 1]


def needs_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_cell(cell, trace):
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 77), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stderr.strip().splitlines()[-1].startswith("compared ")
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell, trace):
    needs_card()
    out = run_cell(cell, trace)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "compared"
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    c = spec.cell(ROOT, cell)
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        # every per-layer metric of the cell finds something to read there
        assert set(out["metrics"]) == {m["name"] for m in c.per_layer}
        assert all(m["value"] <= 105 for n, m in out["metrics"].items()
                   if n.startswith("roofline."))
        assert len(out["breakdown"]["device_ops"]) <= 10
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
