"""Fixtures of the benchmark's CPU tests: the repository on the path, a copy at small sizes."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the cells' shapes cut to what the CPU's plain twins run in seconds: blind captures of 2^15
#: symbols (the training's 2^14 fit), pilot captures of 4 frames of 2^16 with 17 taps (a
#: batched LS solve of 45 taps stalls in this sandbox's MKL), two captures a pool
SMALL = {"blind_symbols": 2 ** 15, "pilot": {"frames": 4, "dispatch_frames": 2}, "pool": 2}


def small_copy(dest):
    """BENCHMARK.json and benchmark/ under ``dest``, with the traffic and the pilot taps cut."""
    dest = Path(dest)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("stream", "track"):
        f = dest / "benchmark" / "traffic" / ("%s.json" % name)
        t = json.loads(f.read_text())
        t["sizes"]["blind"]["symbols"] = SMALL["blind_symbols"]
        if "pilot" in t["sizes"]:
            t["sizes"]["pilot"] = dict(SMALL["pilot"])
        t["pool"] = SMALL["pool"]
        f.write_text(json.dumps(t))
    f = dest / "benchmark" / "configs" / "pilot64.json"
    c = json.loads(f.read_text())
    c["chain"]["Ntaps"] = 17
    f.write_text(json.dumps(c))
    return dest


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    import torch
    torch.set_num_threads(2)
    return small_copy(tmp_path_factory.mktemp("bench"))
