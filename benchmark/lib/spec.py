"""The benchmark's files, found by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. The configuration is the JSON
file that ``BENCHMARK.json`` gives it; its ``system`` key names the module under
``systems/`` that builds and drives it. A traffic mix ``t`` is ``traffic/t.json``;
a per-layer metric ``m`` is read by ``metrics/m.py``, or, where a quantity is split by the
cells it is held for (``host_ms.stream``, ``host_ms.track``), by the reader of the quantity
(``metrics/host_ms.py``), found by dropping the name's last parts one at a time. A later
cell, mix, metric or system is added as a file of its own: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parents[1]


class Cell(NamedTuple):
    bench: Path             # the benchmark's folder, where its files are found
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # the end-to-end metrics this cell reports
    per_layer: list         # the per-layer metrics this cell reports


def load(root):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric, cell, e2e_names):
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(root, name, bench=BENCH):
    """The :class:`Cell` named ``name`` from the ``BENCHMARK.json`` under ``root``."""
    root = Path(root)
    spec = load(root)
    try:
        w = next(w for w in spec["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError("no workload %r in BENCHMARK.json" % name) from None
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads((bench / "traffic" / ("%s.json" % w["traffic"])).read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(Path(bench), name, int(w["chips"]), config, traffic, e2e, per_layer)


def _module(path, name):
    if not path.exists():
        raise FileNotFoundError("the benchmark has no %s" % path)
    sp = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def system(kind, bench=BENCH):
    """The module ``systems/<kind>.py`` that builds and drives a configuration of that kind."""
    return _module(bench / "systems" / ("%s.py" % kind), "bench_system_%s" % kind)


def reader(metric, bench=BENCH):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else that of the name
    with its last part dropped (``roofline.filter.track`` -> ``metrics/roofline.filter.py``),
    and so on. Its ``read(trace)`` gives the value or None."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        name = ".".join(parts[:n])
        path = bench / "metrics" / ("%s.py" % name)
        if path.exists():
            return _module(path, "bench_metric_%s" % name.replace(".", "_"))
    raise FileNotFoundError("the benchmark has no reader of %s under %s"
                            % (metric, bench / "metrics"))
