"""BENCHMARK.json holds to the contract, and a cell, mix, metric or system is added as files."""
import json
import re
import time
from pathlib import Path

from benchmark.lib import harness, spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def read(root):
    raw = (Path(root) / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    return json.loads(raw)


def check_top_level(root):
    bench = read(root)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                  and not p.startswith("/")
                                                  for p in bench["paths"])
    cmd = bench["command"]
    assert len(cmd) <= 32 and all(one_line(w) and not w.startswith("/") and ".." not in w
                                  for w in cmd)
    assert (root / cmd[1]).is_file() and any(cmd[1].startswith(p + "/") for p in bench["paths"])
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def check_configs(root):
    bench = read(root)
    files = set()
    assert 1 <= len(bench["configs"]) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((root / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        # every key cut from the source is a key of the configuration as it is run
        assert all(NAME.match(k) and k in data for k in c["reduced"])
        assert (root / "benchmark" / "systems" / ("%s.py" % data["system"])).is_file()


def check_workloads(root):
    bench = read(root)
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    assert 1 <= len(bench["workloads"]) <= 24
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (root / "benchmark" / "traffic" / ("%s.json" % w["traffic"])).is_file()
    assert configs == {w["config"] for w in bench["workloads"]}
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)


def check_metrics(root):
    bench = read(root)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert len(e2e) == len(bench["end_to_end"]) and 1 <= len(e2e) <= 16
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    layer = {m["name"]: m for m in bench["per_layer"]}
    assert len(layer) == len(bench["per_layer"]) and 1 <= len(layer) <= 128
    assert not set(layer) & set(e2e)
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and one_line(m["layer"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # the metric moves an end-to-end metric that every cell it lists reports
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]].get("workloads", cells))
        spec.reader(m["name"], root / "benchmark")          # its reader is found by its name
    for cell in cells:
        c = spec.cell(root, cell, bench=root / "benchmark")
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
        assert {m["moves"] for m in c.per_layer} <= reported


CHECKS = [check_top_level, check_configs, check_workloads, check_metrics]


def test_top_level():
    check_top_level(ROOT)


def test_configs():
    check_configs(ROOT)


def test_workloads():
    check_workloads(ROOT)


def test_metrics():
    check_metrics(ROOT)


def _dummy(root):
    """A configuration, a mix, a system and a metric added as files, and their entries."""
    b = root / "benchmark"
    (b / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "system": "toy", "limits": {"err": 0.5}, "layers": 2,
         "reduced": ["layers"]}))
    (b / "traffic" / "burst.json").write_text(json.dumps(
        {"entry": "full", "pool": 3, "in_flight": 2, "sizes": {}}))
    (b / "systems" / "toy.py").write_text('''
import torch


class System:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.pool, self.depth, self.nsym = cfg, traffic["pool"], traffic["in_flight"], 8
        g = torch.Generator().manual_seed(seed)
        self.x = [torch.randn(8, generator=g) for _ in range(self.pool)]
        self.notes = {}

    def call(self, k):
        return (self.x[k] * 2,)

    def work(self):
        return {}

    def release(self):
        pass

    def check(self, kept):
        err = max(float((out[0] - 2 * self.x[k]).abs().max()) for _, k, out in kept)
        return [("err", err, self.cfg["limits"]["err"], "max")]
''')
    (b / "metrics" / "toy_count.py").write_text(
        'def read(tr):\n    return float(tr.dispatches)\n')
    bj = json.loads((root / "BENCHMARK.json").read_text())
    bj["configs"].append({"name": "toy", "source": "a test", "file": "benchmark/configs/toy.json",
                          "reduced": ["layers"], "why": "a test"})
    bj["workloads"].append({"name": "toy.burst", "config": "toy", "traffic": "burst", "chips": 1,
                            "why": "a test"})
    bj["end_to_end"].append({"name": "msym_s.toy", "unit": "Msym/s", "better": "higher",
                             "bound": 0.1, "source": "host_clock", "workloads": ["toy.burst"]})
    bj["per_layer"].append({"name": "toy_count", "unit": "1", "better": "higher",
                            "source": "program_counter", "layer": "toy", "moves": "msym_s.toy",
                            "workloads": ["toy.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bj))


def test_added_files_are_found_by_name(small_root):
    _dummy(small_root)
    for check in CHECKS:                    # the copy with the added cell holds to the contract
        check(small_root)
    cell = spec.cell(small_root, "toy.burst", bench=small_root / "benchmark")
    assert cell.traffic["pool"] == 3 and cell.config["system"] == "toy"
    assert [m["name"] for m in cell.per_layer] == ["toy_count"]
    res, compared = harness.measure(cell, 2 ** 31 + 11, 0.4, True, "cpu", time.perf_counter())
    assert res["correct"] and compared == [("err", 0.0, 0.5, "max")]
    assert res["metrics"]["toy_count"]["value"] >= 1
    res, _ = harness.measure(cell, 5, 0.2, False, "cpu", time.perf_counter())
    assert set(res["metrics"]) == {"msym_s.toy", "setup_s"}     # only the toy cell's own
    assert list(res)[-1] == "compared"
    # the cells already there read as before
    for w in read(ROOT)["workloads"]:
        assert spec.cell(small_root, w["name"], bench=small_root / "benchmark").chips == w["chips"]
