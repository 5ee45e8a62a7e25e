"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name, a new cell's too."""

import json
import os
import re
import shutil

import pytest

from benchmark.manifest import Bench
from benchmark.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture
def data():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(data):
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= data["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (data["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in data["configs"]] + [w["name"] for w in data["workloads"]]
    names += [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names))
    for w in data["workloads"]:
        names += [w["config"], w["traffic"]]
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n


def test_metrics(data):
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"]: m for m in data["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in data["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", ()):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_enough():
    bench = Bench()
    for w in bench.data["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer(w["name"])


def test_every_named_file_is_found():
    bench = Bench()
    for w in bench.data["workloads"]:
        cfg = bench.config(w["config"])
        mix = bench.traffic(w["traffic"])
        bench.kind(mix["kind"])
        lim = bench.limits(w["name"])
        assert cfg["name"] == w["config"] and lim
        for m in bench.end_to_end(w["name"]) + bench.per_layer(w["name"]):
            assert callable(bench.reader(m["name"]))


def test_new_cell_is_picked_up(tmp_path):
    """A later change adds a cell as files and entries; no file is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark")
    data = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    data["workloads"].append({"name": "multi.greedy.b64", "config": "cxrmate-multi",
                              "traffic": "greedy.b64", "chips": 1, "why": "a new cell"})
    data["per_layer"].append({"name": "new_metric.serve", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "decode loop",
                              "moves": "report_studies_per_s.greedy",
                              "workloads": ["multi.greedy.b64"]})
    data["end_to_end"][1]["workloads"].append("multi.greedy.b64")
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    mix = json.load(open(os.path.join(REPO, "benchmark", "traffic", "greedy.b512.json")))
    mix["studies_per_batch"] = 64
    (root / "benchmark" / "traffic" / "greedy.b64.json").write_text(json.dumps(mix))
    (root / "benchmark" / "limits" / "multi.greedy.b64.json").write_text('{"token_gap": 1}')
    (root / "benchmark" / "metrics" / "new_metric.serve.py").write_text(
        "def read(r):\n    return 1.5\n")
    bench = Bench(str(root))
    assert bench.traffic("greedy.b64")["studies_per_batch"] == 64
    assert bench.limits("multi.greedy.b64") == {"token_gap": 1}
    names = [m["name"] for m in bench.per_layer("multi.greedy.b64")]
    assert "new_metric.serve" in names
    assert bench.reader("new_metric.serve")({}) == 1.5
    assert [m["name"] for m in bench.end_to_end("multi.greedy.b64")] == [
        "report_studies_per_s.greedy", "setup_s"]
