"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and the files each entry is found by."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_and_units():
    b = bench()
    names = []
    for c in b["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in b["workloads"]:
        names.append(w["name"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    for m in b["end_to_end"] + b["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for text in ([c["why"] for c in b["configs"]]
                 + [c["source"] for c in b["configs"]]
                 + [w["why"] for w in b["workloads"]]
                 + [m["layer"] for m in b["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text


def test_metrics():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    reports = {c: {n for n, m in e2e.items()
                   if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2, c
    for m in b["per_layer"]:
        assert all(m["moves"] in reports[c]
                   for c in m.get("workloads", cells)), m["name"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))


def test_every_entry_has_its_files():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        used.add(w["config"])
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
        with open(os.path.join(HERE, "workloads", w["name"] + ".json")) as f:
            wl = json.load(f)
        assert wl["limits"] and all(0 < v < 1 for v in wl["limits"].values())
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("benchmark/")
        with open(os.path.join(ROOT, f)) as fh:
            assert "slam" in json.load(fh)


@pytest.mark.parametrize("path", ["benchmark"])
def test_paths_hold_only_allowed_names(path):
    ok = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
    for d, _, fs in os.walk(os.path.join(ROOT, path)):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            if "__pycache__" in rel:
                continue
            assert ok.match(rel), rel
