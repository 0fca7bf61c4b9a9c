"""BENCHMARK.json against the benchmark's contract: names, units and
lengths; every file found by its name; each per-layer metric moves an
end-to-end metric that all of its cells report."""

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in (bench["configs"], bench["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024
    assert all(_line(word) for word in bench["command"]) and len(bench["command"]) <= 32
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_moves_names_an_end_to_end_metric_its_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}
    reported = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in reported, m["name"]
        assert set(m.get("workloads", cells)) <= reported[m["moves"]] & cells, m["name"]
    for w in cells:
        e2e = [n for n, c in reported.items() if w in c]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])


def test_files_are_found_by_name(bench):
    paths = bench["paths"]
    assert all(os.path.isdir(os.path.join(ROOT, p)) for p in paths)
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    import run

    for m in bench["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    cell, config, traffic, e2e, per_layer = run.load_cell(bench["workloads"][0]["name"], ROOT)
    assert config["name"] == cell["config"] and traffic["name"] == cell["traffic"]
