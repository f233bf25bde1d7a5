"""The benchmark's files: every configuration, cell and metric of
BENCHMARK.json is found by its name, and names, units and entries keep
to the benchmark's format."""

import importlib.util
import json
import os
import re

import pytest

from benchtools import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _module(kind, name):
    path = os.path.join(ROOT, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one_line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_entries_have_the_contract_keys(bench):
    assert set(bench) == KEYS["top"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[kind]:
            extra = set(entry) - KEYS[kind]
            assert set(entry) >= KEYS[kind] and extra <= {"workloads"}, entry
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(bench):
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (kind, entry["name"]) not in seen
            seen.add((kind, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _one_line(entry[key]), (entry["name"], key)
    for cell in bench["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
    pairs = [(c["config"], c["traffic"]) for c in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_file_is_found_by_name(bench):
    configs = {c["name"] for c in bench["configs"]}
    for conf in bench["configs"]:
        path = os.path.join(ROOT, conf["file"])
        assert conf["file"] == f"benchmark/configs/{conf['name']}.json"
        with open(path) as fh:
            data = json.load(fh)
        assert data["name"] == conf["name"]
        assert data["reduced"] == conf["reduced"]
        assert data["source"] == conf["source"]
        assert all(NAME.match(k) for k in conf["reduced"])
    used = set()
    for cell in bench["workloads"]:
        path = os.path.join(ROOT, "benchmark", "workloads",
                            cell["name"] + ".json")
        with open(path) as fh:
            data = json.load(fh)
        for key in ("config", "traffic", "why"):
            assert data[key] == cell[key], (cell["name"], key)
        assert cell["config"] in configs
        used.add(cell["config"])
        limits = data["limits"]
        assert limits and all(isinstance(v, float) and v > 0
                              for v in limits.values()), cell["name"]
    assert used == configs
    for kind in ("end_to_end", "per_layer"):
        for metric in bench[kind]:
            assert callable(_module("metrics", metric["name"]).read)


def test_metric_links(bench):
    cells = {c["name"] for c in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_paths_hold_only_the_benchmark(bench):
    for path in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
        assert not path.startswith("/") and ".." not in path
    name_chars = re.compile(r"^[A-Za-z0-9_./-]+$")
    for dirpath, dirnames, files in os.walk(os.path.join(ROOT, "benchmark")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert name_chars.match(rel), rel
