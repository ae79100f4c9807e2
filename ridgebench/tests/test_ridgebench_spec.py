"""``BENCHMARK.json`` and the files it names: the contract's shapes, and
every cell, configuration, traffic mix, metric and count found by its
file name."""
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from rb import spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
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
    return spec.benchmark()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(bench):
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert set(bench) == KEYS["top"]
    for part in ("configs", "workloads"):
        for entry in bench[part]:
            assert set(entry) == KEYS[part], entry
    for part in ("end_to_end", "per_layer"):
        for m in bench[part]:
            assert KEYS[part] <= set(m) <= KEYS[part] | {"workloads"}, m
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(bench, part):
    names = [e["name"] for e in bench[part]]
    assert len(set(names)) == len(names)
    for e in bench[part]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and part in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (key, e[key])
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key), key


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    files = [w for w in bench["command"] if (ROOT / w).is_file()]
    assert files and all(any(f.startswith(p + "/") for p in bench["paths"])
                         for f in files)
    # Every file under paths is named from the characters of a name.
    for p in bench["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                assert PATH.match(str(f.relative_to(ROOT))), f


def test_metric_rules(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        # Each cell a metric lists reports the metric it moves.
        moved = next(e for e in bench["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells)), m["name"]
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    # Every cell reports setup_s, another end-to-end metric and a
    # per-layer metric.
    for w in bench["workloads"]:
        assert spec.metrics_for(bench, w, True)
        assert len(spec.metrics_for(bench, w, False)) >= 2
    # Metrics of one layer give the same layer, letter for letter.
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(_line(x) for x in layers)


def test_run_seconds_fit_a_full_check(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_cells_and_configs(bench):
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({c["source"] for c in bench["configs"]}) \
        == len(bench["configs"])


@pytest.mark.parametrize("workload", ["parcels-inmem",
                                      "wholebrain-colblocked"])
def test_found_by_file_name(bench, workload):
    wl = spec.workload(bench, workload)
    cfg = spec.config(bench, wl["config"])
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    assert cfg["name"] == wl["config"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert entry["file"] == f"ridgebench/configs/{wl['config']}.json"
    assert spec.traffic(wl["traffic"])["input"] in ("memory", "store")
    cl = spec.cell(workload)
    assert set(cl) >= {"plan", "launches_per_fit", "fit_count", "limits"}
    assert set(cl["limits"]) == {"cv_gap", "w_gap"}
    assert callable(spec.count(cl["fit_count"]).flops)
    for m in spec.metrics_for(bench, wl, True):
        assert callable(spec.reader(m["name"]).read), m["name"]


def test_every_metric_has_a_reader(bench):
    names = {m["name"] for m in bench["per_layer"]}
    files = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    assert names == files
    assert json.loads((BENCH / "peaks.json").read_text())["cards"]
