"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

* configuration ``c``: the ``file`` of its entry (``configs/<c>.json``);
* traffic mix ``m``: ``traffic/<m>.json``;
* cell ``w``: ``cells/<w>.json`` (its plan, launches, operation count and
  the limits of its comparison);
* per-layer metric ``x``: the reader ``metrics/<x>.py`` (``read(ctx)``);
* operation count ``k``: ``counts/<k>.py``;
* the card's peaks: ``peaks.json``.

A later change adds a cell, a configuration or a metric by adding files
and entries; no file here needs an edit for it.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return _json(BENCH_DIR / "cells" / f"{name}.json")


def peaks() -> dict:
    return _json(BENCH_DIR / "peaks.json")


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"ridgebench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str) -> ModuleType:
    """The per-layer metric's reader: ``read(ctx) -> float | None``."""
    return _module(BENCH_DIR / "metrics" / f"{name}.py")


def count(name: str) -> ModuleType:
    """An operation count: ``flops(**sizes)`` (and ``bytes(**sizes)`` for
    a kernel)."""
    return _module(BENCH_DIR / "counts" / f"{name}.py")


def metrics_for(bench: dict, wl: dict, trace: bool) -> list[dict]:
    """The end-to-end metrics a cell reports untraced, or its per-layer
    metrics traced: those whose ``workloads`` name the cell, or, without
    the key, every end-to-end metric and every per-layer metric that
    moves one of the cell's."""
    def applies(m: dict, reported: set[str] | None) -> bool:
        if "workloads" in m:
            return wl["name"] in m["workloads"]
        return reported is None or m["moves"] in reported

    e2e = [m for m in bench["end_to_end"] if applies(m, None)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if applies(m, names)]
