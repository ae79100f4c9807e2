"""Span-trace report — per-phase time/bytes breakdown of a JSONL trace.

Port of ``repro/launch/obs_report.py`` (stdlib only).  Reads the JSONL
span stream that ``obs.write_trace`` writes for a path not ending in
``.json`` (one ``repro_torch.obs`` event per line) and prints, per span name: call
count, total seconds, mean milliseconds, share of the trace wall, and
the bytes the spans carried (``bytes``/``bytes_staged`` attrs).

The report also computes **root coverage**: the fraction of the longest
root (depth-0) span's wall time attributed to its direct (depth-1)
children.  A healthy instrumented fit attributes ≥95% — anything less
means an uninstrumented phase is hiding inside the root.
``--assert-coverage 0.95`` turns that into an exit-code gate
(``chip_smoke.py`` holds its traced fits to it through
:func:`root_coverage`).

::

    python -m repro_torch.launch.obs_report trace.jsonl
    python -m repro_torch.launch.obs_report trace.jsonl --assert-coverage 0.95
"""
from __future__ import annotations

import argparse
import json


def load_events(path: str) -> list[dict]:
    """Parse a JSONL span trace (skips blank lines)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if "name" not in ev or "ts_us" not in ev:
                raise ValueError(f"{path}: not a repro.obs JSONL trace "
                                 f"(event missing name/ts_us: {ev})")
            events.append(ev)
    return events


def _span_bytes(ev: dict) -> int:
    attrs = ev.get("attrs") or {}
    return int(attrs.get("bytes", 0) or 0) \
        + int(attrs.get("bytes_staged", 0) or 0)


def summarize(events: list[dict]) -> dict:
    """Aggregate per span name: ``{name: {count, total_us, bytes}}``."""
    agg: dict[str, dict] = {}
    for ev in events:
        if ev.get("instant"):
            continue
        row = agg.setdefault(ev["name"],
                             {"count": 0, "total_us": 0.0, "bytes": 0})
        row["count"] += 1
        row["total_us"] += ev["dur_us"]
        row["bytes"] += _span_bytes(ev)
    return agg


def root_coverage(events: list[dict]) -> tuple[dict | None, float]:
    """(longest depth-0 span, fraction of it covered by its depth-1
    children).  ``(None, 0.0)`` when the trace has no root span."""
    roots = [e for e in events if e.get("depth") == 0
             and not e.get("instant")]
    if not roots:
        return None, 0.0
    root = max(roots, key=lambda e: e["dur_us"])
    if root["dur_us"] <= 0:
        return root, 0.0
    lo, hi = root["ts_us"], root["ts_us"] + root["dur_us"]
    kids = [e for e in events
            if e.get("depth") == 1 and not e.get("instant")
            and e.get("parent") == root["name"]
            and lo <= e["ts_us"] and e["ts_us"] + e["dur_us"] <= hi + 1.0]
    return root, sum(k["dur_us"] for k in kids) / root["dur_us"]


def render(events: list[dict]) -> str:
    agg = summarize(events)
    if not agg:
        return "(empty trace)"
    wall_us = (max(e["ts_us"] + e.get("dur_us", 0.0) for e in events)
               - min(e["ts_us"] for e in events)) or 1.0
    name_w = max(len(n) for n in agg) + 2
    lines = [f"{'span':<{name_w}}{'count':>7}{'total_s':>10}"
             f"{'mean_ms':>10}{'%wall':>8}{'MB':>10}"]
    for name, row in sorted(agg.items(),
                            key=lambda kv: -kv[1]["total_us"]):
        total_s = row["total_us"] / 1e6
        mean_ms = row["total_us"] / row["count"] / 1e3
        lines.append(
            f"{name:<{name_w}}{row['count']:>7}{total_s:>10.3f}"
            f"{mean_ms:>10.2f}{100 * row['total_us'] / wall_us:>7.1f}%"
            f"{row['bytes'] / 2**20:>10.2f}")
    n_instants = sum(1 for e in events if e.get("instant"))
    if n_instants:
        lines.append(f"(+ {n_instants} instant events)")
    root, cov = root_coverage(events)
    if root is not None:
        lines.append(f"root {root['name']!r}: "
                     f"{root['dur_us'] / 1e6:.3f}s wall, "
                     f"{100 * cov:.1f}% attributed to direct children")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="JSONL span trace (obs.write_trace output)")
    ap.add_argument("--assert-coverage", type=float, default=None,
                    metavar="FRAC",
                    help="exit non-zero unless the longest root span "
                         "attributes at least FRAC of its wall time to "
                         "its direct children")
    args = ap.parse_args()

    events = load_events(args.trace)
    print(render(events))
    if args.assert_coverage is not None:
        root, cov = root_coverage(events)
        if root is None:
            raise SystemExit("coverage assertion failed: trace has no "
                             "root (depth-0) span")
        if cov < args.assert_coverage:
            raise SystemExit(
                f"coverage assertion failed: {100 * cov:.1f}% of root "
                f"{root['name']!r} attributed, need "
                f"{100 * args.assert_coverage:.1f}%")
        print(f"coverage ≥ {100 * args.assert_coverage:.0f}% ✓")


if __name__ == "__main__":
    main()
