"""Synthetic fleet building + request traffic (port of
``repro/serving_encoders/traffic.py``).

``build_synthetic_fleet`` fits and saves one pipeline-standardized bundle
per synthetic subject through the port's ``data.fmri`` and
``encoding.pipeline``; ``ragged_requests`` draws concurrent requests of
ragged row counts.  The **deterministic mixed-traffic trace**
(``TraceSpec``/``make_mixed_trace``/``save_trace``/``load_trace``/
``replay_requests``) is the reference's, drawn from numpy alone: a trace
has the same entries and the same sha256 structure digest in either
package, and its float payloads are regenerated per entry from
``default_rng([seed, index])`` at replay time, so both packages replay
bitwise-equal requests.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os


def build_synthetic_fleet(workdir: str, n_models: int, *, n: int, p: int,
                          t: int, provenance: dict | None = None,
                          device=None) -> list[tuple[str, str]]:
    """Fit + save one pipeline-standardized bundle per synthetic subject,
    on ``device`` (CUDA unless ``device="cpu"``).

    Subject ``i`` is drawn from a ``torch.Generator`` seeded with ``i`` (a
    different draw from the reference's ``jax.random`` one).  Existing
    bundles under ``workdir`` are reused.  Returns ``[(name, path), ...]``.
    """
    import torch

    from repro_torch.data import fmri
    from repro_torch.device import resolve_device
    from repro_torch.encoding import EncoderConfig, pipeline
    from repro_torch.serving_encoders.bundle import (BUNDLE_MANIFEST,
                                                     EncoderBundle)

    dev = resolve_device(device)
    fleet = []
    for i in range(n_models):
        name = f"sub-{i + 1:02d}"
        path = os.path.join(workdir, name)
        if os.path.exists(os.path.join(path, BUNDLE_MANIFEST)):
            found = EncoderBundle.open(path).shape
            if found != (p, t):
                raise ValueError(
                    f"existing bundle {path} has shape (p, t)={found}, "
                    f"but (p={p}, t={t}) was requested — point at a fresh "
                    f"directory or delete the stale fleet")
            print(f"reusing bundle {path}")
        else:
            X, Y, _ = fmri.generate(
                fmri.SubjectSpec(n=n, p=p, t=t),
                torch.Generator(dev.type).manual_seed(i), device=dev)
            state = pipeline.run_stages(X, Y, [
                pipeline.split(seed=i), pipeline.standardize(),
                pipeline.fit(EncoderConfig(solver="ridge"), device=dev)],
                device=dev)
            state.encoder.save(
                path, overwrite=True,
                provenance={"subject": name, "n": n, "synthetic": True,
                            **(provenance or {})})
            lam = state.report.best_lambda
            print(f"fitted {name} (λ={lam}) → saved bundle {path}")
        fleet.append((name, path))
    return fleet


def ragged_requests(rng, models: list[str], p: int, wave_rows: int,
                    count: int) -> list:
    """``count`` concurrent requests with ragged row sizes in
    ``[8, max(9, 2·wave_rows))`` spread randomly over ``models`` — the
    mixed traffic of a serving run."""
    import numpy as np

    from repro_torch.serving_encoders.service import PredictRequest

    lo, hi = 8, max(9, 2 * wave_rows)          # guard hi > lo
    return [PredictRequest(
                model=models[int(rng.integers(len(models)))],
                features=rng.standard_normal(
                    (int(rng.integers(lo, hi)), p)).astype(np.float32))
            for _ in range(count)]


# -- deterministic mixed-traffic traces --------------------------------------

_TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One request in a trace: WHICH model, WHO is asking, HOW many rows,
    and whether targets ride along (scored).  Float payloads are not part
    of the trace — they are regenerated from ``(trace seed, entry index)``
    at replay time."""

    model_idx: int
    tenant: str
    rows: int
    scored: bool


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A checked-in mixed-traffic schedule (see module docstring)."""

    seed: int
    p: int                       # feature dim every request must carry
    t: int                       # target dim scored requests carry
    n_models: int                # fleet size the trace indexes into
    entries: tuple               # TraceEntry, arrival order
    zipf_a: float = 1.1

    def digest(self) -> str:
        return trace_digest(self.entries)


def trace_digest(entries) -> str:
    """sha256 over the trace *structure* (model_idx, tenant, rows,
    scored) — stable across numpy/platform drift because no float bytes
    are hashed."""
    payload = json.dumps(
        [[e.model_idx, e.tenant, e.rows, int(e.scored)] for e in entries],
        separators=(",", ":")).encode()
    return hashlib.sha256(payload).hexdigest()


def make_mixed_trace(seed: int, *, n_models: int, n_requests: int, p: int,
                     t: int, wave_rows: int, scored_frac: float = 0.4,
                     zipf_a: float = 1.1, n_tenants: int = 4) -> TraceSpec:
    """Generate a mixed-traffic schedule: ragged row counts in
    ``[8, 2·wave_rows)``, ``scored_frac`` of requests scored, model
    popularity Zipf-ish (weight ``1/(rank+1)^a`` — rank-0 dominates, the
    tail keeps forcing eviction churn when ``n_models`` exceeds what the
    registry budget fits)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(n_models) + 1.0) ** zipf_a
    w /= w.sum()
    lo, hi = 8, max(9, 2 * wave_rows)
    entries = tuple(
        TraceEntry(model_idx=int(rng.choice(n_models, p=w)),
                   tenant=f"tenant-{int(rng.integers(n_tenants)):02d}",
                   rows=int(rng.integers(lo, hi)),
                   scored=bool(rng.random() < scored_frac))
        for _ in range(n_requests))
    return TraceSpec(seed=seed, p=p, t=t, n_models=n_models,
                     entries=entries, zipf_a=zipf_a)


def save_trace(path: str, spec: TraceSpec) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    doc = {"version": _TRACE_VERSION, "seed": spec.seed, "p": spec.p,
           "t": spec.t, "n_models": spec.n_models, "zipf_a": spec.zipf_a,
           "digest": spec.digest(),
           "entries": [[e.model_idx, e.tenant, e.rows, int(e.scored)]
                       for e in spec.entries]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path


def load_trace(path: str) -> TraceSpec:
    """Load a checked-in trace, verifying its structure digest — a trace
    that drifted from what the benchmarks recorded is refused, not
    silently replayed."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != _TRACE_VERSION:
        raise ValueError(f"trace {path}: unsupported version "
                         f"{doc.get('version')}")
    entries = tuple(TraceEntry(model_idx=int(m), tenant=str(tn),
                               rows=int(r), scored=bool(s))
                    for m, tn, r, s in doc["entries"])
    got = trace_digest(entries)
    if got != doc["digest"]:
        raise ValueError(f"trace {path}: digest mismatch — file says "
                         f"{doc['digest'][:12]}…, entries hash to "
                         f"{got[:12]}… (the trace was edited; regenerate "
                         f"it with make_mixed_trace + save_trace)")
    return TraceSpec(seed=int(doc["seed"]), p=int(doc["p"]),
                     t=int(doc["t"]), n_models=int(doc["n_models"]),
                     entries=entries, zipf_a=float(doc["zipf_a"]))


def replay_requests(spec: TraceSpec, models: list[str]) -> list:
    """Materialise the trace's ``PredictRequest`` list.

    Each entry's float payload comes from ``default_rng([seed, index])``
    — independent of every other entry, so any slice of the trace
    replays the same requests (the reference serve and the packed serve
    see bit-identical inputs by construction).
    """
    import numpy as np

    from repro_torch.serving_encoders.service import PredictRequest

    if len(models) < spec.n_models:
        raise ValueError(f"trace wants {spec.n_models} models, fleet has "
                         f"{len(models)}")
    out = []
    for i, e in enumerate(spec.entries):
        rng = np.random.default_rng([spec.seed, i])
        X = rng.standard_normal((e.rows, spec.p)).astype(np.float32)
        Y = (rng.standard_normal((e.rows, spec.t)).astype(np.float32)
             if e.scored else None)
        out.append(PredictRequest(model=models[e.model_idx], features=X,
                                  targets=Y, tenant=e.tenant))
    return out


__all__ = ["TraceEntry", "TraceSpec", "build_synthetic_fleet", "load_trace",
           "make_mixed_trace", "ragged_requests", "replay_requests",
           "save_trace", "trace_digest"]
