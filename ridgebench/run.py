#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 ridgebench/run.py --workload parcels-inmem --seed 7 \\
        --seconds 40 --trace 0

from the root of a checkout that holds ``BENCHMARK.json``,
``ridgebench/`` and the port (``src/repro_torch``).  ``--trace 0`` prints
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics read
from a ``torch.profiler`` trace of the window.  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each compared number beside its limit); the last
lines of standard error are the same checks.  The run exits non-zero
and prints no result without enough CUDA cards, when the port cannot be
imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from rb import cell, spec

    chips = spec.workload(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ridgebench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START, device="cuda")
    bad = forbidden_modules()
    if bad:
        print(f"ridgebench: the run loaded {bad}: the benchmark drives the "
              f"port alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
