#!/usr/bin/env python3
"""Readings of a cell's comparison for the program and for its control.

    python3 ridgebench/control.py --workload parcels-inmem --seeds 3,4,5

For each seed, in one process: the cell's inputs, one fit of the program
as the window runs it, the reference (float32, TF32 off), and the
control: the reference again with its products in TF32, the precision
below the float32 the configurations state, put in the program's place.
Each prints one JSON line with the numbers ``correct`` compares
(``rb.correct.gaps``) for the program and for the control, and the
reference's λ and CV curve.  The program's readings over a dozen seeds
give a limit's lower reading, the control's its upper one.  Not run by
the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def readings(workload: str, seeds: list[int], *, device: str = "cuda",
             overrides: dict | None = None) -> list[dict]:
    import numpy as np
    import torch
    from rb import cell, correct, data, reference, spec

    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    cfg = cell.merge(spec.config(bench, wl["config"]), overrides)
    tr = spec.traffic(wl["traffic"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for seed in seeds:
        X, Y = data.make(cfg, seed, dev)
        inputs = cell._Inputs(cfg, tr, X, Y)
        del X, Y
        try:
            t0 = time.perf_counter()
            enc, rec = cell._one_fit(inputs, cell.encoder_config(cfg), dev)
            W = enc.weights_
            del enc
            gc.collect()
            Xr, Yr = inputs.arrays(dev)
            kw = dict(n_folds=cfg["n_folds"], jitter=cfg["jitter"],
                      scoring=cfg["scoring"])
            ref = reference.ridge_cv(Xr, Yr, cfg["lambdas"], **kw)
            prog = correct.gaps([rec.cv], W, ref)
            del W
            ctl = reference.ridge_cv(Xr, Yr, cfg["lambdas"], tf32=True, **kw)
            control = correct.gaps([ctl.cv.numpy()], ctl.weights, ref)
            cv = ref.cv.numpy()
            top = np.sort(cv)[::-1]
            out.append({
                "seed": seed, "program": prog, "control": control,
                "lambda": {"program": rec.lam,
                           "reference": cfg["lambdas"][ref.best],
                           "control": cfg["lambdas"][ctl.best]},
                "cv_margin": float(top[0] - top[1]),
                "kappa": ref.kappa.tolist(),
                "resolved": correct.resolved(ref).tolist(),
                "cv_reference": cv.tolist(),
                "cv_gap_by_lambda": {
                    "program": np.abs(rec.cv - cv).tolist(),
                    "control": np.abs(ctl.cv.numpy() - cv).tolist()},
                "seconds": time.perf_counter() - t0})
            del ref, ctl, Xr, Yr
        finally:
            inputs.close()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, [int(s) for s in args.seeds.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
