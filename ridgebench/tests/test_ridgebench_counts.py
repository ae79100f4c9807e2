"""The operation and byte counts give the values the benchmark's
documents state for both configurations."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from rb import spec  # noqa: E402

BF16, HBM = 989e12, 3.35e12
PARCELS = dict(n=69_202, p=16_384, t=444, k=5)
WHOLEBRAIN = dict(n=10_000, p=16_384, t=16_384, k=5)


@pytest.mark.parametrize("sizes, flops, nbytes, bound_ms", [
    (PARCELS, 1.958422e13, 1.017232e10, 19.80),
    (WHOLEBRAIN, 8.053228e12, 1.204814e10, 8.143),
])
def test_fold_statistics(sizes, flops, nbytes, bound_ms):
    c = spec.count("xty_folds")
    assert c.flops(**sizes) == pytest.approx(flops, rel=1e-6)
    assert c.bytes(**sizes) == pytest.approx(nbytes, rel=1e-6)
    bound = max(c.flops(**sizes) / BF16, c.bytes(**sizes) / HBM)
    assert bound * 1e3 == pytest.approx(bound_ms, rel=1e-3)


def test_eigh():
    assert spec.count("eigh").flops(16_384) == pytest.approx(
        10 / 3 * 16_384 ** 3)


@pytest.mark.parametrize("name, sizes, flops", [
    ("fit_primal", PARCELS, 1.665748e14),
    ("fit_colblocked", WHOLEBRAIN, 7.513258e14),
])
def test_fit(name, sizes, flops):
    got = spec.count(name).flops(r=11, **sizes)
    assert got == pytest.approx(flops, rel=1e-6)


@pytest.mark.parametrize("workload", ["parcels-inmem",
                                      "wholebrain-colblocked"])
def test_configs_hold_the_counted_shapes(workload):
    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    cfg = spec.config(bench, wl["config"])
    want = PARCELS if wl["config"] == "parcels" else WHOLEBRAIN
    assert {k: cfg[k if k != "k" else "n_folds"] for k in want} == want
    assert len(cfg["lambdas"]) == 11
