"""The port's cross-Gram kernels against the JAX package's.

On the CPU the port's entry points run the plain versions
(``repro_torch.kernels.ref``); they are held against the Pallas kernels in
interpret mode and against ``repro.kernels.ref`` on the same numpy inputs.
The CUDA kernel itself is held against the plain version on a card.
"""
import importlib
import subprocess
import sys
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import foldstats as jfoldstats
from repro.kernels import gram as jgram
from repro.kernels import ref as jref
from repro_torch.core import ridge
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import split_engine

ROOT = Path(__file__).resolve().parents[1]

SHAPES_XTY = [
    (64, 32, 48),      # ragged, smaller than one tile
    (300, 129, 70),    # non-multiples of every block dim
    (1024, 256, 256),  # exact tile multiples
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    # As tests/test_kernels.py::_tol: blocked f32 reduction order differs.
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=2e-4)


def _inputs(seed, shape_x, shape_y, dtype):
    """Same values for both packages: f32 numpy, rounded to bf16 in each."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_x).astype(np.float32)
    y = rng.standard_normal(shape_y).astype(np.float32)
    jx, jy = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    tdt = getattr(torch, dtype)
    tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    return jx, jy, tx, ty


@pytest.mark.parametrize("n,p,q", SHAPES_XTY)
@pytest.mark.parametrize("dtype", DTYPES)
def test_xty_matches_jax_kernel_and_ref(n, p, q, dtype):
    jx, jy, tx, ty = _inputs(n + p + q, (n, p), (n, q), dtype)
    got = tops.xty(tx, ty)
    assert got.dtype == torch.float32 and got.shape == (p, q)
    jk = jgram.xty(jx, jy, block_n=128, block_p=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), **_tol(dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.xty(jx, jy)),
                               **_tol(dtype))


@pytest.mark.parametrize("n,p", [(64, 32), (300, 129)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_matches_jax_ref(n, p, dtype):
    jx, _, tx, _ = _inputs(n * p, (n, p), (n, 1), dtype)
    got = tops.gram(tx)
    assert got.shape == (p, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.gram(jx)),
                               **_tol(dtype))
    np.testing.assert_allclose(got.numpy(), tref.xty(tx, tx).numpy(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,p,q,k", [(203, 24, 17, 5), (64, 16, 9, 4),
                                     (130, 33, 40, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_xty_folds_matches_jax_kernel(n, p, q, k, dtype):
    bounds = jfoldstats.fold_bounds(n, k)          # uneven when k ∤ n
    jx, jy, tx, ty = _inputs(n + k, (n, p), (n, q), dtype)
    got = tops.xty_folds(tx, ty, bounds)
    assert got.dtype == torch.float32 and got.shape == (k, p, q)
    jk = jgram.xty_folds(jx, jy, tuple(bounds), block_n=128, block_p=128,
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), **_tol(dtype))
    # Against the f64 oracle of the reference's own test.
    x64 = np.asarray(jx, np.float64)
    y64 = np.asarray(jy, np.float64)
    want = np.stack([x64[lo:hi].T @ y64[lo:hi] for lo, hi in bounds])
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))


def test_xty_folds_empty_and_ragged_folds_match_per_fold_ref():
    _, _, tx, ty = _inputs(7, (150, 33), (150, 17), "float32")
    bounds = [(0, 7), (7, 7), (7, 100), (100, 101), (101, 150)]
    got = tops.xty_folds(tx, ty, bounds)
    for f, (lo, hi) in enumerate(bounds):
        np.testing.assert_allclose(
            got[f].numpy(), np.asarray(jref.xty(jnp.asarray(tx[lo:hi].numpy()),
                                                jnp.asarray(ty[lo:hi].numpy()))),
            **_tol("float32"))
    assert not got[1].any()


def test_ops_route_cpu_tensors_to_plain_versions_without_launching():
    _, _, tx, ty = _inputs(3, (40, 8), (40, 5), "float32")
    tgram.reset_launches()
    tops.xty(tx, ty)
    tops.gram(tx)
    tops.xty_folds(tx, ty, [(0, 20), (20, 40)])
    tops.xty_folds_masked(tx, ty, torch.ones(40, 2))
    assert tgram.LAUNCHES == {"xty": 0, "xty_folds": 0,
                              "xty_folds_masked": 0}
    assert tops.kernel_tier_auto("cpu") is False
    assert tops.kernel_tier_auto(torch.device("cuda")) is True


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_operands():
    x = torch.zeros(6, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tgram.xty(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        tgram.xty_folds(x, x, [(0, 6)])
    with pytest.raises(ValueError, match="contiguous"):
        tgram._check_bounds([(0, 2), (3, 6)], 6)
    with pytest.raises(ValueError, match="covering"):
        tgram._check_bounds([(0, 5)], 6)
    assert tgram._check_bounds([(0, 0), (0, 6)], 6) == [(0, 0), (0, 6)]
    # The kernel takes the bounds by value, for at most 64 folds.
    assert len(tgram._check_bounds([(i, i + 1) for i in range(64)], 64)) == 64
    with pytest.raises(ValueError, match="at most 64"):
        tgram._check_bounds([(i, i + 1) for i in range(65)], 65)


def test_kernels_gram_module_imports_without_nvcc():
    # Importing builds nothing: nvcc is looked for only at the first launch.
    code = ("import sys, repro_torch.kernels.gram as g, "
            "repro_torch.kernels._build as b\n"
            "assert b.load.cache_info().currsize == 0\n"
            "assert 'triton' not in sys.modules\n"
            "print(b.library_path().name)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="/nonexistent",
               CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("librepro_kernels_")
    b = importlib.import_module("repro_torch.kernels._build")
    assert b.BUILD_DIR == ROOT / "build" / "kernels"
    assert "arch=compute_90a,code=sm_90a" in b.NVCC_FLAGS


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    (src / "a.cuh").write_text("// header one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    _build._sources.cache_clear()
    _build._headers.cache_clear()
    try:
        first = _build.library_path()
        (src / "a.cu").write_text("// two\n")
        second = _build.library_path()
        assert second != first
        # A header the sources include enters the hash too.
        (src / "a.cuh").write_text("// header two\n")
        assert _build.library_path() != second
        assert _build._sources() == (src / "a.cu",)
    finally:
        _build._sources.cache_clear()
        _build._headers.cache_clear()


# The ranges row_splits picks at the split shapes below: the fewest with
# the least modelled time (chip_smoke.py's phase 2 times XXᵀ over S ranges
# on a card).
SPLITS = {(16_384, 1_000, 1_000): 8, (20_000, 300, 300): 22,
          (1_037, 255, 130): 5}


@pytest.mark.parametrize("n,p,q,split", [
    (16_384, 1_000, 1_000, True),     # the dual fit's XXᵀ: 8 × 6 = 48 tiles
    (20_000, 300, 300, True),         # 3 × 2 tiles
    (1_037, 255, 130, True),          # 2 tiles, only 33 stages
    (69_202, 16_384, 16_828, False),  # the primal Gram: a full grid
    (1_000, 16_384, 2_000, False),    # the dual Xᵀα: 128 × 11 tiles
    (200, 10, 10, False),             # 7 stages: too few rows to split
    (0, 5, 5, False),
])
def test_xty_row_splits_rule(n, p, q, split):
    tiles = -(-p // 128) * -(-q // split_engine.tile_n(q))
    rows = tgram.row_splits(n, p, q)
    got = tref.split_ranges(n, rows)
    assert len(got) == SPLITS.get((n, p, q), 1)
    assert (len(got) > 1) == split
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert len(got) <= 64
    if split:
        # Whole 32-row stages, one length, at least 256 rows; the last
        # range takes the rest.  Only an output of fewer tiles than SMs.
        assert rows % 32 == 0 and rows >= 256
        assert all(hi - lo == rows for lo, hi in got[:-1])
        assert 0 < got[-1][1] - got[-1][0] <= rows
        assert tiles < 132
    else:
        assert rows == 0 and got == [(0, n)]
    # Fewer SMs → fewer ranges; a card with 4× the SMs never fewer.
    assert len(tref.split_ranges(n, tgram.row_splits(n, p, q, sms=33))) \
        <= len(got) \
        <= len(tref.split_ranges(n, tgram.row_splits(n, p, q, sms=528)))


@pytest.mark.parametrize("n,rows,want", [
    (300, 0, [(0, 300)]),                  # one range
    (300, 256, [(0, 256), (256, 300)]),    # the last takes the rest
    (300, 300, [(0, 300)]),                # a range of all rows: one
    (96, 32, [(0, 32), (32, 64), (64, 96)]),
    (0, 0, [(0, 0)]),
])
def test_split_ranges_cover_the_rows(n, rows, want):
    assert tref.split_ranges(n, rows) == want


@pytest.mark.parametrize("n,p,q,same,dtype,want", [
    # A seed-path fold Gram at parcels (x is y: one split, rows padded to
    # 384 for both tiles; 5.49 GB), the refit's (6.86 GB), bf16.
    (55_361, 16_384, 16_384, True, "float32", (3 * 16_512 * 55_392, 0)),
    (69_202, 16_384, 16_384, True, "float32", (3 * 16_512 * 69_216, 0)),
    (55_361, 16_384, 16_384, True, "bfloat16", (16_512 * 55_392, 0)),
    # The dual XXᵀ (x the transposed 16,384 × 1,000 view), Xᵀα and MOR's
    # single-target Xᵀα (the narrow 32-column tile).
    (16_384, 1_000, 1_000, True, "float32", (3 * 1_152 * 16_384, 0)),
    (1_000, 16_384, 2_000, False, "float32",
     (3 * 16_384 * 1_024, 3 * 2_112 * 1_024)),
    (1_000, 16_384, 1, False, "float32", (3 * 16_384 * 1_024, 3 * 32 * 1_024)),
])
def test_xty_scratch_at_the_main_shapes(n, p, q, same, dtype, want):
    assert tgram._xty_scratch_numel(n, p, q, getattr(torch, dtype),
                                    same) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_xty_row_split_matches_plain_version(dtype):
    """xty against the plain version and its split model: a narrow output
    over many rows (split-K), x is y, q = 1 (the narrow tile), a
    transposed view (bitwise equal to its contiguous copy); repeated
    launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tgram.reset_launches()
    calls = 0
    for n, p, q, same in [(20_000, 300, 300, True), (16_384, 1_000, 1_000,
                                                       True),
                          (5_003, 129, 7, False), (1_000, 300, 1, False),
                          (777, 150, 150, True)]:
        x = torch.randn(n, p, device="cuda", generator=g).to(dt)
        if p == 1_000:
            x = x.T.contiguous().T      # the dual XXᵀ's transposed view
        y = x if same else torch.randn(n, q, device="cuda",
                                       generator=g).to(dt)
        rows = tgram.row_splits(n, p, q, sms)
        got = tgram.xty(x, y)
        want = tref.xty(x, y)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 *
                                   want.abs().max().item())
        model = tref.xty_split(x, y, rows)
        torch.testing.assert_close(got, model, rtol=1e-5, atol=1e-5 *
                                   model.abs().max().item())
        assert torch.equal(got, tgram.xty(x, y))
        calls += 2
        if not x.is_contiguous():
            xc = x.contiguous()
            assert torch.equal(got, tgram.xty(xc, xc))
            calls += 1
    assert tgram.LAUNCHES == {"xty": calls, "xty_folds": 0,
                              "xty_folds_masked": 0}


@pytest.mark.cuda
def test_cuda_xxt_reads_the_transposed_view_without_a_copy():
    """ridge.xxt hands xty the view Xᵀ: bitwise what a contiguous copy of
    Xᵀ gives, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator("cuda").manual_seed(4)
    X = torch.randn(300, 2_000, device="cuda", generator=g)
    tgram.reset_launches()
    got = ridge.xxt(X, use_pallas=True)
    assert tgram.LAUNCHES["xty"] == 1
    Xt = X.T.contiguous()
    assert torch.equal(got, tgram.xty(Xt, Xt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(1037, 255, device="cuda", generator=g).to(dt)
    y = torch.randn(1037, 391, device="cuda", generator=g).to(dt)
    bounds = jfoldstats.fold_bounds(1037, 5)
    tgram.reset_launches()
    got = tgram.xty_folds(x, y, bounds)
    want = tref.xty_folds(x, y, bounds)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 *
                               want.abs().max().item())
    got = tgram.xty(x, y)
    torch.testing.assert_close(got, tref.xty(x, y), rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    model = tref.xty_split(x, y, tgram.row_splits(1037, 255, 391))
    torch.testing.assert_close(got, model, rtol=1e-5,
                               atol=1e-5 * model.abs().max().item())
    assert tgram.LAUNCHES == {"xty": 1, "xty_folds": 1,
                              "xty_folds_masked": 0}
