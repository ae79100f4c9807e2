"""The split-bf16 engine's arithmetic against the JAX package and f64.

``xty_folds``, ``xty_folds_masked`` and ``solve_lambda_grid`` run on the
card as one engine: f32 operand values (after their scale) cut into bf16 terms by
``ref.bf16_split3``, the kept term products (``split_engine.pairs``)
accumulated in f32.  On the CPU its plain model (``ref.split_product``,
``ref.xty_folds_split``, ``ref.xty_folds_masked_split``,
``ref.solve_lambda_grid_split``) is held
against the Pallas kernels in interpret mode within
``tests/test_kernels.py::_tol`` and against an f64 product within the
split's error bound; the split of ±Inf, NaN, ±0 and tiny values follows
the stated rule, and the host-side scratch sizes match the kernel's
tiles.  The CUDA kernels are held against the model on a card
(``-m cuda``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import foldstats as jfoldstats
from repro.kernels import gram as jgram
from repro.kernels import ridge_solve as jsolve
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ridge_solve as tsolve
from repro_torch.kernels import split_engine

U = 2.0 ** -24        # f32 unit roundoff
DROPPED = 2.0 ** -21  # a₁b₂ + a₂b₁ + a₂b₂ ≤ 2⁻²¹·|a||b|


def _tol(dtype):
    # As tests/test_kernels.py::_tol: blocked f32 reduction order differs
    # from the one-shot oracle; bf16 operands are rounded first.
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=2e-4)


def _masked_inputs(m, p, q, s, weights, seed):
    """x, z and slot weights: a one-hot of random slots, or ("real") that
    one-hot times uniform weights, or ("pow2") times powers of two."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, p)).astype(np.float32)
    z = rng.standard_normal((m, q)).astype(np.float32)
    slots = rng.integers(0, s, size=m)
    w = np.eye(s, dtype=np.float32)[slots]
    if weights == "real":
        w *= rng.uniform(0.0, 2.0, (m, s)).astype(np.float32)
    elif weights == "pow2":
        w *= 2.0 ** rng.integers(-3, 4, (m, s)).astype(np.float32)
    return x, z, w


def _solve_inputs(p, t, r, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((p, p)))
    evals = np.abs(rng.standard_normal(p)) * 10 + 0.1
    a = rng.standard_normal((p, t))
    lams = np.logspace(-1, 3, r)
    return tuple(v.astype(np.float32) for v in (q, evals, a, lams))


def _layout(q: np.ndarray, layout: str) -> torch.Tensor:
    if layout == "row":
        return torch.from_numpy(q.copy())
    return torch.from_numpy(np.ascontiguousarray(q.T)).T


def assert_nonfinite_rule(got, want, rel=1e-4):
    """NaN where ``want`` is NaN, non-finite where it is ±Inf, and the
    finite entries within ``rel``·max|want| of it."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape
    assert torch.isnan(got[torch.isnan(want)]).all()
    assert not torch.isfinite(got[torch.isinf(want)]).any()
    fin = torch.isfinite(want)
    scale = want[fin].abs().max().item() if fin.any() else 0.0
    torch.testing.assert_close(got[fin], want[fin], rtol=rel,
                               atol=rel * max(scale, 1e-30))


# ---------------------------------------------------------------------------
# The model against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["one-hot", "real"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,p,q,s", [(24, 16, 8, 3), (37, 5, 12, 4),
                                     (70, 33, 129, 2)])
def test_masked_split_model_matches_pallas_interpret(m, p, q, s, dtype,
                                                     weights):
    # The Pallas kernel rounds x·w to x's dtype (repro/kernels/gram.py:
    # (x * w) in bf16), the plain version and the engine keep it in f32;
    # bf16 real weights are powers of two, where both products are exact.
    if weights == "real" and dtype == "bfloat16":
        weights = "pow2"
    x, z, w = _masked_inputs(m, p, q, s, weights, m + p + q + s)
    tdt = getattr(torch, dtype)
    got = tref.xty_folds_masked_split(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(z).to(tdt),
                                      torch.from_numpy(w).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (s, p, q)
    want = jgram.xty_folds_masked(jnp.asarray(x, dtype),
                                  jnp.asarray(z, dtype),
                                  jnp.asarray(w, dtype), block_n=8,
                                  block_p=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,t,r", [(32, 24, 3), (130, 70, 11), (33, 5, 2)])
def test_solve_split_model_matches_pallas_interpret(p, t, r, dtype, layout):
    q, evals, a, lams = _solve_inputs(p, t, r, p * t + r)
    tdt = getattr(torch, dtype)
    got = tref.solve_lambda_grid_split(_layout(q, layout).to(tdt),
                                       torch.from_numpy(evals),
                                       torch.from_numpy(a).to(tdt),
                                       torch.from_numpy(lams))
    assert got.dtype == torch.float32 and got.shape == (r, p, t)
    want = jsolve.solve_lambda_grid(jnp.asarray(q, dtype),
                                    jnp.asarray(evals),
                                    jnp.asarray(a, dtype), jnp.asarray(lams),
                                    block_i=128, block_j=128, block_k=128,
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))


# Ragged folds of fold_bounds, and hand-made ones with an empty fold and a
# one-row fold.
FOLD_CASES = [(203, 24, 17, None), (70, 33, 129, None),
              (150, 33, 17, ((0, 7), (7, 7), (7, 100), (100, 101),
                             (101, 150)))]


def _fold_inputs(n, p, q, seed, scales=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p))
    if scales:
        # Values over many binades, so that every term plane is used.
        x = x * 2.0 ** rng.integers(-20, 20, (n, p))
    y = rng.standard_normal((n, q))
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,p,q,bounds", FOLD_CASES)
def test_folds_split_model_matches_pallas_interpret(n, p, q, bounds, dtype):
    bounds = bounds or tuple(jfoldstats.fold_bounds(n, 5))
    x, y = _fold_inputs(n, p, q, n + p + q)
    tdt = getattr(torch, dtype)
    got = tref.xty_folds_split(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(y).to(tdt), bounds)
    assert got.dtype == torch.float32 and got.shape == (len(bounds), p, q)
    want = jgram.xty_folds(jnp.asarray(x, dtype), jnp.asarray(y, dtype),
                           tuple(bounds), block_n=128, block_p=128,
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))
    for f, (lo, hi) in enumerate(bounds):
        if lo == hi:
            assert not got[f].any()


# xty: (n, p, q, y is x, S row ranges): ragged, q = 1 (the narrow tile), x
# is y (one split for both sides), one range and several.
XTY_CASES = [(203, 24, 17, False, 1), (300, 129, 70, False, 3),
             (97, 33, 1, False, 1), (1000, 5, 1, False, 4),
             (250, 40, 40, True, 1), (700, 33, 33, True, 3)]


def _rows(n, s):
    """Rows a range of S ranges of whole 32-row stages (0 for one)."""
    rows = -(-n // (32 * s)) * 32 if s > 1 else 0
    assert len(tref.split_ranges(n, rows)) == s
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,p,q,same,s", XTY_CASES)
def test_xty_split_model_matches_pallas_interpret_and_ref(n, p, q, same, s,
                                                          dtype):
    x, y = _fold_inputs(n, p, q, n + p + q)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    ty = tx if same else torch.from_numpy(y).to(tdt)
    got = tref.xty_split(tx, ty, _rows(n, s))
    assert got.dtype == torch.float32 and got.shape == (p, q)
    jx = jnp.asarray(x, dtype)
    jy = jx if same else jnp.asarray(y, dtype)
    for want in (np.asarray(jgram.xty(jx, jy, block_n=128, block_p=128,
                                      interpret=True)),
                 tref.xty(tx, ty).numpy()):
        tol = (_tol(dtype) if dtype == "bfloat16"
               else dict(rtol=1e-4, atol=1e-4 * np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xty_split_model_within_f64_bound(dtype):
    tdt = getattr(torch, dtype)
    x, y = _fold_inputs(600, 20, 30, 10, scales=True)
    tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    got = tref.xty_split(tx, ty, _rows(600, 3)).double().numpy()
    x64, y64 = tx.double().numpy(), ty.double().numpy()
    # The three partials' f32 sums and their sum: K + 8 + 2 roundings.
    err = np.abs(got - x64.T @ y64)
    assert (err <= _bound(x64, y64, 602)).all()


# ---------------------------------------------------------------------------
# The model against f64, within the split's error bound
# ---------------------------------------------------------------------------

def _bound(a64, b64, k):
    """|split − exact| ≤ (2⁻²¹ + (K + 8)·u)·|a|ᵀ|b|: the dropped pairs,
    then the f32 sums over K and over the kept products."""
    return (DROPPED + (k + 8) * U) * (np.abs(a64).T @ np.abs(b64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,mm,n", [(64, 40, 50), (513, 17, 300),
                                    (2048, 8, 8)])
def test_split_product_within_f64_bound(k, mm, n, dtype):
    rng = np.random.default_rng(k + mm + n)
    # Values over many binades, so that every term plane is used.
    a = (rng.standard_normal((k, mm)) * 2.0 ** rng.integers(-20, 20, (k, mm))
         ).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    na, nb = (3, 3) if dtype == "float32" else (1, 3)
    ta = torch.from_numpy(a)
    if dtype == "bfloat16":
        ta = ta.bfloat16().float()
    got = tref.split_product(ta, torch.from_numpy(b), na, nb).numpy()
    a64, b64 = ta.double().numpy(), b.astype(np.float64)
    err = np.abs(got - a64.T @ b64)
    assert (err <= _bound(a64, b64, k)).all(), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_models_within_f64_bound(dtype):
    tdt = getattr(torch, dtype)
    x, z, w = _masked_inputs(300, 20, 30, 3, "real", 5)
    tx, tz, tw = (torch.from_numpy(v).to(tdt) for v in (x, z, w))
    got = tref.xty_folds_masked_split(tx, tz, tw).double().numpy()
    xw = (tx.float()[None] * tw.float().T[:, :, None]).double().numpy()
    z64 = tz.double().numpy()
    for s in range(3):
        err = np.abs(got[s] - xw[s].T @ z64)
        assert (err <= _bound(xw[s], z64, 300)).all()
    q, evals, a, lams = _solve_inputs(200, 9, 4, 6)
    tq, ta = _layout(q, "col").to(tdt), torch.from_numpy(a).to(tdt)
    ev, lm = torch.from_numpy(evals), torch.from_numpy(lams)
    got = tref.solve_lambda_grid_split(tq, ev, ta, lm).double().numpy()
    scale = 1.0 / (ev[None, :] + lm[:, None])
    q64 = tq.double().numpy()
    for r in range(4):
        b64 = (ta.float() * scale[r][:, None]).double().numpy()
        err = np.abs(got[r] - q64 @ b64)
        assert (err <= _bound(q64.T, b64, 200)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folds_split_model_within_f64_bound(dtype):
    tdt = getattr(torch, dtype)
    x, y = _fold_inputs(600, 20, 30, 9, scales=True)
    tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    bounds = [(0, 150), (150, 150), (150, 600)]
    got = tref.xty_folds_split(tx, ty, bounds).double().numpy()
    x64, y64 = tx.double().numpy(), ty.double().numpy()
    for f, (lo, hi) in enumerate(bounds):
        err = np.abs(got[f] - x64[lo:hi].T @ y64[lo:hi])
        assert (err <= _bound(x64[lo:hi], y64[lo:hi], hi - lo)).all()


# ---------------------------------------------------------------------------
# The split of special values, and the non-finite rule
# ---------------------------------------------------------------------------

def test_bf16_split3_of_special_values():
    inf, nan = float("inf"), float("nan")
    v = torch.tensor([inf, -inf, nan, 0.0, -0.0])
    t1, t2, t3 = (t.float() for t in tref.bf16_split3(v))
    assert t1[0] == inf and t1[1] == -inf
    assert torch.isnan(t2[:2]).all() and torch.isnan(t3[:2]).all()
    assert torch.isnan(t1[2] + t2[2] + t3[2])
    for t in (t1, t2, t3):
        assert (t[3:] == 0).all()
    assert torch.signbit(t1[4]) and not torch.signbit(t1[3])
    # A NaN whose top 16 bits read as Inf: (Inf, NaN, NaN).
    odd = torch.tensor([0x7F800001], dtype=torch.int32).view(torch.float32)
    o1, o2, o3 = (t.float() for t in tref.bf16_split3(odd))
    assert o1[0] == inf and torch.isnan(o2).all() and torch.isnan(o3).all()


@pytest.mark.parametrize("exp", [0, -60, -100, -109, -115, -125, -130, -140])
def test_bf16_split3_is_exact_down_to_2_pow_minus_133(exp):
    rng = np.random.default_rng(-exp)
    v = torch.from_numpy((rng.uniform(1.0, 2.0, 64) * 2.0 ** exp
                          * rng.choice([-1.0, 1.0], 64)).astype(np.float32))
    terms = [t.double() for t in tref.bf16_split3(v)]
    err = (terms[0] + terms[1] + terms[2] - v.double()).abs()
    if exp >= -110:
        assert (err == 0).all()
    else:
        # Bits below bf16's smallest subnormal are lost, nothing more.
        assert (err < 2.0 ** -133).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_models_follow_the_nonfinite_rule(dtype):
    tdt = getattr(torch, dtype)
    x, z, w = _masked_inputs(40, 6, 9, 3, "one-hot", 11)
    tx, tz, tw = (torch.from_numpy(v) for v in (x, z, w))
    tx[4, 2] = float("nan")
    tw[4] = 0.0                        # a NaN row under a zero weight
    tx[7, 0] = float("inf")            # an Inf under its slot's weight
    tz[30, 5] = float("inf")
    tx, tz, tw = tx.to(tdt), tz.to(tdt), tw.to(tdt)
    want = tref.xty_folds_masked(tx, tz, tw)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert_nonfinite_rule(tref.xty_folds_masked_split(tx, tz, tw), want)
    q, evals, a, lams = _solve_inputs(20, 7, 3, 12)
    ta = torch.from_numpy(a)
    ta[3, 2] = float("inf")
    ta[5, 4] = float("nan")
    tq, ta = _layout(q, "col").to(tdt), ta.to(tdt)
    args = (tq, torch.from_numpy(evals), ta, torch.from_numpy(lams))
    want = tref.solve_lambda_grid(*args)
    assert torch.isnan(want).any()
    assert_nonfinite_rule(tref.solve_lambda_grid_split(*args), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folds_split_model_follows_the_nonfinite_rule(dtype):
    tdt = getattr(torch, dtype)
    x, y = _fold_inputs(40, 6, 9, 14)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tx[4, 2] = float("nan")
    ty[30, 5] = float("inf")
    tx, ty = tx.to(tdt), ty.to(tdt)
    bounds = [(0, 10), (10, 25), (25, 40)]
    want = tref.xty_folds(tx, ty, bounds)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    got = tref.xty_folds_split(tx, ty, bounds)
    assert_nonfinite_rule(got, want)
    # The fold between them stays finite.
    assert torch.isfinite(got[1]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xty_split_model_follows_the_nonfinite_rule(dtype):
    tdt = getattr(torch, dtype)
    x, y = _fold_inputs(300, 6, 9, 15)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tx[4, 2] = float("nan")
    ty[230, 5] = float("inf")
    tx, ty = tx.to(tdt), ty.to(tdt)
    want = tref.xty(tx, ty)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert_nonfinite_rule(tref.xty_split(tx, ty, _rows(300, 3)), want)


def test_masked_split_model_keeps_an_all_zero_slot_exactly_zero():
    x, z, w = _masked_inputs(50, 7, 11, 3, "real", 13)
    w[:, 1] = 0.0
    got = tref.xty_folds_masked_split(*(torch.from_numpy(v)
                                        for v in (x, z, w)))
    assert not got[1].any() and got[0].any()


# ---------------------------------------------------------------------------
# Host-side sizes
# ---------------------------------------------------------------------------

def test_kept_pairs_and_plane_counts():
    assert split_engine.pairs(3, 3) == list(split_engine.KEPT_PAIRS)
    assert all(i + j <= 2 for i, j in split_engine.KEPT_PAIRS)
    assert split_engine.pairs(2, 1) == [(0, 0), (1, 0)]
    assert split_engine.pairs(1, 3) == [(0, 0), (0, 1), (0, 2)]
    assert split_engine.folds_planes(torch.float32) == (3, 3)
    assert split_engine.folds_planes(torch.bfloat16) == (1, 1)
    assert split_engine.pairs(1, 1) == [(0, 0)]
    assert split_engine.masked_planes(torch.float32) == (3, 3)
    assert split_engine.masked_planes(torch.bfloat16) == (2, 1)
    assert split_engine.solve_planes(torch.float32) == (3, 3)
    assert split_engine.solve_planes(torch.bfloat16) == (1, 3)


@pytest.mark.parametrize("rows,k,planes,tile,want", [
    # The streamed fit's chunk: x·w of 2 slots (s·p rows), z (q rows).
    (2 * 16_384, 8_192, 3, 128, 3 * 32_768 * 8_192),
    (16_828, 8_192, 3, 192, 3 * 16_896 * 8_192),
    # The seed path's solve: Q, and the scaled A with r·t = 4,884 columns.
    (16_384, 16_384, 3, 128, 3 * 16_384 * 16_384),
    (11 * 444, 16_384, 3, 192, 3 * 4_992 * 16_384),
    # xty_folds at the parcels fit: x and [X | Y] of the largest of 5
    # folds of 69,202 rows (13,841).
    (16_384, 13_841, 3, 128, 3 * 16_384 * 13_856),
    (16_828, 13_841, 3, 192, 3 * 16_896 * 13_856),
    # Ragged: rows and K padded to the tile and the 32-k stage.
    (1, 1, 1, 128, 128 * 32),
    (257, 33, 2, 192, 2 * 384 * 64),
    (129, 0, 3, 128, 0),
])
def test_scratch_numel_pads_rows_and_k(rows, k, planes, tile, want):
    assert split_engine.scratch_numel(rows, k, planes, tile) == want


def test_host_tiles_are_the_kernels():
    """The wrapper sizes scratch with the tiles the CUDA source uses."""
    src = (Path(split_engine.__file__).parent / "csrc"
           / "split_engine.cuh").read_text()
    tiles = dict(re.findall(r"constexpr int (kB[MNK]\w*) = (\d+);", src))
    assert tiles == {"kBM": str(split_engine.TILE_M),
                     "kBN": str(split_engine.TILE_N),
                     "kBNNarrow": str(split_engine.TILE_N_NARROW),
                     "kBK": str(split_engine.STAGE_K)}


def test_narrow_and_shared_tiles():
    """The B side's tile narrows to 32 columns at N ≤ 32 (MOR's q = 1);
    planes both sides read are padded for the 128-row tile and it."""
    assert [split_engine.tile_n(n) for n in (1, 32, 33, 192, 16_384)] == \
        [32, 32, 192, 192, 192]
    assert split_engine.shared_tile(1_000) == 384
    assert split_engine.shared_tile(20) == 128


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_kernels_match_the_split_model(dtype):
    """The kernels against the model of their own arithmetic: only the
    f32 summation order differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(5)
    # q = 257 on the 192-column tile, q = 17 on the narrow 32-column one.
    for m, p, q, s in ((333, 129, 257, 2), (203, 129, 17, 2)):
        x = torch.randn(m, p, device="cuda", generator=g).to(dt)
        z = torch.randn(m, q, device="cuda", generator=g).to(dt)
        w = torch.rand(m, s, device="cuda", generator=g).to(dt)
        want = tref.xty_folds_masked_split(x, z, w)
        torch.testing.assert_close(tgram.xty_folds_masked(x, z, w), want,
                                   rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    q, evals, a, lams = (torch.from_numpy(v).cuda()
                         for v in _solve_inputs(161, 445, 3, 7))
    q, a = q.T.contiguous().T.to(dt), a.to(dt)
    want = tref.solve_lambda_grid_split(q, evals, a, lams)
    torch.testing.assert_close(tsolve.solve_lambda_grid(q, evals, a, lams),
                               want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_xty_folds_matches_split_model(dtype):
    """xty_folds on the engine against the model of its own arithmetic and
    the plain version: ragged folds, an empty fold (exact zeros), repeated
    launches bitwise equal, one counted launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(6)
    x = torch.randn(1037, 255, device="cuda", generator=g).to(dt)
    y = torch.randn(1037, 391, device="cuda", generator=g).to(dt)
    bounds = [(0, 300), (300, 300), (300, 301), (301, 1037)]
    tgram.reset_launches()
    got = tgram.xty_folds(x, y, bounds)
    want = tref.xty_folds_split(x, y, bounds)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    plain = tref.xty_folds(x, y, bounds)
    torch.testing.assert_close(got, plain, rtol=1e-4,
                               atol=1e-4 * plain.abs().max().item())
    assert not got[1].any()
    assert torch.equal(got, tgram.xty_folds(x, y, bounds))
    assert tgram.LAUNCHES["xty_folds"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_xty_follows_the_nonfinite_rule(dtype):
    """xty on the engine, one range and split-K: NaN where the plain
    version is NaN, non-finite where it is ±Inf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tdt = getattr(torch, dtype)
    x, y = _fold_inputs(3000, 6, 9, 16)
    tx, ty = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    tx[4, 2] = float("nan")
    ty[2300, 5] = float("inf")
    tx, ty = tx.to(tdt), ty.to(tdt)
    want = tref.xty(tx, ty)
    assert tgram.row_splits(3000, 6, 9) > 0
    assert_nonfinite_rule(tgram.xty(tx, ty), want)
    assert_nonfinite_rule(tgram._xty_rows(tx, ty, 0), want)
