"""The port's fold statistics and ridge CV against the JAX package's.

Both packages get the same numpy inputs.  λ must be equal; W and the CV
curve agree within the f32 tolerance of ``tests/test_kernels.py::_tol``;
eigenvectors are never compared (sign and order are not unique).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import foldstats as jfs
from repro.core import ridge as jridge
from repro_torch import convert
from repro_torch.core import foldstats as tfs
from repro_torch.core import ridge as tridge

F32 = dict(rtol=1e-4, atol=2e-4)


def _problem(seed, n, p, t, *, y_shift=0.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    W = rng.standard_normal((p, t)).astype(np.float32) / np.sqrt(p)
    Y = (2.0 * X @ W + rng.standard_normal((n, t)) + y_shift
         ).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("n,p,t,k", [(203, 24, 17, 5), (64, 16, 9, 4),
                                     (311, 40, 3, 3)])
def test_foldstats_compute_matches_jax(n, p, t, k):
    X, Y = _problem(n, n, p, t, y_shift=3.0)
    j = jfs.compute(jnp.asarray(X), jnp.asarray(Y), k)
    tt = tfs.compute(torch.from_numpy(X), torch.from_numpy(Y), k)
    assert tfs.fold_bounds(n, k) == jfs.fold_bounds(n, k)
    for field in ("G", "C", "xsum", "ysum", "ysq", "count"):
        got = getattr(tt, field)
        assert got.dtype == torch.float32, field
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j, field)),
                                   rtol=1e-4, atol=5e-4, err_msg=field)
    np.testing.assert_allclose(tt.G_total.numpy(), np.asarray(j.G_total),
                               rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(tt.C_total.numpy(), np.asarray(j.C_total),
                               rtol=1e-4, atol=5e-4)


def test_fold_bounds_match_and_validate():
    for n, k in [(10, 3), (7, 7), (1000, 5), (5, 1)]:
        assert tfs.fold_bounds(n, k) == jfs.fold_bounds(n, k)
    with pytest.raises(ValueError):
        tfs.fold_bounds(3, 4)


def test_carry_across_fold_stats_from_numpy_gives_same_train():
    X, Y = _problem(5, 150, 12, 7)
    j = jfs.compute(jnp.asarray(X), jnp.asarray(Y), 5)
    t = convert.fold_stats_from_numpy(
        *(np.asarray(getattr(j, f)) for f in
          ("G", "C", "xsum", "ysum", "ysq", "count")), device="cpu")
    assert t.n_folds == 5
    for f in range(5):
        jg, jc = j.train(f)
        tg, tc = t.train(f)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **F32)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **F32)


@pytest.mark.parametrize("v,p,t,r", [(40, 12, 9, 11), (17, 30, 5, 4)])
def test_r2_scores_trace_matches_jax(v, p, t, r):
    rng = np.random.default_rng(v * p)
    Bv = rng.standard_normal((v, p)).astype(np.float32)
    A = rng.standard_normal((p, t)).astype(np.float32)
    Yv = (rng.standard_normal((v, t)) + 5.0).astype(np.float32)
    ev = np.abs(rng.standard_normal(p)).astype(np.float32) * 50 + 1
    lams = np.asarray(jridge.PAPER_LAMBDA_GRID[:r], np.float32)
    j = jridge._r2_scores_trace(*(jnp.asarray(a) for a in
                                  (Bv, A, Yv, ev, lams)))
    tt = tridge._r2_scores_trace(*(torch.from_numpy(a) for a in
                                   (Bv, A, Yv, ev, lams)))
    assert tt.shape == (r,)
    np.testing.assert_allclose(tt.numpy(), np.asarray(j), **F32)
    # And the identity itself: equal to scoring the materialised predictions.
    preds = (Bv[None] / (ev[None, None] + lams[:, None, None])) @ A[None]
    direct = tridge._score(torch.from_numpy(Yv), torch.from_numpy(preds),
                           "r2")
    np.testing.assert_allclose(tt.numpy(), direct.numpy(), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("scoring", ["r2", "r"])
def test_fold_scores_r_matches_jax(scoring):
    rng = np.random.default_rng(11)
    Bv = rng.standard_normal((23, 10)).astype(np.float32)
    A = rng.standard_normal((10, 6)).astype(np.float32)
    Yv = rng.standard_normal((23, 6)).astype(np.float32)
    ev = np.linspace(1, 40, 10).astype(np.float32)
    lams = np.asarray(jridge.PAPER_LAMBDA_GRID, np.float32)
    j = jridge._fold_scores(*(jnp.asarray(a) for a in (Bv, A, Yv, ev, lams)),
                            scoring)
    tt = tridge._fold_scores(*(torch.from_numpy(a) for a in
                               (Bv, A, Yv, ev, lams)), scoring)
    np.testing.assert_allclose(tt.numpy(), np.asarray(j), **F32)


CASES = [  # (n, p, t, n_folds): primal (n >= p) and dual (n < p)
    pytest.param(300, 40, 17, 5, id="primal"),
    pytest.param(257, 31, 8, 4, id="primal-ragged"),
    pytest.param(60, 150, 9, 5, id="dual"),
    pytest.param(47, 90, 6, 3, id="dual-ragged"),
]


@pytest.mark.parametrize("scoring", ["r2", "r"])
@pytest.mark.parametrize("n,p,t,k", CASES)
def test_ridge_cv_matches_jax(n, p, t, k, scoring):
    X, Y = _problem(n + p + t, n, p, t)
    jr = jridge.ridge_cv(jnp.asarray(X), jnp.asarray(Y),
                         jridge.RidgeCVConfig(n_folds=k, scoring=scoring))
    tr = tridge.ridge_cv(torch.from_numpy(X), torch.from_numpy(Y),
                         tridge.RidgeCVConfig(n_folds=k, scoring=scoring))
    assert float(tr.best_lambda) == float(jr.best_lambda)
    assert int(tr.best_index) == int(jr.best_index)
    assert tr.weights.shape == (p, t) and tr.weights.dtype == torch.float32
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               **F32)
    np.testing.assert_allclose(tr.cv_scores.numpy(), np.asarray(jr.cv_scores),
                               **F32)


def test_ridge_cv_bf16_inputs_match_jax():
    X, Y = _problem(3, 200, 24, 6)
    jr = jridge.ridge_cv(jnp.asarray(X, jnp.bfloat16),
                         jnp.asarray(Y, jnp.bfloat16), jridge.RidgeCVConfig())
    tr = tridge.ridge_cv(torch.from_numpy(X).bfloat16(),
                         torch.from_numpy(Y).bfloat16(),
                         tridge.RidgeCVConfig())
    assert float(tr.best_lambda) == float(jr.best_lambda)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               rtol=2e-2, atol=2e-2)


def test_predict_and_solve_match_jax():
    X, Y = _problem(9, 80, 20, 5)
    jr = jridge.ridge_cv(jnp.asarray(X), jnp.asarray(Y))
    tr = tridge.ridge_cv(torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(
        tridge.predict(torch.from_numpy(X), tr.weights).numpy(),
        np.asarray(jridge.predict(jnp.asarray(X), jr.weights)), **F32)
    # Dual solve through gram_xty equals the primal solve at the same λ.
    Xt = torch.from_numpy(X[:15])
    Yt = torch.from_numpy(Y[:15])
    ev, P = torch.linalg.eigh(tridge.xxt(Xt))
    Wd = tridge.solve(tridge.RidgeFactors(P, ev, False), Yt,
                      torch.tensor(10.0), X=Xt)
    G = tridge.gram_xty(Xt, Xt)
    Wp = torch.linalg.solve(G + 10.0 * torch.eye(20), tridge.gram_xty(Xt, Yt))
    np.testing.assert_allclose(Wd.numpy(), Wp.numpy(), rtol=1e-3, atol=1e-4)
    assert tridge.PAPER_LAMBDA_GRID == jridge.PAPER_LAMBDA_GRID
    with pytest.raises(ValueError, match="needs X"):
        tridge.solve(tridge.RidgeFactors(P, ev, False), Yt, torch.tensor(1.0))
