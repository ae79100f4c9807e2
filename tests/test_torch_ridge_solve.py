"""The port's multi-λ solve and seed CV path against the JAX package's.

Both packages get the same numpy inputs.  On the CPU the port's
``ops.solve_lambda_grid`` runs its plain version (``kernels.ref``), held
against the Pallas kernel in interpret mode and ``repro.kernels.ref``; the
seed path ``ridge_cv_reference`` is held against the reference's with its
kernel tier on (interpret) and off, and against the port's own downdated
``ridge_cv``.  λ must be equal; eigenvectors are never compared (sign and
order are not unique).  The CUDA kernel is held against the plain version
on a card (``-m cuda``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ridge as jridge
from repro.kernels import ref as jref
from repro.kernels import ridge_solve as jsolve
from repro_torch.core import ridge as tridge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ridge_solve as tsolve

# tests/test_kernels.py::SHAPES_SOLVE: (p, t, r).
SHAPES_SOLVE = [(32, 24, 3), (130, 70, 11), (256, 128, 4)]


def _tol(dtype):
    # As tests/test_kernels.py::_tol: blocked f32 reduction order differs
    # from the one-shot oracle; bf16 operands are rounded first.
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=2e-4)


def _solve_inputs(p, t, r, seed):
    """Orthonormal Q, positive eigenvalues, A and a log-spaced λ grid, as
    the reference's kernel test draws them (here with numpy)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((p, p)))
    evals = np.abs(rng.standard_normal(p)) * 10 + 0.1
    a = rng.standard_normal((p, t))
    lams = np.logspace(-1, 3, r)
    return tuple(v.astype(np.float32) for v in (q, evals, a, lams))


def _layout(q: np.ndarray, layout: str) -> torch.Tensor:
    """``q`` as a row-major tensor, or column-major as ``eigh`` returns it
    (strides (1, p))."""
    if layout == "row":
        return torch.from_numpy(q.copy())
    t = torch.from_numpy(np.ascontiguousarray(q.T)).T
    assert t.stride() == (1, q.shape[0])
    assert q.shape[0] == 1 or not t.is_contiguous()
    return t


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,t,r", SHAPES_SOLVE)
def test_plain_solve_lambda_grid_matches_jax_kernel_and_ref(p, t, r, dtype,
                                                            layout):
    q, evals, a, lams = _solve_inputs(p, t, r, p * t + r)
    jq, ja = jnp.asarray(q, dtype), jnp.asarray(a, dtype)
    tdt = getattr(torch, dtype)
    tq = _layout(q, layout).to(tdt)
    got = tops.solve_lambda_grid(tq, torch.from_numpy(evals),
                                 torch.from_numpy(a).to(tdt),
                                 torch.from_numpy(lams))
    assert got.dtype == torch.float32 and got.shape == (r, p, t)
    jk = jsolve.solve_lambda_grid(jq, jnp.asarray(evals), ja,
                                  jnp.asarray(lams), block_i=128,
                                  block_j=128, block_k=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), **_tol(dtype))
    want = jref.solve_lambda_grid(jq, jnp.asarray(evals), ja,
                                  jnp.asarray(lams))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))


def _problem(seed, n, p, t, noise=0.05):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    W = rng.standard_normal((p, t)).astype(np.float32) / np.sqrt(p)
    Y = (X @ W + noise * rng.standard_normal((n, t))).astype(np.float32)
    return X, Y


# The reference's core-path test (tests/test_kernels.py:136): primal
# (100, 32, 16), and a dual case (n < p).
SOLVE_CASES = [pytest.param(100, 32, 16, id="primal"),
               pytest.param(30, 64, 6, id="dual")]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,p,t", SOLVE_CASES)
def test_ridge_solve_lambda_grid_matches_jax(n, p, t, use_pallas):
    X, Y = _problem(7 + n, n, p, t)
    lams = (0.1, 1.0, 100.0)
    jcfg = jridge.RidgeCVConfig(jitter=0.0, lambdas=lams)
    tcfg = tridge.RidgeCVConfig(jitter=0.0, lambdas=lams)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    tX, tY = torch.from_numpy(X), torch.from_numpy(Y)
    jf, tf = jridge.factorize(jX, jcfg), tridge.factorize(tX, tcfg)
    assert tf.primal == jf.primal == (n >= p)
    jrhs = jridge.gram_xty(jX, jY) if jf.primal else jY
    trhs = tridge.gram_xty(tX, tY) if tf.primal else tY
    want = jridge.solve_lambda_grid(jf, jrhs, lams,
                                    X=None if jf.primal else jX,
                                    use_pallas=use_pallas)
    tsolve.reset_launches()
    got = tridge.solve_lambda_grid(tf, trhs, lams,
                                   X=None if tf.primal else tX,
                                   use_pallas=use_pallas)
    assert tsolve.LAUNCHES["solve_lambda_grid"] == 0   # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (3, p, t)
    # tests/test_kernels.py:155: kernel vs core path within 3e-4.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    # And the kernel route equals the plain route of the port itself.
    plain = tridge.solve_lambda_grid(tf, trhs, lams,
                                     X=None if tf.primal else tX)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,p", [(100, 32), (30, 64)])
def test_factorize_matches_jax(n, p, dtype):
    X, _ = _problem(n * p, n, p, 1)
    jcfg = jridge.RidgeCVConfig(use_pallas=True)     # interpret on the CPU
    tcfg = tridge.RidgeCVConfig()
    jf = jridge.factorize(jnp.asarray(X, dtype), jcfg)
    tf = tridge.factorize(torch.from_numpy(X).to(getattr(torch, dtype)),
                          tcfg)
    assert tf.primal == jf.primal
    tol = dict(rtol=1e-4, atol=2e-4 * float(np.abs(jf.evals).max()))
    np.testing.assert_allclose(tf.evals.numpy(), np.asarray(jf.evals), **tol)
    # The basis reconstructs the jittered Gram (or kernel) matrix.
    Xd = torch.from_numpy(X).to(getattr(torch, dtype)).float()
    G = Xd.T @ Xd if tf.primal else Xd @ Xd.T
    G = G + tcfg.jitter * torch.eye(G.shape[0])
    B = tf.basis
    np.testing.assert_allclose((B * tf.evals) @ B.T, G.numpy(), **tol)


CV_CASES = [pytest.param(160, 24, 12, id="primal"),     # test_foldstats.py:130
            pytest.param(30, 64, 6, id="dual")]


@pytest.mark.parametrize("jax_pallas", [False, True])
@pytest.mark.parametrize("scoring", ["r2", "r"])
@pytest.mark.parametrize("n,p,t", CV_CASES)
def test_ridge_cv_reference_matches_jax(n, p, t, scoring, jax_pallas):
    X, Y = _problem(6 + n, n, p, t)
    j = jridge.ridge_cv_reference(
        jnp.asarray(X), jnp.asarray(Y),
        jridge.RidgeCVConfig(n_folds=4, scoring=scoring,
                             use_pallas=jax_pallas))
    tt = tridge.ridge_cv_reference(
        torch.from_numpy(X), torch.from_numpy(Y),
        tridge.RidgeCVConfig(n_folds=4, scoring=scoring))
    assert float(tt.best_lambda) == float(j.best_lambda)
    assert int(tt.best_index) == int(j.best_index)
    assert tt.weights.shape == (p, t) and tt.weights.dtype == torch.float32
    np.testing.assert_allclose(tt.weights.numpy(), np.asarray(j.weights),
                               **_tol("float32"))
    np.testing.assert_allclose(tt.cv_scores.numpy(), np.asarray(j.cv_scores),
                               **_tol("float32"))


@pytest.mark.parametrize("jax_pallas", [False, True])
def test_ridge_cv_reference_bf16_matches_jax(jax_pallas):
    # tests/test_foldstats.py::test_ridge_cv_parity_bf16's problem.
    X, Y = _problem(7, 150, 16, 8, noise=0.5)
    j = jridge.ridge_cv_reference(
        jnp.asarray(X, jnp.bfloat16), jnp.asarray(Y, jnp.bfloat16),
        jridge.RidgeCVConfig(n_folds=3, use_pallas=jax_pallas))
    tt = tridge.ridge_cv_reference(
        torch.from_numpy(X).bfloat16(), torch.from_numpy(Y).bfloat16(),
        tridge.RidgeCVConfig(n_folds=3))
    assert float(tt.best_lambda) == float(j.best_lambda)
    assert int(tt.best_index) == int(j.best_index)
    np.testing.assert_allclose(tt.weights.numpy(), np.asarray(j.weights),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(tt.cv_scores.numpy(), np.asarray(j.cv_scores),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("scoring", ["r2", "r"])
@pytest.mark.parametrize("n,p,t", CV_CASES)
def test_ridge_cv_reference_matches_port_ridge_cv(n, p, t, scoring):
    """The port's seed path against its downdated path, at the reference's
    parity tolerances (tests/test_foldstats.py:139-144)."""
    X, Y = _problem(6 + n, n, p, t)
    cfg = tridge.RidgeCVConfig(n_folds=4, scoring=scoring)
    new = tridge.ridge_cv(torch.from_numpy(X), torch.from_numpy(Y), cfg)
    ref = tridge.ridge_cv_reference(torch.from_numpy(X), torch.from_numpy(Y),
                                    cfg)
    assert float(new.best_lambda) == float(ref.best_lambda)
    np.testing.assert_allclose(new.cv_scores.numpy(), ref.cv_scores.numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(new.weights.numpy(), ref.weights.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_ridge_cv_reference_matches_port_ridge_cv_bf16():
    X, Y = _problem(7, 150, 16, 8, noise=0.5)
    Xb, Yb = torch.from_numpy(X).bfloat16(), torch.from_numpy(Y).bfloat16()
    cfg = tridge.RidgeCVConfig(n_folds=3)
    new = tridge.ridge_cv(Xb, Yb, cfg)
    ref = tridge.ridge_cv_reference(Xb, Yb, cfg)
    assert float(new.best_lambda) == float(ref.best_lambda)
    np.testing.assert_allclose(new.weights.numpy(), ref.weights.numpy(),
                               rtol=5e-2, atol=5e-2)


def test_ridge_cv_reference_use_pallas_on_cpu_raises():
    X = torch.zeros(8, 3)
    cfg = tridge.RidgeCVConfig(n_folds=2, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA"):
        tridge.ridge_cv_reference(X, X, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        tridge.ridge_cv(X, X, cfg)


def test_solve_wrapper_refuses_cpu_tensors_and_ops_route_cpu_to_plain():
    q, evals, a, lams = (torch.from_numpy(v) for v in
                         _solve_inputs(8, 5, 2, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tsolve.solve_lambda_grid(q, evals, a, lams)
    tsolve.reset_launches()
    got = tops.solve_lambda_grid(q, evals, a, lams)
    assert tsolve.LAUNCHES == {"solve_lambda_grid": 0}
    np.testing.assert_array_equal(got.numpy(),
                                  tref.solve_lambda_grid(q, evals, a,
                                                         lams).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_solve_lambda_grid_matches_plain_version(dtype):
    """The split-bf16 tensor-core kernel against the plain version, Q row-
    and column-major: the reference's shapes, edge sizes and p, t that are
    multiples of no tile (128 × 192 × 32), repeated launches bitwise
    equal, and the non-finite rule for an Inf and a NaN in A."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tdt = getattr(torch, dtype)
    tsolve.reset_launches()
    shapes = SHAPES_SOLVE + [(1, 1, 1), (257, 3, 2), (161, 445, 3)]
    for p, t, r in shapes:
        q, evals, a, lams = _solve_inputs(p, t, r, p + t + r)
        ev, lm = (torch.from_numpy(v).cuda() for v in (evals, lams))
        ta = torch.from_numpy(a).cuda().to(tdt)
        for layout in ("row", "col"):
            tq = _layout(q, layout).cuda().to(tdt)
            if layout == "col":
                tq = tq.T.contiguous().T
            got = tsolve.solve_lambda_grid(tq, ev, ta, lm)
            want = tref.solve_lambda_grid(tq, ev, ta, lm)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 *
                                       want.abs().max().item())
            assert torch.equal(got, tsolve.solve_lambda_grid(tq, ev, ta, lm))
    assert tsolve.LAUNCHES["solve_lambda_grid"] == 4 * len(shapes)
    q, evals, a, lams = (torch.from_numpy(v).cuda()
                         for v in _solve_inputs(130, 70, 4, 9))
    a[3, 5] = float("inf")
    a[7, 1] = float("nan")
    q, a = q.T.contiguous().T.to(tdt), a.to(tdt)
    got = tsolve.solve_lambda_grid(q, evals, a, lams)
    want = tref.solve_lambda_grid(q, evals, a, lams)
    assert torch.isnan(want).any()
    assert torch.isnan(got[torch.isnan(want)]).all()
    assert not torch.isfinite(got[torch.isinf(want)]).any()
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4,
                               atol=1e-4 * want[fin].abs().max().item())
