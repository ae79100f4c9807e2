"""The port's MOR baseline and banded ridge against JAX's.

Same numpy inputs to both packages, the port on ``device="cpu"`` (plain
versions), the reference on the JAX CPU backend without the Pallas tier.
f32 weights within ``rtol=1e-4, atol=2e-4`` unless noted.  Band
candidates cannot be drawn alike (``jax.random`` against
``torch.Generator``), so the parity tests draw them with the reference's
formula on its key and hand them to the port (``candidates=``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banded as jbanded
from repro.core import complexity as jcx
from repro.core import mor as jmor
from repro.core import ridge as jridge
from repro.encoding import BrainEncoder as JEncoder
from repro.encoding import EncoderConfig as JConfig
from repro.encoding import resolve as jresolve
from repro.serving_encoders.bundle import EncoderBundle as JBundle
from repro_torch.core import banded as tbanded
from repro_torch.core import complexity as tcx
from repro_torch.core import mor as tmor
from repro_torch.core import ridge as tridge
from repro_torch.encoding import BrainEncoder as TEncoder
from repro_torch.encoding import EncoderConfig as TConfig
from repro_torch.encoding import resolve as tresolve

F32 = dict(rtol=1e-4, atol=2e-4)


def _subject(seed, n, p, t):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    W = rng.standard_normal((p, t)).astype(np.float32) / np.sqrt(p)
    W[:, t // 2:] = 0.0                        # half the targets respond
    Y = (2.0 * X @ W + rng.standard_normal((n, t))).astype(np.float32)
    return X, Y


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# complexity
# ---------------------------------------------------------------------------

_COST_CALLS = {
    "t_m_naive": lambda m, w: m.t_m_naive(w),
    "t_bmor_sharded": lambda m, w: m.t_bmor_sharded(w, 2, 4),
    "t_ridge_single": lambda m, w: m.t_ridge_single(w),
    "t_mor": lambda m, w: m.t_mor(w, 4),
    "t_bmor": lambda m, w: m.t_bmor(w, 4),
    "predicted_speedup_bmor": lambda m, w: m.predicted_speedup_bmor(w, 8),
    "mor_overhead_factor": lambda m, w: m.mor_overhead_factor(w, 1),
}


@pytest.mark.parametrize("name", sorted(_COST_CALLS))
def test_complexity_matches_reference(name):
    call = _COST_CALLS[name]
    for key, jw in jcx.PAPER_WORKLOADS.items():
        tw = tcx.PAPER_WORKLOADS[key]
        assert call(tcx, tw) == call(jcx, jw), (name, key)
    w = (3_000, 512, 77)
    assert call(tcx, tcx.RidgeWorkload(*w, r=5, n_folds=3)) == \
        call(jcx, jcx.RidgeWorkload(*w, r=5, n_folds=3))


def test_paper_workloads_match_reference():
    assert tcx.PAPER_P == jcx.PAPER_P
    assert {k: vars(v) for k, v in tcx.PAPER_WORKLOADS.items()} == \
        {k: vars(v) for k, v in jcx.PAPER_WORKLOADS.items()}


# ---------------------------------------------------------------------------
# MOR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p,t", [(240, 24, 9), (60, 90, 7)],
                         ids=["primal", "dual"])
def test_mor_fit_matches_reference(n, p, t):
    X, Y = _subject(n + t, n, p, t)
    jcfg = jridge.RidgeCVConfig(n_folds=4)
    tcfg = tridge.RidgeCVConfig(n_folds=4)
    want = np.asarray(jmor.mor_fit(jnp.asarray(X), jnp.asarray(Y), jcfg))
    got = tmor.mor_fit(_t(X), _t(Y), tcfg)
    assert got.shape == (p, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # λ is chosen per target: each column is the single-target RidgeCV.
    for i in (0, t - 1):
        one = tridge.ridge_cv(_t(X), _t(Y)[:, i:i + 1].contiguous(),
                              tcfg).weights[:, 0]
        assert torch.equal(got[:, i], one)


@pytest.mark.parametrize("n,p,t", [(240, 24, 9), (60, 90, 7)],
                         ids=["primal", "dual"])
def test_mor_fit_taskwise_equals_mor_fit(n, p, t):
    X, Y = _subject(2 * n + t, n, p, t)
    cfg = tridge.RidgeCVConfig(n_folds=3, scoring="r")
    W = tmor.mor_fit(_t(X), _t(Y), cfg)
    assert torch.equal(tmor.mor_fit_taskwise(_t(X), _t(Y), cfg), W)
    want = np.asarray(jmor.mor_fit_taskwise(
        jnp.asarray(X), jnp.asarray(Y),
        jridge.RidgeCVConfig(n_folds=3, scoring="r")))
    np.testing.assert_allclose(W.numpy(), want, **F32)


@pytest.mark.parametrize("taskwise", [False, True], ids=["fused", "taskwise"])
@pytest.mark.parametrize("n,p,t", [(200, 16, 6), (48, 80, 5)],
                         ids=["primal", "dual"])
def test_encoder_mor_matches_reference(n, p, t, taskwise):
    X, Y = _subject(n * 3 + p, n, p, t)
    kw = dict(solver="mor", n_folds=3, mor_taskwise=taskwise)
    j = JEncoder(**kw).fit(jnp.asarray(X), jnp.asarray(Y))
    e = TEncoder(device="cpu", **kw).fit(X, Y)
    rj, rt = j.report_, e.report_
    assert rt.solver_label == rj.solver_label == "MOR"
    assert rt.best_lambda.shape == rj.best_lambda.shape == (0,)
    assert rt.cv_scores.shape == rj.cv_scores.shape
    assert rt.decision.method == rj.decision.method
    np.testing.assert_allclose(e.weights_.numpy(), np.asarray(j.weights_),
                               **F32)


# ---------------------------------------------------------------------------
# banded ridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bands,lams", [((12, 12), (0.5, 40.0)),
                                        ((5, 9, 6), (3.0, 0.02, 900.0))])
def test_solve_banded_matches_reference(bands, lams):
    X, Y = _subject(sum(bands), 90, sum(bands), 5)
    want = np.asarray(jbanded.solve_banded(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(lams, jnp.float32),
        bands))
    got = tbanded.solve_banded(_t(X), _t(Y), torch.tensor(lams), bands)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _reference_candidates(key, cfg: jbanded.BandedConfig) -> np.ndarray:
    """The reference's draw (``banded_ridge_cv``), reproduced on its key."""
    lo, hi = cfg.log_lambda_range
    return np.asarray(10.0 ** jax.random.uniform(
        key, (cfg.n_candidates, len(cfg.bands)), minval=lo, maxval=hi))


@pytest.mark.parametrize("n_folds", [3, 4])
def test_banded_ridge_cv_same_candidates_matches_reference(n_folds):
    n, bands, t = 150, (8, 10), 6
    X, Y = _subject(n_folds, n, sum(bands), t)
    jcfg = jbanded.BandedConfig(bands=bands, n_candidates=6, n_folds=n_folds)
    key = jax.random.PRNGKey(7)
    want = jbanded.banded_ridge_cv(key, jnp.asarray(X), jnp.asarray(Y), jcfg)
    cands = _reference_candidates(key, jcfg)
    np.testing.assert_array_equal(cands, np.asarray(want.candidates))
    tcfg = tbanded.BandedConfig(bands=bands, n_candidates=6, n_folds=n_folds)
    got = tbanded.banded_ridge_cv(None, _t(X), _t(Y), tcfg,
                                  candidates=torch.tensor(cands))
    np.testing.assert_array_equal(got.band_lambdas.numpy(),
                                  np.asarray(want.band_lambdas))
    np.testing.assert_allclose(got.cv_scores.numpy(),
                               np.asarray(want.cv_scores), **F32)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               **F32)


def test_equal_bands_reduce_to_plain_ridge():
    """All bands at the same λ == standard ridge at that λ."""
    X, Y = _subject(0, 80, 24, 6)
    lam = 7.0
    Wb = tbanded.solve_banded(_t(X), _t(Y), torch.tensor([lam, lam]),
                              bands=(12, 12), jitter=0.0)
    f = tridge.factorize(_t(X), tridge.RidgeCVConfig(method="eigh",
                                                     jitter=0.0))
    Wp = tridge.solve(f, tridge.gram_xty(_t(X), _t(Y)), torch.tensor(lam))
    np.testing.assert_allclose(Wb.numpy(), Wp.numpy(), **F32)


def test_banded_matches_closed_form_tikhonov():
    """Against float64 numpy (XᵀX + diag(λ_f))⁻¹XᵀY."""
    X, Y = _subject(1, 60, 10, 3)
    lam_f = np.array([0.5] * 4 + [50.0] * 6)
    X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
    W_ref = np.linalg.solve(X64.T @ X64 + np.diag(lam_f), X64.T @ Y64)
    W = tbanded.solve_banded(_t(X), _t(Y), torch.tensor([0.5, 50.0]),
                             bands=(4, 6), jitter=0.0)
    np.testing.assert_allclose(W.numpy(), W_ref, rtol=1e-4, atol=1e-5)


def test_banded_cv_selects_informative_band():
    """Band 1 carries the signal, band 2 is pure noise → the chosen λ
    shrinks band 2 (feature-space selection, the point of ref [13])."""
    rng = np.random.default_rng(2)
    n, p1, p2, t = 300, 16, 16, 8
    X = rng.standard_normal((n, p1 + p2)).astype(np.float32)
    W1 = rng.standard_normal((p1, t)).astype(np.float32) / np.sqrt(p1)
    Y = (X[:, :p1] @ W1 + 0.1 * rng.standard_normal((n, t))).astype(
        np.float32)
    cfg = tbanded.BandedConfig(bands=(p1, p2), n_candidates=24, n_folds=3)
    res = tbanded.banded_ridge_cv(torch.Generator().manual_seed(3), _t(X),
                                  _t(Y), cfg)
    lam1, lam2 = (float(v) for v in res.band_lambdas)
    assert lam2 > lam1, (lam1, lam2)
    assert float(res.weights[:p1].norm()) > 3 * float(res.weights[p1:].norm())
    lo, hi = cfg.log_lambda_range
    assert res.candidates.shape == (24, 2)
    assert bool(((res.candidates >= 10.0 ** lo)
                 & (res.candidates <= 10.0 ** hi)).all())


def test_banded_draw_is_seeded_and_refuses_bad_inputs():
    X, Y = _subject(3, 40, 6, 2)
    cfg = tbanded.BandedConfig(bands=(3, 3), n_candidates=5)
    a = tbanded.banded_ridge_cv(torch.Generator().manual_seed(1), _t(X),
                                _t(Y), cfg)
    b = tbanded.banded_ridge_cv(torch.Generator().manual_seed(1), _t(X),
                                _t(Y), cfg)
    assert torch.equal(a.candidates, b.candidates)
    assert torch.equal(a.weights, b.weights)
    with pytest.raises(ValueError, match="sum to"):
        tbanded.banded_ridge_cv(None, _t(X), _t(Y),
                                tbanded.BandedConfig(bands=(3, 4)),
                                candidates=torch.ones(2, 2))
    with pytest.raises(ValueError, match="generator or candidates"):
        tbanded.banded_ridge_cv(None, _t(X), _t(Y), cfg)
    with pytest.raises(ValueError, match="candidates of shape"):
        tbanded.banded_ridge_cv(None, _t(X), _t(Y), cfg,
                                candidates=torch.ones(2, 3))
    with pytest.raises(ValueError, match="sum to"):
        TEncoder(bands=(2, 2), device="cpu").fit(X, Y)


def test_encoder_banded_report_and_seeded_draw():
    X, Y = _subject(4, 120, 14, 5)
    kw = dict(bands=(6, 8), n_band_candidates=5, n_folds=3, seed=11)
    e = TEncoder(device="cpu", **kw).fit(X, Y)
    j = JEncoder(**kw).fit(jnp.asarray(X), jnp.asarray(Y))
    rt, rj = e.report_, j.report_
    assert rt.decision.solver == rj.decision.solver == "banded"
    assert rt.solver_label == rj.solver_label == "banded RidgeCV"
    assert rt.lambdas == rj.lambdas == ()
    assert rt.best_lambda.shape == rj.best_lambda.shape == (0,)
    assert rt.cv_scores.shape == rj.cv_scores.shape == (1, 5)
    assert rt.band_lambdas.shape == rj.band_lambdas.shape == (2,)
    # The draw is the port's own, from a CPU generator seeded with seed.
    same = tbanded.banded_ridge_cv(
        torch.Generator().manual_seed(11), _t(X), _t(Y),
        TConfig(**kw).banded_config())
    assert torch.equal(e.weights_, same.weights)
    np.testing.assert_array_equal(rt.band_lambdas, same.band_lambdas.numpy())
    np.testing.assert_array_equal(rt.cv_scores[0], same.cv_scores.numpy())


def test_banded_and_mor_bundles_read_in_both_packages(tmp_path):
    X, Y = _subject(5, 100, 10, 4)
    for name, kw in (("banded", dict(bands=(4, 6), n_band_candidates=3)),
                     ("mor", dict(solver="mor"))):
        e = TEncoder(device="cpu", n_folds=3, **kw).fit(X, Y)
        path = e.save(str(tmp_path / name))
        back = TEncoder.load(path, device="cpu")
        assert torch.equal(back.weights_, e.weights_)
        jb = JBundle.open(path).load_encoder()
        np.testing.assert_array_equal(np.asarray(jb.weights_),
                                      e.weights_.numpy())
        assert jb.report_.solver_label == e.report_.solver_label
        if name == "banded":
            np.testing.assert_array_equal(back.report_.band_lambdas,
                                          e.report_.band_lambdas)
            np.testing.assert_array_equal(jb.report_.band_lambdas,
                                          e.report_.band_lambdas)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _plan(rationale: str) -> str:
    return rationale.split("; kernel tier")[0]


@pytest.mark.parametrize("kw,shape", [
    (dict(solver="mor"), (500, 64, 40)),
    (dict(solver="mor", method="dual"), (500, 64, 40)),
    (dict(solver="mor", target_shards=1), (60, 400, 2000)),
    (dict(bands=(32, 32), n_band_candidates=9), (500, 64, 40)),
    (dict(solver="banded", bands=(16, 8, 40)), (100, 64, 7)),
], ids=["mor-primal", "mor-pinned-dual", "mor-auto-dual", "auto-bands",
        "banded"])
def test_resolve_mor_and_banded_match_reference(kw, shape):
    j = jresolve(JConfig(**kw), *shape, 1)
    t = tresolve(TConfig(**kw), *shape, 1, device="cpu")
    for f in ("solver", "method", "data_shards", "target_shards",
              "predicted_cost", "target_block", "use_pallas"):
        assert getattr(t, f) == getattr(j, f), f
    assert _plan(t.rationale) == _plan(j.rationale)


def test_mor_plan_refusals_match_reference():
    for cfg_kw, match in ((dict(solver="mor", target_shards=2), "range"),
                          (dict(solver="banded"), "requires")):
        with pytest.raises(ValueError, match=match):
            jresolve(JConfig(**cfg_kw), 100, 10, 5, 1)
        with pytest.raises(ValueError, match=match):
            tresolve(TConfig(**cfg_kw), 100, 10, 5, 1, device="cpu")


# ---------------------------------------------------------------------------
# the kernel tier on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_mor_kernel_tier_matches_plain_tier():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel tier launches xty")
    from repro_torch.kernels import gram

    X, Y = _subject(6, 64, 300, 12)
    Xc, Yc = _t(X).cuda(), _t(Y).cuda()
    one = TEncoder(device="cuda", solver="mor", n_folds=4)
    gram.reset_launches()
    tridge.ridge_cv(Xc, Yc[:, :1].contiguous(),
                    one.config.ridge_cv_config("dual", device="cuda"))
    per_target = gram.LAUNCHES["xty"]
    gram.reset_launches()
    kern = one.fit(Xc, Yc).report_
    assert per_target >= 2 and gram.LAUNCHES["xty"] == 12 * per_target
    plain = TEncoder(device="cuda", solver="mor", n_folds=4,
                     use_pallas=False).fit(Xc, Yc).report_
    np.testing.assert_allclose(kern.weights.cpu().numpy(),
                               plain.weights.cpu().numpy(), **F32)
    task = TEncoder(device="cuda", solver="mor", n_folds=4,
                    mor_taskwise=True).fit(Xc, Yc).report_
    assert torch.equal(task.weights, kern.weights)
