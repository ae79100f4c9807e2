"""The port's estimator, dispatch, pipeline and converters against JAX's.

Same numpy inputs to both packages, the port on ``device="cpu"`` (plain
versions), the reference on the JAX CPU backend without the Pallas tier.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scoring as jscoring
from repro.data import fmri as jfmri
from repro.encoding import BrainEncoder as JEncoder
from repro.encoding import EncoderConfig as JConfig
from repro.encoding import dispatch as jdispatch
from repro.encoding import pipeline as jpipeline
from repro.encoding.estimator import EncodingReport as JReport
from repro_torch import convert
from repro_torch.core import scoring as tscoring
from repro_torch.data import fmri as tfmri
from repro_torch.encoding import BrainEncoder as TEncoder
from repro_torch.encoding import EncoderConfig as TConfig
from repro_torch.encoding import dispatch as tdispatch
from repro_torch.encoding import pipeline as tpipeline
from repro_torch.encoding.estimator import EncodingReport as TReport

F32 = dict(rtol=1e-4, atol=2e-4)


def _subject(seed, n, p, t):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    W = rng.standard_normal((p, t)).astype(np.float32) / np.sqrt(p)
    W[:, t // 2:] = 0.0                        # half the targets respond
    tt = np.arange(n)[:, None] * 1.49
    Y = (2.0 * X @ W + rng.standard_normal((n, t))
         + 0.3 * np.sin(2 * np.pi * 0.003 * tt + rng.uniform(0, 6, (1, t)))
         ).astype(np.float32)
    return X, Y


def test_config_keeps_every_reference_field_and_default():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TConfig)}
    assert jf == tf
    assert dataclasses.asdict(TConfig()) == dataclasses.asdict(JConfig())


@pytest.mark.parametrize("scoring", ["r2", "r"])
@pytest.mark.parametrize("n,p,t", [(400, 32, 24), (70, 120, 10)],
                         ids=["primal", "dual"])
def test_encoder_fit_predict_score_evaluate_match_jax(n, p, t, scoring):
    X, Y = _subject(n + p, n, p, t)
    Xte, Yte = _subject(n + p + 1, 120, p, t)
    Xte = Xte[:, :p]
    j = JEncoder(scoring=scoring, n_folds=4).fit(jnp.asarray(X),
                                                  jnp.asarray(Y))
    tenc = TEncoder(device="cpu", scoring=scoring, n_folds=4).fit(X, Y)
    jr, tr = j.report_, tenc.report_
    assert tr.decision.method == jr.decision.method
    assert tr.best_lambda.shape == (1,) and tr.cv_scores.shape == (1, 11)
    np.testing.assert_array_equal(tr.best_lambda, np.asarray(jr.best_lambda))
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               **F32)
    np.testing.assert_allclose(tr.cv_scores, np.asarray(jr.cv_scores), **F32)
    np.testing.assert_allclose(tenc.predict(Xte).numpy(),
                               np.asarray(j.predict(jnp.asarray(Xte))), **F32)
    np.testing.assert_allclose(
        tenc.score(Xte, Yte), j.score(jnp.asarray(Xte), jnp.asarray(Yte)),
        **F32)
    ev = tenc.evaluate(Xte, Yte, n_perms=3,
                       generator=torch.Generator().manual_seed(7))
    jev = j.evaluate(jnp.asarray(Xte), jnp.asarray(Yte), n_perms=3)
    np.testing.assert_allclose(ev.pearson_r, jev.pearson_r, **F32)
    np.testing.assert_allclose(ev.r2, jev.r2, **F32)
    # The null draws the port's own permutations: redo them through JAX.
    g = torch.Generator().manual_seed(7)
    perms = [torch.randperm(Xte.shape[0], generator=g).numpy()
             for _ in range(3)]
    Wj = jnp.asarray(jr.weights)
    want = np.stack([np.asarray(jscoring.pearson_r(
        jnp.asarray(Yte), jnp.asarray(Xte[pm]) @ Wj)) for pm in perms])
    assert ev.null_r.shape == (3, t)
    np.testing.assert_allclose(ev.null_r, want, **F32)
    assert ev.mean_r == pytest.approx(float(ev.pearson_r.mean()))
    assert ev.null_abs_r == pytest.approx(float(np.abs(ev.null_r).mean()))


@pytest.mark.parametrize("n,p,t", [(1000, 64, 30), (50, 400, 12),
                                   (69_202, 16_384, 444), (1000, 16_384, 2000)],
                         ids=["primal", "dual", "parcels", "whole_brain_mor"])
@pytest.mark.parametrize("overrides", [{}, {"method": "dual"},
                                       {"use_pallas": False}, {"n_folds": 3},
                                       {"device_memory_budget": 4 << 30}],
                         ids=["auto", "dual", "off", "k3", "budget"])
def test_dispatch_decisions_match_jax_field_by_field(n, p, t, overrides):
    jd = jdispatch.resolve(JConfig(**overrides), n, p, t, 1)
    td = tdispatch.resolve(TConfig(**overrides), n, p, t, 1, device="cpu")
    for f in dataclasses.fields(jd):
        if f.name != "rationale":
            assert getattr(td, f.name) == getattr(jd, f.name), f.name
    plan = lambda d: d.rationale.split("; kernel tier")[0]  # noqa: E731
    assert plan(td) == plan(jd)
    assert "kernel tier: CUDA OFF" in td.rationale
    if "device_memory_budget" in overrides:
        # Only the parcels rows (4.66 GB resident) exceed the 4 GiB budget.
        assert (td.method == "chunked") is (n == 69_202)
    on_cuda = TConfig(**overrides).resolve_use_pallas("cuda")
    assert on_cuda is (overrides.get("use_pallas") is not False)


def test_report_to_dict_reads_back_in_jax():
    X, Y = _subject(3, 200, 16, 8)
    tenc = TEncoder(device="cpu").fit(X, Y)
    d = json.loads(tenc.report_.to_json())
    jrep = JReport.from_dict(d)
    assert dataclasses.asdict(jrep.decision) == dataclasses.asdict(
        tenc.report_.decision)
    np.testing.assert_array_equal(jrep.best_lambda, tenc.report_.best_lambda)
    np.testing.assert_allclose(jrep.cv_scores, tenc.report_.cv_scores)
    assert d["weights_dtype"] == "float32" and d["weights_shape"] == [16, 8]
    assert d["solver_label"] == "RidgeCV"
    j = JEncoder().fit(jnp.asarray(X), jnp.asarray(Y))
    jd = j.report_.to_dict()
    assert set(jd) == set(d) and jd["weights_dtype"] == d["weights_dtype"]
    back = TReport.from_dict(jd)
    assert back.decision.method == "eigh" and back.weights is None


def test_pipeline_run_stages_matches_jax():
    X, Y = _subject(21, 500, 24, 16)
    Y += 4.0                                    # un-standardized targets
    jst = jpipeline.run_stages(jnp.asarray(X), jnp.asarray(Y), [
        jpipeline.detrend(), jpipeline.standardize(),
        jpipeline.fit(JConfig(n_folds=4))])
    tst = tpipeline.run_stages(X, Y, [
        tpipeline.detrend(), tpipeline.standardize(),
        tpipeline.fit(TConfig(n_folds=4), device="cpu")], device="cpu")
    np.testing.assert_allclose(tst.Y.numpy(), np.asarray(jst.Y), **F32)
    np.testing.assert_allclose(tst.X.numpy(), np.asarray(jst.X), **F32)
    for k in ("mu_x", "sd_x", "mu_y", "sd_y"):
        np.testing.assert_allclose(getattr(tst.standardizer, k).numpy(),
                                   getattr(jst.standardizer, k), **F32)
    np.testing.assert_array_equal(tst.report.best_lambda,
                                  np.asarray(jst.report.best_lambda))
    np.testing.assert_allclose(tst.report.weights.numpy(),
                               np.asarray(jst.report.weights), **F32)
    np.testing.assert_allclose(tst.report.cv_scores,
                               np.asarray(jst.report.cv_scores), **F32)
    assert tst.encoder.standardizer_ is tst.standardizer
    assert set(tst.stage_seconds) == {"detrend", "standardize", "fit"}


def test_detrend_matches_jax():
    rng = np.random.default_rng(2)
    Y = rng.standard_normal((300, 7)).astype(np.float32) + np.linspace(
        0, 3, 300, dtype=np.float32)[:, None]
    got = tfmri.detrend(torch.from_numpy(Y))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jfmri.detrend(jnp.asarray(Y))), **F32)


def test_encoder_from_numpy_predicts_what_jax_predicts():
    X, Y = _subject(8, 300, 20, 12)
    jst = jpipeline.run_stages(jnp.asarray(X), jnp.asarray(Y), [
        jpipeline.standardize(), jpipeline.fit(JConfig())])
    j, rep = jst.encoder, jst.encoder.report_
    std = dataclasses.asdict(j.standardizer_)
    tenc = convert.encoder_from_numpy(
        np.asarray(rep.weights), rep.best_lambda, rep.cv_scores, rep.lambdas,
        dataclasses.asdict(rep.decision), std, device="cpu")
    Xn = np.random.default_rng(9).standard_normal((40, 20)).astype(np.float32)
    Xs = j.standardizer_.apply_x(Xn)
    np.testing.assert_allclose(tenc.predict(Xs).numpy(),
                               np.asarray(j.predict(jnp.asarray(Xs))), **F32)
    np.testing.assert_allclose(
        tenc.standardizer_.apply_x(torch.from_numpy(Xn)).numpy(), Xs, **F32)
    assert tenc.report_.decision == tdispatch.DispatchDecision(
        **dataclasses.asdict(rep.decision))
    np.testing.assert_array_equal(tenc.report_.best_lambda, rep.best_lambda)


def test_generate_follows_the_reference_model():
    spec = tfmri.SubjectSpec(n=800, p=40, t=64)
    X, Y, mask = tfmri.generate(spec, torch.Generator().manual_seed(0),
                                device="cpu")
    assert X.shape == (800, 40) and Y.shape == (800, 64)
    assert X.dtype == Y.dtype == torch.float32
    assert int(mask.sum()) == 16 and bool(mask[:16].all())
    np.testing.assert_allclose(Y.mean(0).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(Y.std(0, correction=0).numpy(), 1.0, atol=1e-4)
    again = tfmri.generate(spec, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again[1], Y)
    with pytest.raises(ValueError, match="generator"):
        tfmri.generate(spec, torch.Generator(), device="meta")


def test_pipeline_run_end_to_end_on_cpu_is_significant():
    X, Y, _ = tfmri.generate(tfmri.SubjectSpec(n=4000, p=48, t=64),
                             torch.Generator().manual_seed(1), device="cpu")
    st = tpipeline.run(X, Y, TConfig(), device="cpu", n_perms=4,
                       test_frac=0.25)
    assert st.report.decision.method == "eigh"
    assert not st.report.decision.use_pallas
    assert st.X.shape[0] == 3000 and st.X_test.shape[0] == 1000
    assert st.evaluation.null_r.shape == (4, 64)
    assert st.evaluation.significant
    assert list(st.stage_seconds) == ["detrend", "split", "standardize",
                                      "fit", "evaluate"]


def test_split_indices_partition_rows_and_repeat_with_seed():
    tr, te = tscoring.train_test_split_indices(
        torch.Generator().manual_seed(0), 101, 0.1)
    assert te.numel() == 10 and tr.numel() == 91
    assert sorted(torch.cat([tr, te]).tolist()) == list(range(101))
    tr2, _ = tscoring.train_test_split_indices(
        torch.Generator().manual_seed(0), 101, 0.1)
    assert torch.equal(tr, tr2)


def test_evaluate_without_split_refuses_in_sample_metrics():
    X, Y = _subject(4, 100, 8, 4)
    with pytest.raises(ValueError, match="on_train"):
        tpipeline.run_stages(X, Y, [tpipeline.fit(device="cpu"),
                                    tpipeline.evaluate()], device="cpu")
    st = tpipeline.run_stages(X, Y, [tpipeline.fit(device="cpu"),
                                     tpipeline.evaluate(on_train=True)],
                              device="cpu")
    assert st.evaluation.pearson_r.shape == (4,)
