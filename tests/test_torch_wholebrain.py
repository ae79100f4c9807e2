"""The port's whole-brain column-blocked tier against the JAX package's.

Same numpy inputs and the same ``RunStore`` directories (written by the
reference's store, f32 or bf16-as-u16) for both packages; the port on
``device="cpu"`` (plain versions), the reference on the JAX CPU backend,
its plain tier.  λ must be equal; W and the CV curves agree within the
tolerance of ``tests/test_kernels.py::_tol`` — not bitwise, because the
reference's own bitwise tests fail on this tree (ROADMAP queue 3).
The port's telemetry adds ``scratch_io_s`` (``PORT_ONLY_TELEMETRY``, the
host seconds of the ``Â`` scratch's spans), which the reference lacks:
the key sets compared with the reference's set it aside by name.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.encoding import EncoderConfig as JConfig
from repro.encoding import BrainEncoder as JEncoder
from repro.encoding import dispatch as jdispatch
from repro.wholebrain import ColumnBlockAccumulator as JAccumulator
from repro.wholebrain import column_blocks as jcolumn_blocks
from repro.wholebrain import fit_wholebrain as jfit
from repro_torch import obs
from repro_torch.core import foldstats, ridge
from repro_torch.data.store import RunStore
from repro_torch.encoding import BrainEncoder, EncoderConfig, dispatch
from repro_torch.resilience import FitJournal, JournalError
from repro_torch.wholebrain import (
    ColumnBlockAccumulator, colblock_update_compile_count, column_blocks,
    fit_wholebrain,
)
from repro_torch.wholebrain import solver

F32 = dict(rtol=1e-4, atol=2e-4)
TELEMETRY = {"chunks", "bytes_staged", "read_stall_s", "compute_stall_s",
             "n_blocks", "t_block", "t_pad", "eighs", "gram_compile_delta",
             "colblock_compile_delta", "scratch_bytes", "row_passes_x",
             "row_passes_y", "x_cache_bytes", "use_pallas", "resumed",
             "blocks_replayed", "blocks_streamed"}
PORT_ONLY_TELEMETRY = {"scratch_io_s"}
SCRATCH_SPANS = {"wholebrain.scratch_write", "wholebrain.scratch_flush",
                 "wholebrain.scratch_read", "wholebrain.scratch_free"}


def _tol(dtype):
    # As tests/test_kernels.py::_tol: blocked f32 reduction order differs.
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else F32


def _problem(seed, n, p, t, dtype="float32"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = rng.normal(size=(p, t)).astype(np.float32) / np.sqrt(p)
    Y = (X @ W + 0.05 * rng.normal(size=(n, t))).astype(np.float32)
    if dtype == "bfloat16":
        X = np.asarray(jnp.asarray(X, jnp.bfloat16))
        Y = np.asarray(jnp.asarray(Y, jnp.bfloat16))
    return X, Y


def _stores(make_run_store, X, Y, n_folds, n_runs=2):
    """One store directory, opened by the reference and by the port."""
    jstore = make_run_store(X, Y, n_runs=n_runs, n_folds=n_folds)
    return jstore, RunStore.open(jstore.root)


def _unblocked(store, cfg):
    """The port's unblocked statistics solve on the same store."""
    stats = foldstats.compute_chunked(
        store.iter_chunks(cfg.chunk_rows), store.shape[0], cfg.n_folds,
        chunk_rows=cfg.chunk_rows, device="cpu")
    return stats, ridge.ridge_cv_from_stats(
        stats, cfg.ridge_cv_config("eigh", device="cpu"))


# ---------------------------------------------------------------------------
# Column blocks and the block accumulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,t_block", [(10, 4), (8, 4), (5, 99), (1, 1),
                                       (23, 2), (264_805, 16_384)])
def test_column_blocks_match_reference(t, t_block):
    assert column_blocks(t, t_block) == jcolumn_blocks(t, t_block)


def test_column_blocks_errors():
    assert column_blocks(10, 4) == [(0, 4), (4, 8), (8, 10)]
    with pytest.raises(ValueError, match="t_block"):
        column_blocks(10, 1)
    with pytest.raises(ValueError, match="t >= 1"):
        column_blocks(0, 4)
    with pytest.raises(ValueError, match="t_pad"):
        ColumnBlockAccumulator(10, 2, 0, device="cpu")


@pytest.mark.parametrize("lo,hi,t_pad", [(4, 9, 5), (8, 11, 5)])
def test_colblock_accumulator_matches_unblocked_and_reference(
        make_run_store, lo, hi, t_pad):
    """A (ragged, zero-padded) column window grafted onto the X-only pass:
    its C/ysum/ysq/count equal the port's unblocked accumulator's columns
    and the reference's block accumulator; padded columns are exact 0."""
    X, Y = _problem(5, 48, 5, 11)
    jstore, store = _stores(make_run_store, X, Y, n_folds=3)
    full = foldstats.compute_chunked(store.iter_chunks(16), 48, 3,
                                     chunk_rows=16, device="cpu")
    acc = ColumnBlockAccumulator(48, 3, t_pad, chunk_rows=16, device="cpu")
    for Xc, Yc in store.iter_chunks(16, col_range=(lo, hi)):
        acc.update(Xc, Yc)
    b = acc.finalize()
    jacc = JAccumulator(48, 3, t_pad, chunk_rows=16)
    for Xc, Yc in jstore.iter_chunks(16, col_range=(lo, hi)):
        jacc.update(Xc, Yc)
    jb = jacc.finalize()
    w = hi - lo
    for name in ("C", "ysum", "ysq"):
        got = getattr(b, name).numpy()
        np.testing.assert_allclose(got[..., :w],
                                   getattr(full, name).numpy()[..., lo:hi],
                                   **F32, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(getattr(jb, name)),
                                   **F32, err_msg=name)
        assert not got[..., w:].any(), name
    np.testing.assert_array_equal(b.count.numpy(), full.count.numpy())
    np.testing.assert_array_equal(b.C_total.numpy(), b.C.sum(0).numpy())
    with pytest.raises(ValueError, match="t_pad"):
        ColumnBlockAccumulator(48, 3, 2, device="cpu").update(X[:4], Y[:4])


# ---------------------------------------------------------------------------
# fit_wholebrain against the reference
# ---------------------------------------------------------------------------

# t=23: t_block 23 → one block; 8 → ragged tail (8, 8, 7); 4 → many
# blocks; 2 → the minimum legal width.  Chunks of 17 rows straddle folds.
@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
@pytest.mark.parametrize("t_block", [23, 8, 4, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_wholebrain_matches_reference(make_run_store, lambda_mode,
                                          t_block, dtype):
    X, Y = _problem(0, 96, 7, 23, dtype)
    jstore, store = _stores(make_run_store, X, Y, n_folds=5)
    jres = jfit(jstore, JConfig(chunk_rows=17), t_block=t_block,
                lambda_mode=lambda_mode)
    res = fit_wholebrain(store, EncoderConfig(chunk_rows=17),
                         t_block=t_block, lambda_mode=lambda_mode,
                         device="cpu")
    np.testing.assert_array_equal(res.best_lambda, jres.best_lambda)
    np.testing.assert_allclose(res.weights, jres.weights, **_tol(dtype))
    np.testing.assert_allclose(res.cv_scores, jres.cv_scores, **_tol(dtype))
    np.testing.assert_array_equal(res.lambda_by_target,
                                  jres.lambda_by_target)
    assert res.block_bounds == jres.block_bounds
    assert set(res.telemetry) - PORT_ONLY_TELEMETRY == set(jres.telemetry) \
        == TELEMETRY
    assert PORT_ONLY_TELEMETRY <= set(res.telemetry)
    assert (res.telemetry["scratch_io_s"] > 0) == (lambda_mode == "global")
    for key in ("n_blocks", "t_pad", "eighs", "row_passes_x",
                "x_cache_bytes", "scratch_bytes", "chunks", "bytes_staged"):
        assert res.telemetry[key] == jres.telemetry[key], key


def test_fit_wholebrain_fold_misaligned_matches_reference_and_unblocked(
        make_run_store):
    """Chunk straddles folds AND the tail block is ragged: n=97 (folds of
    20/20/19/19/19), chunks of 13, blocks of 9 over t=21."""
    X, Y = _problem(1, 97, 6, 21)
    jstore, store = _stores(make_run_store, X, Y, n_folds=5, n_runs=3)
    cfg = EncoderConfig(chunk_rows=13)
    res = fit_wholebrain(store, cfg, t_block=9, device="cpu")
    jres = jfit(jstore, JConfig(chunk_rows=13), t_block=9)
    _, un = _unblocked(store, cfg)
    assert res.block_bounds == [(0, 9), (9, 18), (18, 21)]
    for want_lam, want_w in ((jres.best_lambda[0], jres.weights),
                             (float(un.best_lambda), un.weights.numpy())):
        assert float(res.best_lambda[0]) == float(want_lam)
        np.testing.assert_allclose(res.weights, want_w, **F32)
    np.testing.assert_allclose(res.cv_scores[0], un.cv_scores.numpy(), **F32)


def test_per_block_matches_restricted_stats(make_run_store):
    """Each block's λ/W equals ridge_cv_from_stats on the column-restricted
    statistics — one λ per target batch, streamed."""
    X, Y = _problem(2, 96, 6, 13)
    _, store = _stores(make_run_store, X, Y, n_folds=4)
    cfg = EncoderConfig(n_folds=4, chunk_rows=32)
    stats, _ = _unblocked(store, cfg)
    res = fit_wholebrain(store, cfg, t_block=5, lambda_mode="per_block",
                         device="cpu")
    assert res.best_lambda.shape == (3,)
    assert res.cv_scores.shape == (3, len(cfg.lambdas))
    for b, (lo, hi) in enumerate(res.block_bounds):
        sub = foldstats.FoldStats(
            G=stats.G, C=stats.C[:, :, lo:hi], xsum=stats.xsum,
            ysum=stats.ysum[:, lo:hi], ysq=stats.ysq[:, lo:hi],
            count=stats.count)
        rr = ridge.ridge_cv_from_stats(
            sub, cfg.ridge_cv_config("eigh", device="cpu"))
        assert res.best_lambda[b] == float(rr.best_lambda)
        np.testing.assert_allclose(res.weights[:, lo:hi], rr.weights.numpy(),
                                   **F32)
        np.testing.assert_allclose(res.cv_scores[b], rr.cv_scores.numpy(),
                                   **F32)
        assert (res.lambda_by_target[lo:hi] == res.best_lambda[b]).all()


def test_hoisted_scores_equal_unhoisted(make_run_store):
    """The solver's per-fold scores with the X-only terms computed once
    (``eigenbasis_x_terms``) equal ``validation_scores_per_target`` on the
    grafted statistics, bitwise."""
    X, Y = _problem(3, 64, 6, 10)
    _, store = _stores(make_run_store, X, Y, n_folds=4)
    g = foldstats.compute_chunked(
        ((Xc, Yc[:, :0]) for Xc, Yc in store.iter_chunks(16)), 64, 4,
        chunk_rows=16, device="cpu")
    acc = ColumnBlockAccumulator(64, 4, 6, chunk_rows=16, device="cpu")
    for Xc, Yc in store.iter_chunks(16, col_range=(4, 10)):
        acc.update(Xc, Yc)
    b = acc.finalize()
    full = foldstats.FoldStats(G=g.G, C=b.C, xsum=g.xsum, ysum=b.ysum,
                               ysq=b.ysq, count=g.count)
    lams = torch.tensor(EncoderConfig().lambdas)
    for scoring in ("r2", "r"):
        for f in range(4):
            G_tr, C_tr = full.train(f)
            evals, Q = torch.linalg.eigh(G_tr + 1e-6 * torch.eye(6))
            want = foldstats.validation_scores_per_target(
                full, f, Q, evals, C_tr, lams, scoring)
            u, Ghat = foldstats.eigenbasis_x_terms(g.xsum[f], g.G[f],
                                                   g.count[f], Q)
            got = foldstats.validation_scores_from_terms(
                b.C[f], b.ysum[f], b.ysq[f], g.count[f], Q, evals,
                b.C_total - b.C[f], lams, scoring, u, Ghat)
            assert torch.equal(got, want), (scoring, f)


def test_spill_path_and_telemetry(make_run_store):
    """A budget too small for the X cache re-streams X once per block:
    λ and W bitwise equal to the cached run."""
    X, Y = _problem(4, 80, 6, 18)
    jstore, store = _stores(make_run_store, X, Y, n_folds=5)
    cached = fit_wholebrain(store, EncoderConfig(chunk_rows=32), t_block=7,
                            device="cpu")
    spill_cfg = EncoderConfig(chunk_rows=32, device_memory_budget=1)
    spilled = fit_wholebrain(store, spill_cfg, t_block=7, device="cpu")
    jspilled = jfit(jstore, JConfig(chunk_rows=32, device_memory_budget=1),
                    t_block=7)
    assert cached.telemetry["row_passes_x"] == 1
    assert cached.telemetry["x_cache_bytes"] == 80 * 6 * 4
    assert spilled.telemetry["row_passes_x"] == 3 == \
        jspilled.telemetry["row_passes_x"]
    assert spilled.telemetry["x_cache_bytes"] == 0
    np.testing.assert_array_equal(spilled.best_lambda, cached.best_lambda)
    np.testing.assert_array_equal(spilled.weights, cached.weights)
    t = spilled.telemetry
    assert (t["n_blocks"], t["t_pad"], t["eighs"], t["row_passes_y"]) == \
        (3, 7, 6, 1)
    assert t["scratch_bytes"] == 6 * 18 * 4 and t["use_pallas"] is False
    assert t["blocks_streamed"] == 3 and t["resumed"] is False


@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
def test_scratch_io_s_is_the_scratch_spans_seconds(make_run_store,
                                                   lambda_mode):
    """``scratch_io_s`` is the sum of the fit's four ``wholebrain.scratch_*``
    spans, the same measurement; 0.0 per block, which has no scratch."""
    X, Y = _problem(8, 60, 5, 24)
    _, store = _stores(make_run_store, X, Y, n_folds=3)
    tracer = obs.install()
    try:
        res = fit_wholebrain(store, EncoderConfig(n_folds=3, chunk_rows=21),
                             t_block=12, lambda_mode=lambda_mode,
                             device="cpu")
    finally:
        obs.uninstall()
    spans = [e for e in tracer.events() if e["name"] in SCRATCH_SPANS]
    io_s = res.telemetry["scratch_io_s"]
    assert isinstance(io_s, float)
    if lambda_mode == "per_block":
        assert io_s == 0.0 and spans == []
        return
    assert {e["name"] for e in spans} == SCRATCH_SPANS
    assert io_s > 0
    assert io_s == pytest.approx(sum(e["dur_us"] for e in spans) / 1e6,
                                 abs=1e-5)


def test_signature_counts_one_fresh_zero_repeat(make_run_store):
    X, Y = _problem(6, 64, 5, 24)
    _, store = _stores(make_run_store, X, Y, n_folds=4)
    cfg = EncoderConfig(n_folds=4, chunk_rows=19)        # a fresh shape
    c0 = colblock_update_compile_count()
    res = fit_wholebrain(store, cfg, t_block=6, device="cpu")
    assert res.telemetry["colblock_compile_delta"] == 1
    assert res.telemetry["gram_compile_delta"] == 1
    assert colblock_update_compile_count() == c0 + 1
    res2 = fit_wholebrain(store, cfg, t_block=6, device="cpu")
    assert res2.telemetry["colblock_compile_delta"] == 0
    assert res2.telemetry["gram_compile_delta"] == 0


def test_fit_wholebrain_validation(make_run_store, tmp_path):
    X, Y = _problem(4, 40, 4, 6)
    _, store = _stores(make_run_store, X, Y, n_folds=3)
    cfg = EncoderConfig(n_folds=3)
    with pytest.raises(ValueError, match="t_block"):
        fit_wholebrain(store, cfg, device="cpu")
    with pytest.raises(ValueError, match="lambda_mode"):
        fit_wholebrain(store, cfg, t_block=3, lambda_mode="nope",
                       device="cpu")
    with pytest.raises(ValueError, match="n_folds"):
        fit_wholebrain(store, EncoderConfig(n_folds=5), t_block=3,
                       device="cpu")
    with pytest.raises(ValueError, match="ridge solver"):
        fit_wholebrain(store, EncoderConfig(n_folds=3, solver="bmor"),
                       t_block=3, device="cpu")
    with pytest.raises(ValueError, match="primal"):
        fit_wholebrain(store, EncoderConfig(n_folds=3, method="dual"),
                       t_block=3, device="cpu")
    # A journal another fit configuration wrote is refused, not resumed.
    FitJournal.attach(str(tmp_path / "journal"), {"n": 0})
    with pytest.raises(JournalError, match="different fit"):
        fit_wholebrain(store, cfg, t_block=3,
                       journal=str(tmp_path / "journal"), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fit_wholebrain(store, EncoderConfig(n_folds=3, use_pallas=True),
                       t_block=3, device="cpu")
    # The row tier's un-standardized-target refusal, per block.
    _, store2 = _stores(make_run_store, X, Y + 500.0, n_folds=3)
    with pytest.raises(ValueError, match="mean/std"):
        fit_wholebrain(store2, cfg, t_block=3, device="cpu")
    sig = solver.journal_signature(store, cfg, t_block=3, device="cpu")
    assert sig["use_pallas"] is False and sig["t_block"] == 3
    assert (sig["n"], sig["p"], sig["t"], sig["k"]) == (40, 4, 6, 3)


# ---------------------------------------------------------------------------
# Dispatch and the estimator route
# ---------------------------------------------------------------------------

_GRID = list(itertools.product(
    (None, 1, 10**6, 10**8, 64 << 30),                  # budget
    ((10_000, 64, 4_096), (100, 8, 16), (100_000, 64, 8),
     (10_000, 16_384, 264_805), (69_202, 16_384, 444)),  # n, p, t
    (None, 4, 16_384)))                                  # target_block


@pytest.mark.parametrize("budget,shape,target_block", _GRID)
def test_colblocked_decision_matches_reference(budget, shape, target_block):
    n, p, t = shape
    kw = dict(device_memory_budget=budget, target_block=target_block)
    try:
        want = jdispatch.resolve(JConfig(**kw), n, p, t, 1)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            dispatch.resolve(EncoderConfig(**kw), n, p, t, 1, device="cpu")
        return
    got = dispatch.resolve(EncoderConfig(**kw), n, p, t, 1, device="cpu")
    for field in ("solver", "method", "data_shards", "target_shards",
                  "target_block", "predicted_cost"):
        assert getattr(got, field) == getattr(want, field), field
    # Same plan rationale; only the kernel-tier clause names other kernels.
    assert got.rationale.split("; kernel tier")[0] == \
        want.rationale.split("; kernel tier")[0]
    if budget is not None:
        assert dispatch.pick_target_block(budget, 5, p, t) == \
            jdispatch.pick_target_block(budget, 5, p, t)


def test_whole_brain_plan_at_the_card_budget():
    """The card phase's plan: colblocked with the pinned block width; the
    reference's own width at 64 GiB prices only k·p·(p + t_block)."""
    n, p, t = 10_000, 16_384, 264_805
    d = dispatch.resolve(EncoderConfig(device_memory_budget=64 << 30,
                                       target_block=16_384), n, p, t, 1,
                         device="cpu")
    assert (d.method, d.target_block) == ("colblocked", 16_384)
    assert "17 block(s) of t_block=16384" in d.rationale
    assert 80_000 < dispatch.pick_target_block(64 << 30, 5, p, t) < 100_000


def test_estimator_routes_colblocked_like_reference(make_run_store):
    X, Y = _problem(6, 80, 6, 18)
    jstore, store = _stores(make_run_store, X, Y, n_folds=5)
    kw = dict(n_folds=5, chunk_rows=32, device_memory_budget=1,
              target_block=7)
    enc = BrainEncoder(EncoderConfig(**kw), device="cpu").fit(store=store)
    jenc = JEncoder(JConfig(**kw)).fit(store=jstore)
    rep, jrep = enc.report_, jenc.report_
    assert rep.decision.method == jrep.decision.method == "colblocked"
    assert rep.decision.target_block == 7
    assert isinstance(rep.weights, torch.Tensor)
    assert rep.weights.device.type == "cpu"
    np.testing.assert_array_equal(rep.best_lambda, jrep.best_lambda)
    np.testing.assert_allclose(rep.weights.numpy(), np.asarray(jrep.weights),
                               **F32)
    np.testing.assert_allclose(rep.cv_scores, jrep.cv_scores, **F32)
    assert set(enc.stream_stats_) - PORT_ONLY_TELEMETRY \
        == set(jenc.stream_stats_)
    assert enc.stream_stats_["scratch_io_s"] > 0
    assert enc.stream_stats_["n_blocks"] == 3
    assert enc.stream_stats_["compile_count"] <= 1
    # The unblocked chunked route on the same store agrees.
    ch = BrainEncoder(EncoderConfig(
        n_folds=5, chunk_rows=32,
        device_memory_budget=dispatch.chunked_stats_bytes(5, 6, 18) * 2),
        device="cpu").fit(store=store)
    assert ch.report_.decision.method == "chunked"
    assert ch.report_.best_lambda == rep.best_lambda
    np.testing.assert_allclose(ch.weights_.numpy(), rep.weights.numpy(),
                               **F32)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
def test_cuda_kernel_tier_fit_matches_plain_tier(tmp_path, lambda_mode):
    """fit_wholebrain on the card with the CUDA ``xty_folds_masked``
    (kernel tier) against the plain tier on the same store (written by
    the port's store alone: the card's host may have another numpy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import gram

    X, Y = _problem(7, 600, 160, 300)
    store = RunStore.create(str(tmp_path / "store"), n_folds=5)
    for i, lo in enumerate(range(0, 600, 200)):
        store.write(X[lo:lo + 200], Y[lo:lo + 200], f"run-{i}")
    store = RunStore.open(str(tmp_path / "store"))
    gram.reset_launches()
    kern = fit_wholebrain(store, EncoderConfig(chunk_rows=128), t_block=128,
                          lambda_mode=lambda_mode, device="cuda")
    # 5 chunks × (the X-only pass + 3 blocks).
    assert gram.LAUNCHES["xty_folds_masked"] == 5 * 4
    assert kern.telemetry["use_pallas"] is True
    plain = fit_wholebrain(store, EncoderConfig(chunk_rows=128,
                                                use_pallas=False),
                           t_block=128, lambda_mode=lambda_mode,
                           device="cuda")
    np.testing.assert_array_equal(kern.best_lambda, plain.best_lambda)
    np.testing.assert_allclose(kern.weights, plain.weights, **F32)
    np.testing.assert_allclose(kern.cv_scores, plain.cv_scores, **F32)
