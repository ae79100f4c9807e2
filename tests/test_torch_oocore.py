"""The port's streamed fit against the JAX package's.

Same numpy inputs (and the same store directories) for both packages; the
port on ``device="cpu"`` (plain versions), the reference on the JAX CPU
backend, its Pallas ``xty_folds_masked`` kernel in interpret mode.  λ must
be equal; statistics, W and CV curves agree within the f32 tolerance of
``tests/test_kernels.py::_tol`` unless a test states its own reason.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import foldstats as jfs
from repro.core import ridge as jridge
from repro.data.store import RunStore as JStore
from repro.encoding import BrainEncoder as JEncoder
from repro.encoding import EncoderConfig as JConfig
from repro.encoding import pipeline as jpipeline
from repro.kernels import gram as jgram
from repro_torch import convert
from repro_torch.core import foldstats as tfs
from repro_torch.core import ridge as tridge
from repro_torch.data.store import RunStore
from repro_torch.encoding import BrainEncoder as TEncoder
from repro_torch.encoding import EncoderConfig as TConfig
from repro_torch.encoding import pipeline as tpipeline
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32 = dict(rtol=1e-4, atol=2e-4)
FIELDS = ("G", "C", "xsum", "ysum", "ysq", "count")


def _tol(dtype):
    # As tests/test_kernels.py::_tol: blocked f32 reduction order differs.
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else F32


def _problem(seed, n, p, t, noise=0.05, y_offset=0.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = rng.normal(size=(p, t)).astype(np.float32) / np.sqrt(p)
    Y = (X @ W + noise * rng.normal(size=(n, t)) + y_offset).astype(
        np.float32)
    return X, Y


def _stream(X, Y, lo, hi, chunk):
    for pos in range(lo, hi, chunk):
        yield X[pos:min(pos + chunk, hi)], Y[pos:min(pos + chunk, hi)]


def _oracle(X, Y, n_folds):
    """Float64 per-fold statistics, computed directly."""
    X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
    out = {k: [] for k in FIELDS}
    for lo, hi in jfs.fold_bounds(len(X64), n_folds):
        Xf, Yf = X64[lo:hi], Y64[lo:hi]
        for k, v in (("G", Xf.T @ Xf), ("C", Xf.T @ Yf),
                     ("xsum", Xf.sum(0)), ("ysum", Yf.sum(0)),
                     ("ysq", ((Yf - Yf.mean(0)) ** 2).sum(0)),
                     ("count", float(hi - lo))):
            out[k].append(v)
    return {k: np.stack(v) if k != "count" else np.asarray(v)
            for k, v in out.items()}


def _jax_stats_np(stats):
    return [np.asarray(getattr(stats, f)) for f in FIELDS]


# ---------------------------------------------------------------------------
# The kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,p,q,s", [(24, 16, 8, 3), (37, 5, 12, 4),
                                     (64, 32, 32, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xty_folds_masked_matches_pallas_interpret(m, p, q, s, dtype):
    """Random, non-contiguous slots, as tests/test_kernels.py feeds them."""
    rng = np.random.default_rng(m + p + q + s)
    x = rng.standard_normal((m, p)).astype(np.float32)
    z = rng.standard_normal((m, q)).astype(np.float32)
    slots = np.random.default_rng(s).integers(0, s, size=m)
    onehot = np.eye(s, dtype=np.float32)[slots]
    jx, jz = jnp.asarray(x, dtype), jnp.asarray(z, dtype)
    tdt = getattr(torch, dtype)
    tx, tz = torch.from_numpy(x).to(tdt), torch.from_numpy(z).to(tdt)
    got = tops.xty_folds_masked(tx, tz, torch.from_numpy(onehot).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (s, p, q)
    want = jgram.xty_folds_masked(jx, jz, jnp.asarray(onehot), block_n=8,
                                  block_p=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))
    x64, z64 = np.asarray(jx, np.float64), np.asarray(jz, np.float64)
    oracle = np.einsum("ms,mp,mq->spq", onehot.astype(np.float64), x64, z64)
    np.testing.assert_allclose(got.numpy(), oracle, **_tol(dtype))


def test_masked_plain_version_takes_any_weights_and_never_launches():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((40, 6)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((40, 9)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 2, (40, 3)).astype(np.float32))
    w[:, 2] = 0.0                                 # an all-zero slot
    tgram.reset_launches()
    got = tops.xty_folds_masked(x, z, w)
    assert sum(tgram.LAUNCHES.values()) == 0
    want = np.einsum("ms,mp,mq->spq", w.double().numpy(),
                     x.double().numpy(), z.double().numpy())
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert not got[2].any()
    # NaN rows stay NaN under a zero weight, as in the reference.
    x[0, 0] = float("nan")
    assert torch.isnan(tref.xty_folds_masked(x, z, w)[2, 0]).all()
    with pytest.raises(ValueError, match="CUDA"):
        tgram.xty_folds_masked(x, z, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_xty_folds_masked_matches_plain_version(dtype):
    """The split-bf16 tensor-core kernel against the plain version: m, p
    and q that are multiples of no tile (128 × 192 × 32), an all-zero
    slot, real weights, repeated launches bitwise equal, and the
    non-finite rule (NaN where the plain version gives NaN, non-finite
    where it gives ±Inf)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    tgram.reset_launches()
    for m, p, q in [(1037, 255, 391), (333, 131, 197)]:
        x = torch.randn(m, p, device="cuda", generator=g).to(dt)
        z = torch.randn(m, q, device="cuda", generator=g).to(dt)
        slot = torch.randint(0, 3, (m,), device="cuda", generator=g)
        w = torch.zeros(m, 3, device="cuda")
        w[slot < 2, slot[slot < 2]] = 1.0         # slot 2 stays all-zero
        for wt in (w, w * torch.rand(m, 3, device="cuda", generator=g)):
            wt = wt.to(dt)
            got = tgram.xty_folds_masked(x, z, wt)
            want = tref.xty_folds_masked(x, z, wt)
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * want.abs().max().item())
            assert not got[2].any()
            assert torch.equal(got, tgram.xty_folds_masked(x, z, wt))
    assert tgram.LAUNCHES["xty_folds_masked"] == 8
    # A NaN in x under a zero weight, an Inf in x under its weight, an Inf
    # in z.
    x = torch.randn(203, 129, device="cuda", generator=g)
    z = torch.randn(203, 70, device="cuda", generator=g)
    w = torch.zeros(203, 2, device="cuda")
    w[:100, 0] = 1.0
    w[100:, 1] = 1.0
    x[5, 3] = float("nan")
    w[5] = 0.0
    x[120, 9] = float("inf")
    z[150, 7] = float("inf")
    x, z, w = x.to(dt), z.to(dt), w.to(dt)
    got = tgram.xty_folds_masked(x, z, w)
    want = tref.xty_folds_masked(x, z, w)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert torch.isnan(got[torch.isnan(want)]).all()
    assert not torch.isfinite(got[torch.isinf(want)]).any()
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4,
                               atol=1e-4 * want[fin].abs().max().item())


# ---------------------------------------------------------------------------
# Streaming accumulation: chunk × shard invariance against JAX and f64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("y_offset", [0.0, 3.0])
@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("chunk", [1, 7, 13, 64])
def test_chunked_stats_match_jax_and_f64_oracle(chunk, n_shards, y_offset):
    """n=97, k=5 (folds of 20/20/19/19/19): chunk sizes {1 row,
    fold-misaligned, ragged tail} × shard windows cutting folds."""
    n, k = 97, 5
    X, Y = _problem(chunk + n_shards, n, 6, 4, y_offset=y_offset)
    ranges = tfs.shard_row_ranges(n, n_shards)
    assert ranges == jfs.shard_row_ranges(n, n_shards)
    got = tfs.compute_sharded_chunked(
        [_stream(X, Y, lo, hi, chunk) for lo, hi in ranges], n, k,
        device="cpu")
    want = jfs.compute_sharded_chunked(
        [_stream(X, Y, lo, hi, chunk) for lo, hi in ranges], n, k)
    oracle = _oracle(X, Y, k)
    for f in FIELDS:
        g = getattr(got, f)
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, f)),
                                   rtol=2e-5, atol=2e-4, err_msg=f)
        np.testing.assert_allclose(g.numpy(), oracle[f], rtol=2e-5,
                                   atol=2e-4, err_msg=f)
    if n_shards == 1:                             # the one-stream entry point
        one = tfs.compute_chunked(_stream(X, Y, 0, n, chunk), n, k,
                                  device="cpu")
        for f in FIELDS:
            torch.testing.assert_close(getattr(one, f), getattr(got, f),
                                       rtol=0, atol=0)


def test_chunk_update_counts_each_fixed_shape_once():
    # A (chunk_rows, p, q) signature no other test of this file uses.
    X, Y = _problem(4, 97, 7, 5)
    c0 = tfs.chunk_update_compile_count()
    tfs.compute_chunked(_stream(X, Y, 0, 97, 11), 97, 5, chunk_rows=11,
                        device="cpu")
    assert tfs.chunk_update_compile_count() - c0 == 1    # fresh signature
    c1 = tfs.chunk_update_compile_count()
    for chunk in (11, 5, 40):                     # split/padded to 11 rows
        tfs.compute_chunked(_stream(X, Y, 0, 97, chunk), 97, 5,
                            chunk_rows=11, device="cpu")
    assert tfs.chunk_update_compile_count() == c1       # repeats: none


def test_accumulator_window_and_stream_validation():
    X, Y = _problem(4, 40, 4, 3)
    with pytest.raises(ValueError, match="row_start"):
        tfs.FoldStatsAccumulator(40, 4, row_start=10, row_stop=5,
                                 device="cpu")
    acc = tfs.FoldStatsAccumulator(40, 4, row_start=10, row_stop=30,
                                   device="cpu")
    with pytest.raises(ValueError, match="overruns"):
        acc.update(X[10:35], Y[10:35])
    acc.update(X[10:25], Y[10:25])
    with pytest.raises(ValueError, match="full window"):
        acc.finalize()
    with pytest.raises(ValueError, match="chunk_rows"):
        tfs.FoldStatsAccumulator(40, 4, chunk_rows=0, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        tfs.shard_row_ranges(4, 9)
    with pytest.raises(ValueError, match="at least one"):
        tfs.combine([])
    # A mesh needs a process group; the sharded finalize itself runs in
    # tests/test_torch_distributed.py's 8-rank world.
    from repro_torch.core import compat
    with pytest.raises(RuntimeError, match="no torch.distributed process "
                                           "group"):
        tfs.compute_sharded_chunked(
            [_stream(X, Y, 0, 40, 8)], 40, 4,
            mesh=compat.make_mesh((1,), ("data",), device="cpu"),
            device="cpu")


def test_column_moments_match_numpy_and_jax():
    rng = np.random.default_rng(14)
    A = rng.normal(size=(123, 7)) * 3 + 11
    cm, jm = tfs.ColumnMoments(device="cpu"), jfs.ColumnMoments()
    for lo in range(0, 123, 17):
        cm.update(A[lo:lo + 17])
        jm.update(A[lo:lo + 17])
    assert cm.mean.dtype == torch.float64 and cm.count == jm.count == 123
    np.testing.assert_allclose(cm.mean.numpy(), A.mean(0), rtol=1e-9)
    np.testing.assert_allclose(cm.std(0.0).numpy(), A.std(0), rtol=1e-9)
    np.testing.assert_allclose(cm.std().numpy(), jm.std(), rtol=1e-9)
    # A read-only float32 chunk (a store memmap) is read, not written.
    ro = np.float32(A[:10])
    ro.flags.writeable = False
    cm32 = tfs.ColumnMoments(device="cpu")
    cm32.update(ro)
    np.testing.assert_allclose(cm32.mean.numpy(), ro.astype(np.float64)
                               .mean(0), rtol=1e-12)
    with pytest.raises(ValueError, match="no rows"):
        tfs.ColumnMoments(device="cpu").std()


# ---------------------------------------------------------------------------
# Solve from statistics: JAX-made statistics carried into the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scoring", ["r2", "r"])
def test_validation_scores_per_target_on_jax_stats(scoring):
    X, Y = _problem(15, 190, 20, 10, y_offset=2.0)
    js = jfs.compute(jnp.asarray(X), jnp.asarray(Y), 5)
    ts = convert.fold_stats_from_numpy(*_jax_stats_np(js), device="cpu")
    lams = np.asarray([0.1, 10.0, 300.0], np.float32)
    for f in range(5):
        G_tr, C_tr = js.train(f)
        evals, Q = jnp.linalg.eigh(G_tr + 1e-6 * jnp.eye(20))
        want = jfs.validation_scores_per_target(
            js, f, Q, evals, C_tr, jnp.asarray(lams), scoring)
        tQ, tev, tC = (torch.tensor(np.asarray(a)) for a in (Q, evals, C_tr))
        got = tfs.validation_scores_per_target(
            ts, f, tQ, tev, tC, torch.from_numpy(lams), scoring)
        assert got.shape == (3, 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        mean = tfs.validation_scores_from_stats(
            ts, f, tQ, tev, tC, torch.from_numpy(lams), scoring)
        torch.testing.assert_close(mean, got.mean(1))


@pytest.mark.parametrize("scoring", ["r2", "r"])
def test_ridge_cv_from_stats_on_jax_stats(scoring):
    X, Y = _problem(16, 230, 24, 12, noise=0.5)
    js = jfs.compute(jnp.asarray(X), jnp.asarray(Y), 5)
    ts = convert.fold_stats_from_numpy(*_jax_stats_np(js), device="cpu")
    want = jridge.ridge_cv_from_stats(js, jridge.RidgeCVConfig(
        scoring=scoring))
    got = tridge.ridge_cv_from_stats(ts, tridge.RidgeCVConfig(
        scoring=scoring))
    assert float(got.best_lambda) == float(want.best_lambda)
    assert int(got.best_index) == int(want.best_index)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               **F32)
    np.testing.assert_allclose(got.cv_scores.numpy(),
                               np.asarray(want.cv_scores), **F32)
    with pytest.raises(ValueError, match="primal-only"):
        tridge.ridge_cv_from_stats(ts, tridge.RidgeCVConfig(method="dual"))


# ---------------------------------------------------------------------------
# Store-backed fits: the port and JAX on the same store directory
# ---------------------------------------------------------------------------

def _stores(make_run_store, X, Y, n_runs=3, n_folds=4):
    jstore = make_run_store(X, Y, n_runs=n_runs, n_folds=n_folds)
    return jstore, RunStore.open(jstore.root)


def _assert_same_fit(tenc, jenc, tol=F32):
    assert tenc.report_.best_lambda[0] == jenc.report_.best_lambda[0]
    np.testing.assert_allclose(tenc.weights_.numpy(),
                               np.asarray(jenc.weights_), **tol)
    np.testing.assert_allclose(tenc.report_.cv_scores,
                               np.asarray(jenc.report_.cv_scores), **tol)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("y_offset", [0.0, 3.0])
def test_fit_store_chunked_matches_jax(make_run_store, y_offset, prefetch):
    X, Y = _problem(10, 310, 24, 12, y_offset=y_offset)
    jstore, store = _stores(make_run_store, X, Y)
    kw = dict(n_folds=4, device_memory_budget=1, chunk_rows=37,
              prefetch=prefetch)
    jenc = JEncoder(**kw).fit(store=jstore)
    tenc = TEncoder(TConfig(**kw), device="cpu").fit(store=store)
    td, jd = tenc.report_.decision, jenc.report_.decision
    assert (td.solver, td.method) == ("ridge", "chunked")
    for f in dataclasses.fields(jd):
        if f.name != "rationale":
            assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert (td.rationale.split("; kernel tier")[0]
            == jd.rationale.split("; kernel tier")[0])
    _assert_same_fit(tenc, jenc)
    ss, js = tenc.stream_stats_, jenc.stream_stats_
    assert set(ss) == set(js)
    for key in ("schema", "kind", "prefetch", "chunks", "bytes_staged",
                "use_pallas"):
        assert ss[key] == js[key], key
    assert ss["compile_count"] <= 1
    # The streamed fit equals the port's in-memory fit of the same rows.
    mem = TEncoder(n_folds=4, device="cpu").fit(X, Y)
    assert mem.report_.best_lambda[0] == tenc.report_.best_lambda[0]
    np.testing.assert_allclose(tenc.weights_.numpy(), mem.weights_.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_fit_store_bf16_matches_jax(make_run_store):
    X, Y = _problem(11, 200, 16, 8, noise=0.5)
    Xb, Yb = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (X, Y))
    jstore, store = _stores(make_run_store, Xb, Yb, n_runs=2, n_folds=3)
    kw = dict(n_folds=3, device_memory_budget=1, chunk_rows=64)
    jenc = JEncoder(**kw).fit(store=jstore)
    tenc = TEncoder(TConfig(**kw), device="cpu").fit(store=store)
    _assert_same_fit(tenc, jenc, _tol("bfloat16"))


def test_fit_chunks_store_and_iterator_match_jax(make_run_store):
    X, Y = _problem(12, 260, 16, 8, y_offset=1.0)
    jstore, store = _stores(make_run_store, X, Y)
    jenc = JEncoder(n_folds=4, chunk_rows=50).fit_chunks(jstore)
    tenc = TEncoder(device="cpu", n_folds=4, chunk_rows=50).fit_chunks(store)
    _assert_same_fit(tenc, jenc)
    assert tenc.report_.decision.method == jenc.report_.decision.method
    assert tenc.stream_stats_["chunks"] == 6
    it = TEncoder(device="cpu", n_folds=4).fit_chunks(
        _stream(X, Y, 0, 260, 31), n_total=260)
    _assert_same_fit(it, jenc)
    with pytest.raises(ValueError, match="needs n_total"):
        TEncoder(device="cpu").fit_chunks(iter([(X, Y)]))
    with pytest.raises(ValueError, match="primal/eigh"):
        TEncoder(device="cpu", method="dual").fit_chunks(store)
    with pytest.raises(ValueError, match="single-shard ridge"):
        TEncoder(device="cpu", solver="mor").fit_chunks(store)


def test_run_store_matches_jax_standardized_fit(make_run_store):
    """run_store ≡ the reference's run_store ≡ standardize() → fit()."""
    X, Y = _problem(13, 260, 12, 8, y_offset=5.0)
    jstore, store = _stores(make_run_store, X, Y, n_runs=2)
    jst = jpipeline.run_store(jstore, JConfig(n_folds=4), chunk_rows=49)
    tst = tpipeline.run_store(store, TConfig(n_folds=4), chunk_rows=49,
                              device="cpu")
    for k in ("mu_x", "sd_x", "mu_y", "sd_y"):
        got = getattr(tst.standardizer, k)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   getattr(jst.standardizer, k), rtol=1e-6)
    assert tst.report.best_lambda[0] == jst.report.best_lambda[0]
    np.testing.assert_allclose(tst.encoder.weights_.numpy(),
                               np.asarray(jst.encoder.weights_), **F32)
    np.testing.assert_allclose(tst.report.cv_scores,
                               np.asarray(jst.report.cv_scores), **F32)
    assert tst.encoder.standardizer_ is tst.standardizer
    assert tst.store is store and tst.X is None
    assert tst.encoder.stream_stats_["chunks"] == 6
    assert set(tst.stage_seconds) == {
        "fit_chunked", "fit_chunked.moments", "fit_chunked.stats",
        "fit_chunked.solve"}
    # The reference's own parity: an in-memory fit of standardized rows.
    mu_x, sd_x = X.mean(0), X.std(0) + 1e-6
    mu_y, sd_y = Y.mean(0), Y.std(0) + 1e-6
    mem = TEncoder(n_folds=4, device="cpu").fit((X - mu_x) / sd_x,
                                                (Y - mu_y) / sd_y)
    assert mem.report_.best_lambda[0] == tst.report.best_lambda[0]
    np.testing.assert_allclose(tst.encoder.weights_.numpy(),
                               mem.weights_.numpy(), rtol=5e-4, atol=5e-4)


def test_fit_chunked_in_memory_source_matches_plain_fit():
    X, Y = _problem(17, 300, 12, 6)
    st = tpipeline.run_stages(X, Y, [tpipeline.fit_chunked(
        TConfig(n_folds=5), chunk_rows=64, device="cpu")], device="cpu")
    mem = TEncoder(device="cpu").fit(X, Y)
    assert st.standardizer is None
    assert st.report.best_lambda[0] == mem.report_.best_lambda[0]
    np.testing.assert_allclose(st.encoder.weights_.numpy(),
                               mem.weights_.numpy(), **F32)
    with pytest.raises(ValueError, match="store or state.X"):
        tpipeline.fit_chunked(device="cpu")(
            tpipeline.PipelineState(X=None, Y=None))


def test_fit_store_rejects_fold_split_mismatch(make_run_store):
    X, Y = _problem(16, 60, 6, 4)
    _, store = _stores(make_run_store, X, Y, n_runs=2, n_folds=3)
    with pytest.raises(ValueError, match="n_folds=3"):
        TEncoder(device="cpu", n_folds=5,
                 device_memory_budget=1).fit(store=store)
    with pytest.raises(ValueError, match="n_folds=3"):
        TEncoder(device="cpu", n_folds=5).fit_chunks(store)
    with pytest.raises(ValueError, match="n_folds=3"):
        tpipeline.run_store(store, TConfig(n_folds=5), device="cpu")


def test_fit_store_transparent_when_budget_fits(make_run_store):
    X, Y = _problem(12, 120, 8, 6)
    jstore, store = _stores(make_run_store, X, Y, n_runs=2, n_folds=3)
    enc = TEncoder(device="cpu", n_folds=3,
                   device_memory_budget=10**9).fit(store=store)
    assert enc.report_.decision.method == "eigh"
    assert enc.stream_stats_ is None
    jenc = JEncoder(n_folds=3, device_memory_budget=10**9).fit(store=jstore)
    _assert_same_fit(enc, jenc)
    with pytest.raises(ValueError, match="not both"):
        TEncoder(device="cpu").fit(X, Y, store=store)
    with pytest.raises(ValueError, match="needs"):
        TEncoder(device="cpu").fit(X)


def test_fit_store_refuses_pathological_target_means(make_run_store):
    X, Y = _problem(18, 120, 6, 4, noise=1e-3, y_offset=1e4)
    _, store = _stores(make_run_store, X, Y, n_runs=2, n_folds=3)
    with pytest.raises(ValueError, match="standardize the targets"):
        TEncoder(device="cpu", n_folds=3,
                 device_memory_budget=1).fit(store=store)


def test_jax_materialized_store_streams_in_the_port(tmp_path):
    """ROADMAP's cross-package check: materialise with JAX (jax.random
    draws), stream with the port, same fit as the reference's."""
    from repro.data import fmri as jfmri

    spec = jfmri.SubjectSpec(n=300, p=16, t=12)
    JStore.create(str(tmp_path / "s"), n_folds=5).materialize_synthetic(
        spec, rows_per_run=70)
    jstore = JStore.open(str(tmp_path / "s"))
    store = RunStore.open(str(tmp_path / "s"))
    kw = dict(device_memory_budget=1, chunk_rows=64)
    jenc = JEncoder(**kw).fit(store=jstore)
    tenc = TEncoder(TConfig(**kw), device="cpu").fit(store=store)
    _assert_same_fit(tenc, jenc)
