"""The port's bundle format against the JAX package's: either package reads
what the other writes.

Checkpoints and bundles written by one package are opened by the other and
must give equal arrays — bf16 leaves compared as their u16 bit patterns,
which is how both store them.  Plus the port's own contracts: the
``BundleWriter`` errors, streaming shards from ``fit_wholebrain``, and the
``save``/``load`` round trip with bitwise-equal predictions.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint import io as jio
from repro.encoding import BrainEncoder as JEncoder
from repro.encoding import EncoderConfig as JConfig
from repro.encoding import resolve as jresolve
from repro.encoding.estimator import EncodingReport as JReport
from repro.serving_encoders.bundle import EncoderBundle as JBundle
from repro.wholebrain import BundleWriter as JWriter
from repro_torch.checkpoint import io as tio
from repro_torch.data.store import RunStore
from repro_torch.encoding import BrainEncoder, EncoderConfig, pipeline
from repro_torch.encoding import resolve
from repro_torch.encoding.estimator import EncodingReport
from repro_torch.serving_encoders import BundleError, EncoderBundle
from repro_torch.serving_encoders.bundle import (config_from_dict,
                                                 config_to_dict)
from repro_torch.wholebrain import BundleWriter, fit_wholebrain


def _bits(a) -> np.ndarray:
    """An array as comparable storage: bf16 (ml_dtypes or torch) → u16."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _problem(seed, n=60, p=6, t=14):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = rng.normal(size=(p, t)).astype(np.float32) / np.sqrt(p)
    Y = (X @ W + 0.1 * rng.normal(size=(n, t))).astype(np.float32)
    return X, Y


def _fitted(seed=0, **kw):
    X, Y = _problem(seed)
    return X, BrainEncoder(EncoderConfig(n_folds=3, **kw),
                           device="cpu").fit(X, Y)


# ---------------------------------------------------------------------------
# checkpoint.io
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_and_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    tree = {"W": {"001": torch.from_numpy(w).to(torch.bfloat16),
                  "000": torch.from_numpy(w)},
            "lam": np.arange(3, dtype=np.float64)}
    tio.save(str(tmp_path / "t"), 0, tree)
    jtree = {"W": {"001": jnp.asarray(w, jnp.bfloat16),
                   "000": jnp.asarray(w)},
             "lam": np.arange(3, dtype=np.float64)}
    jio.save(str(tmp_path / "j"), 0, jtree)
    with open(tmp_path / "t" / "step_0" / "manifest.json") as f:
        tman = json.load(f)
    with open(tmp_path / "j" / "step_0" / "manifest.json") as f:
        jman = json.load(f)
    assert tman["leaves"] == jman["leaves"]        # same files and dtypes
    assert list(tman["leaves"]) == ["W/000", "W/001", "lam"]
    for src in ("t", "j"):
        got_t = tio.load(str(tmp_path / src), 0)
        got_j = jio.load(str(tmp_path / src), 0)
        assert set(got_t) == set(got_j) == {"W/000", "W/001", "lam"}
        for key in got_t:
            np.testing.assert_array_equal(_bits(got_t[key]),
                                          _bits(got_j[key]))
        assert got_t["W/001"].dtype == np.uint16
        np.testing.assert_array_equal(
            _bits(got_t["W/001"]),
            _bits(torch.from_numpy(w).to(torch.bfloat16)))
        leaf = tio.load_leaf(str(tmp_path / src), 0, "W/000", mmap=True)
        assert isinstance(leaf, np.memmap)
        np.testing.assert_array_equal(leaf, w)
    assert tio.latest_step(str(tmp_path / "t")) == 0
    assert tio.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_errors(tmp_path):
    with pytest.raises(tio.CheckpointError, match="no manifest"):
        tio.load(str(tmp_path), 0)
    tio.save(str(tmp_path), 1, {"a": np.ones(2)})
    with pytest.raises(tio.CheckpointError, match="not recorded"):
        tio.load_leaf(str(tmp_path), 1, "b")
    os.remove(tmp_path / "step_1" / "a.npy")
    with pytest.raises(tio.CheckpointError, match="missing"):
        tio.load(str(tmp_path), 1)
    (tmp_path / "step_1" / "manifest.json").write_text("{")
    with pytest.raises(tio.CheckpointError, match="corrupt"):
        tio.load(str(tmp_path), 1)
    # A replaced step keeps one complete directory.
    tio.save(str(tmp_path), 1, {"a": np.zeros(3)})
    np.testing.assert_array_equal(tio.load(str(tmp_path), 1)["a"],
                                  np.zeros(3))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".")]


# ---------------------------------------------------------------------------
# Bundles across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("weight_shards", [None, 3])
def test_port_bundle_reads_in_reference(tmp_path, weight_dtype,
                                        weight_shards):
    X, enc = _fitted()
    enc.standardizer_ = pipeline.Standardizer(
        mu_x=torch.arange(6.0), sd_x=torch.full((6,), 2.0))
    path = str(tmp_path / "b")
    enc.save(path, weight_shards=weight_shards, weight_dtype=weight_dtype,
             provenance={"subject": "sub-01"})
    jb = JBundle.open(path)
    tb = EncoderBundle.open(path)
    assert jb.manifest == tb.manifest
    assert jb.shape == tb.shape == (6, 14)
    assert tb.weight_dtype == (torch.bfloat16 if weight_dtype
                               else torch.float32)
    jarr, tarr = jb.load_arrays(), tb.load_arrays()
    assert set(jarr) == set(tarr)
    for key in tarr:
        np.testing.assert_array_equal(_bits(tarr[key]), _bits(jarr[key]))
    W = enc.weights_ if weight_dtype is None else \
        enc.weights_.to(torch.bfloat16)
    jenc = jb.load_encoder()
    np.testing.assert_array_equal(_bits(jenc.weights_), _bits(W))
    np.testing.assert_array_equal(np.asarray(jenc.standardizer_.mu_x),
                                  np.arange(6.0, dtype=np.float32))
    assert tb.decision() == enc.report_.decision
    assert tb.config() == enc.config
    assert tb.manifest["provenance"] == {"subject": "sub-01"}
    n_shards = weight_shards or 1
    assert tb.manifest["weight_shards"] == n_shards
    assert tb.shards_for_columns(0, 14) == list(range(n_shards))


@pytest.mark.parametrize("weight_dtype", [None, "bfloat16"])
def test_reference_bundle_reads_in_port(tmp_path, weight_dtype):
    X, Y = _problem(1)
    jenc = JEncoder(JConfig(n_folds=3)).fit(jnp.asarray(X), jnp.asarray(Y))
    path = str(tmp_path / "j")
    jenc.save(path, weight_shards=2, weight_dtype=weight_dtype)
    tb = EncoderBundle.open(path)
    jb = JBundle.open(path)
    jarr, tarr = jb.load_arrays(), tb.load_arrays()
    for key in jarr:
        np.testing.assert_array_equal(_bits(tarr[key]), _bits(jarr[key]))
    enc = tb.load_encoder(device="cpu")
    want = jnp.asarray(jenc.weights_)
    if weight_dtype:
        want = want.astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(enc.weights_), _bits(want))
    assert enc.weights_.dtype == (torch.bfloat16 if weight_dtype
                                  else torch.float32)
    np.testing.assert_array_equal(enc.report_.best_lambda,
                                  jenc.report_.best_lambda)
    assert enc.report_.decision.method == jenc.report_.decision.method
    assert enc.config == config_from_dict(config_to_dict(enc.config))
    shard = tb.load_weight_shard(1, mmap=True)
    np.testing.assert_array_equal(_bits(shard), _bits(jb.load_weight_shard(1)))


def test_writer_bundles_cross_read(make_run_store, tmp_path):
    """BundleWriter bundles of either package read the same in both."""
    X, Y = _problem(2, n=64, p=5, t=13)
    jstore = make_run_store(X, Y, n_folds=3)
    store = RunStore.open(jstore.root)
    cfg = EncoderConfig(n_folds=3, chunk_rows=16, device_memory_budget=1,
                        target_block=6)
    decision = resolve(cfg, *store.shape, 1, device="cpu")
    res = fit_wholebrain(store, cfg, device="cpu")
    report = EncodingReport(weights=None, best_lambda=res.best_lambda,
                            cv_scores=res.cv_scores, lambdas=cfg.lambdas,
                            decision=decision)
    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    with BundleWriter(tpath, p=5, t=13, weight_dtype="bfloat16") as w:
        for lo, hi in res.block_bounds:
            w.append(res.weights[:, lo:hi])
        w.commit(config=cfg, report=report,
                 lambda_by_target=res.lambda_by_target)
    jcfg = JConfig(n_folds=3, chunk_rows=16, device_memory_budget=1,
                   target_block=6)
    with JWriter(jpath, p=5, t=13, weight_dtype="bfloat16") as w:
        for lo, hi in res.block_bounds:
            w.append(res.weights[:, lo:hi])
        w.commit(config=jcfg, report=JReport(
            weights=None, best_lambda=res.best_lambda,
            cv_scores=res.cv_scores, lambdas=jcfg.lambdas,
            decision=jresolve(jcfg, *store.shape, 1)),
            lambda_by_target=res.lambda_by_target)
    arrays = [B.open(p).load_arrays() for B in (EncoderBundle, JBundle)
              for p in (tpath, jpath)]
    for other in arrays[1:]:
        assert set(other) == set(arrays[0])
        for key in arrays[0]:
            np.testing.assert_array_equal(_bits(other[key]),
                                          _bits(arrays[0][key]))
    assert EncoderBundle.open(jpath).weight_shard_bounds() == \
        EncoderBundle.open(tpath).weight_shard_bounds() == res.block_bounds


# ---------------------------------------------------------------------------
# BundleWriter
# ---------------------------------------------------------------------------

def _report(res, cfg):
    return EncodingReport(
        weights=None, best_lambda=res.best_lambda, cv_scores=res.cv_scores,
        lambdas=cfg.lambdas,
        decision=resolve(EncoderConfig(n_folds=3, device_memory_budget=1,
                                       target_block=4), 48, 4, 9, 1,
                         device="cpu"))


def test_bundle_writer_errors(make_run_store, tmp_path):
    X, Y = _problem(3, n=48, p=4, t=9)
    store = RunStore.open(make_run_store(X, Y, n_folds=3).root)
    cfg = EncoderConfig(n_folds=3, chunk_rows=16, target_block=4)
    res = fit_wholebrain(store, cfg, device="cpu")
    report = _report(res, cfg)
    # Incomplete coverage refuses to commit; the abort cleans up.
    with BundleWriter(str(tmp_path / "short"), p=4, t=9) as w:
        w.append(res.weights[:, :4])
        with pytest.raises(BundleError, match="cover"):
            w.commit(config=cfg, report=report)
    assert not os.path.exists(str(tmp_path / "short"))
    # Wrong shard shape / overflow refuse at append.
    with BundleWriter(str(tmp_path / "bad"), p=4, t=9) as w:
        with pytest.raises(BundleError, match="p=4"):
            w.append(np.zeros((5, 3), np.float32))
        with pytest.raises(BundleError, match="overflow"):
            w.append(np.zeros((4, 10), np.float32))
    # Double commit, append after commit, and an existing bundle.
    path = str(tmp_path / "ok")
    with BundleWriter(path, p=4, t=9) as w:
        w.append(res.weights)
        w.commit(config=cfg, report=report)
        with pytest.raises(BundleError, match="already committed"):
            w.commit(config=cfg, report=report)
        with pytest.raises(BundleError, match="already committed"):
            w.append(res.weights)
    assert EncoderBundle.open(path).shape == (4, 9)
    with pytest.raises(BundleError, match="overwrite"):
        BundleWriter(path, p=4, t=9)
    with pytest.raises(BundleError, match=r"\(t,\)"):
        with BundleWriter(str(tmp_path / "lam"), p=4, t=9) as w:
            w.append(res.weights)
            w.commit(config=cfg, report=report,
                     lambda_by_target=np.zeros(3))
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith(".tmpbundle_")]


@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
def test_streaming_writer_equals_collected(make_run_store, tmp_path,
                                           lambda_mode):
    """writer= streams the shards during the fit (collect=False): f32
    shards bitwise the collected W, bf16 shards its round-to-nearest-even,
    and lambda_by_target from the real bounds."""
    X, Y = _problem(4, n=64, p=5, t=14)
    store = RunStore.open(make_run_store(X, Y, n_folds=3).root)
    cfg = EncoderConfig(n_folds=3, chunk_rows=16, target_block=6)
    ref = fit_wholebrain(store, cfg, lambda_mode=lambda_mode, device="cpu")
    for dtype in ("float32", "bfloat16"):
        path = str(tmp_path / dtype)
        with BundleWriter(path, p=5, t=14, weight_dtype=dtype) as w:
            res = fit_wholebrain(store, cfg, lambda_mode=lambda_mode,
                                 writer=w, collect=False, device="cpu")
            assert res.weights is None
            assert not os.path.exists(os.path.join(w.scratch_dir,
                                                   "ahat.npy"))
            w.commit(config=cfg, report=_report(res, cfg),
                     lambda_by_target=res.lambda_by_target)
        b = EncoderBundle.open(path)
        assert b.weight_shard_bounds() == ref.block_bounds == \
            [(0, 6), (6, 12), (12, 14)]
        W = np.concatenate([b.load_weight_shard(i, mmap=True)
                            for i in range(3)], axis=1)
        want = torch.from_numpy(ref.weights).to(getattr(torch, dtype))
        np.testing.assert_array_equal(W, _bits(want))
        np.testing.assert_array_equal(
            b.load_arrays(["lambda_by_target"])["lambda_by_target"],
            ref.lambda_by_target)


# ---------------------------------------------------------------------------
# BrainEncoder.save / load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_dtype", [None, "bfloat16"])
def test_save_load_predicts_bitwise(tmp_path, weight_dtype):
    X, enc = _fitted(5)
    enc.standardizer_ = pipeline.Standardizer(
        mu_y=torch.zeros(14), sd_y=torch.ones(14))
    path = str(tmp_path / "b")
    assert enc.save(path, weight_shards=4, weight_dtype=weight_dtype) == path
    back = BrainEncoder.load(path, device="cpu")
    if weight_dtype is None:
        assert torch.equal(back.predict(X), enc.predict(X))
    else:
        cast = BrainEncoder(enc.config, device="cpu")
        cast.report_ = enc.report_
        cast.report_.weights = enc.weights_.to(torch.bfloat16)
        assert torch.equal(back.predict(X), cast.predict(X))
    np.testing.assert_array_equal(back.report_.best_lambda,
                                  enc.report_.best_lambda)
    np.testing.assert_array_equal(back.report_.cv_scores,
                                  enc.report_.cv_scores)
    assert back.report_.decision == enc.report_.decision
    assert torch.equal(back.standardizer_.sd_y, torch.ones(14))
    assert back.standardizer_.mu_x is None
    with pytest.raises(BundleError, match="overwrite"):
        enc.save(path)
    enc.save(path, overwrite=True)
    # More shards than the world (of one, without a process group) is
    # the reference's BundleError; sharded loads run in
    # tests/test_torch_distributed.py's 8-rank world.
    with pytest.raises(BundleError, match="sharded load wants 2 devices, "
                                          "have 1"):
        BrainEncoder.load(path, target_shards=2, device="cpu")
    with pytest.raises(BundleError, match="not fitted"):
        BrainEncoder(device="cpu").save(str(tmp_path / "unfit"))


def test_open_validates_eagerly(tmp_path):
    _, enc = _fitted(6)
    path = str(tmp_path / "b")
    enc.save(path, weight_shards=2)
    with pytest.raises(BundleError, match="no bundle.json"):
        EncoderBundle.open(str(tmp_path))
    man = os.path.join(path, "bundle.json")
    good = open(man).read()
    m = json.loads(good)
    m["arrays"]["W/000"]["shape"] = [6, 99]
    open(man, "w").write(json.dumps(m))
    with pytest.raises(BundleError, match="shape"):
        EncoderBundle.open(path)
    m = json.loads(good)
    m["arrays"]["W/000"]["dtype"] = "float64"
    open(man, "w").write(json.dumps(m))
    with pytest.raises(BundleError, match="dtype"):
        EncoderBundle.open(path)
    m = json.loads(good)
    m["weight_shard_bounds"] = [[0, 5], [6, 14]]
    open(man, "w").write(json.dumps(m))
    with pytest.raises(BundleError, match="overlap or gap"):
        EncoderBundle.open(path)
    m = json.loads(good)
    m["version"] = 99
    open(man, "w").write(json.dumps(m))
    with pytest.raises(BundleError, match="version"):
        EncoderBundle.open(path)
    open(man, "w").write(good)
    os.remove(os.path.join(path, "step_0", "W__001.npy"))
    with pytest.raises(BundleError, match="missing"):
        EncoderBundle.open(path)
    b = EncoderBundle(path, json.loads(good))
    with pytest.raises(BundleError, match="out of range"):
        b.load_weight_shard(2)
    with pytest.raises(BundleError, match="outside"):
        b.shards_for_columns(3, 15)
    with pytest.raises(BundleError, match="not in the checkpoint"):
        b.load_arrays(["nope"])
