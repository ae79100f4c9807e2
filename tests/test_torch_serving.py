"""The port's serving tier (registry, mixed-wave service, traffic, fleet)
against JAX's.

Both packages open the same bundle directories (written by either) and
replay the same traces; the port runs on ``device="cpu"``.  Inside the
port the packed serve must equal serving each request alone bitwise
(predictions and Pearson r); against the reference, predictions agree
within f32 ``rtol=1e-4, atol=2e-4`` and r within ``1e-4``, and the
registry's LRU account, the wave plans and the trace digests are equal.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.encoding import BrainEncoder as JEncoder
from repro.encoding import dispatch as jdispatch
from repro.serving_encoders import EncoderBundle as JBundle
from repro.serving_encoders import EncoderRegistry as JRegistry
from repro.serving_encoders import EncoderService as JService
from repro.serving_encoders import PredictRequest as JRequest
from repro.serving_encoders import plan_mixed_waves as jplan
from repro.serving_encoders import registry as jregistry
from repro.serving_encoders import traffic as jtraffic
from repro_torch.encoding import BrainEncoder as TEncoder
from repro_torch.encoding import dispatch as tdispatch
from repro_torch.encoding import pipeline as tpipeline
from repro_torch.serving_encoders import (
    BundleError, EncoderBundle, EncoderRegistry, EncoderService,
    FleetFrontend, FleetRegistry, PredictRequest, RegistryError,
    ResidencyMap, ServiceError, WorkerLost, plan_mixed_waves,
    reference_serve,
)
from repro_torch.serving_encoders import fleet as tfleet
from repro_torch.serving_encoders import registry as tregistry
from repro_torch.serving_encoders import service as tservice
from repro_torch.serving_encoders import traffic as ttraffic

P, T = 12, 7
F32 = dict(rtol=1e-4, atol=2e-4)
R_TOL = dict(rtol=0, atol=1e-4)
MODELS = ("m0", "m1", "std", "wide")


def _problem(seed, n=90):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, P)).astype(np.float32)
    W = rng.standard_normal((P, T)).astype(np.float32)
    Y = (X @ W + 0.1 * rng.standard_normal((n, T))).astype(np.float32)
    return X, Y


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory):
    """Four bundles sharing (p, t): two written by the reference, one by
    the port's pipeline with a fitted standardizer (μ/σ on both sides),
    and one by the port with three weight column shards."""
    root = tmp_path_factory.mktemp("torch_serving_fleet")
    for i, name in enumerate(("m0", "m1")):
        X, Y = _problem(i)
        JEncoder(n_folds=3).fit(jnp.asarray(X), jnp.asarray(Y)).save(
            str(root / name))
    X, Y = _problem(2)
    state = tpipeline.run_stages(
        3.0 * X + 1.5, 2.0 * Y - 0.5,
        [tpipeline.split(seed=2), tpipeline.standardize(),
         tpipeline.fit(n_folds=3, device="cpu")], device="cpu")
    state.encoder.save(str(root / "std"))
    X, Y = _problem(3)
    TEncoder(n_folds=3, device="cpu").fit(X, Y).save(
        str(root / "wide"), weight_shards=3)
    return root


def _registries(fleet_dir, names=MODELS, **kw):
    treg = EncoderRegistry(device="cpu", **kw)
    jreg = JRegistry(**kw)
    for name in names:
        treg.add(name, str(fleet_dir / name))
        jreg.add(name, str(fleet_dir / name))
    return treg, jreg


def _requests(rows, scored, models, seed=0, cls=PredictRequest):
    rng = np.random.default_rng(seed)
    reqs = []
    for i, (r, sc) in enumerate(zip(rows, scored)):
        X = rng.standard_normal((r, P)).astype(np.float32)
        Y = rng.standard_normal((r, T)).astype(np.float32) if sc else None
        reqs.append(cls(model=models[i % len(models)], features=X,
                        targets=Y, tenant=f"tenant-{i % 3}"))
    return reqs


def _as_reference(reqs):
    return [JRequest(model=q.model, features=q.features, targets=q.targets,
                     tenant=q.tenant) for q in reqs]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wave_rows", [16, 128])
def test_resident_bytes_match_reference(fleet_dir, wave_rows):
    for name in MODELS:
        tb = EncoderBundle.open(str(fleet_dir / name))
        jb = JBundle.open(str(fleet_dir / name))
        for slots in (0, 1, 4):
            assert tregistry.bundle_resident_bytes(tb, wave_rows, None,
                                                   slots) == \
                jregistry.bundle_resident_bytes(jb, wave_rows, None, slots)
        for width in (1, 3, T):
            assert tregistry.shard_resident_bytes(tb, width, wave_rows) == \
                jregistry.shard_resident_bytes(jb, width, wave_rows)
    for slots in (0, 2, 5):
        assert tdispatch.mixed_wave_scoring_bytes(wave_rows, 444, slots) == \
            jdispatch.mixed_wave_scoring_bytes(wave_rows, 444, slots)


def test_registry_lru_order_matches_reference(fleet_dir):
    need = tregistry.bundle_resident_bytes(
        EncoderBundle.open(str(fleet_dir / "m0")), 64)
    treg, jreg = _registries(fleet_dir, device_memory_budget=int(2.5 * need),
                             wave_rows=64)
    assert treg.loaded_names == jreg.loaded_names == []
    for name in ("m0", "m1", "m0", "std", "m1", "wide", "wide", "m0"):
        te, je = treg.get(name), jreg.get(name)
        assert treg.loaded_names == jreg.loaded_names, name
        assert te.resident_bytes == je.resident_bytes
        assert treg.stats() == jreg.stats(), name
        assert treg.resident_bytes <= int(2.5 * need)
        np.testing.assert_array_equal(te.weights.numpy(),
                                      np.asarray(je.weights))
        for f in ("mu_x", "sd_x", "mu_y", "sd_y"):
            np.testing.assert_array_equal(getattr(te, f).numpy(),
                                          np.asarray(getattr(je, f)))
    assert treg.evictions > 0 and treg.hits > 0
    assert treg.peak_resident_bytes == jreg.peak_resident_bytes


def test_registry_budget_refusal_recharge_and_names(fleet_dir):
    b = EncoderBundle.open(str(fleet_dir / "m0"))
    small = tregistry.bundle_resident_bytes(b, 16)
    big = tregistry.bundle_resident_bytes(b, 4096)
    treg, jreg = _registries(fleet_dir, ("m0", "m1"),
                             device_memory_budget=small + big - 1,
                             wave_rows=16)
    for reg, err in ((treg, RegistryError), (jreg, jregistry.RegistryError)):
        reg.get("m0")
        reg.get("m1")
        entry = reg.get("m1", wave_rows=4096)      # hit, but bigger waves
        assert entry.resident_bytes == big
        assert reg.loaded_names == ["m1"] and reg.evictions == 1
        with pytest.raises(err, match="wave size"):
            reg.get("m1", wave_rows=10**7)
        assert reg.loaded_names == ["m1"]
        with pytest.raises(err, match="already registered"):
            reg.add("m0", str(fleet_dir / "m0"))
        with pytest.raises(err, match="unknown"):
            reg.get("nope")
    regs = _registries(fleet_dir, ("m0",), device_memory_budget=16,
                       wave_rows=64)
    for reg, err in zip(regs, (RegistryError, jregistry.RegistryError)):
        with pytest.raises(err, match="over the registry budget"):
            reg.get("m0")
        with pytest.raises(err, match="over the registry budget"):
            reg.ensure_servable("m0")
    # A target-sharded load needs a world of that many ranks, as the
    # reference's needs the devices (tests/test_torch_distributed.py runs
    # one in an 8-rank world).
    from repro.serving_encoders.bundle import BundleError as JBundleError
    treg, jreg = _registries(fleet_dir, ("wide",), target_shards=7)
    for reg, err in ((treg, BundleError), (jreg, JBundleError)):
        with pytest.raises(err, match="sharded load wants 7 devices, "
                                      "have 1"):
            reg.get("wide")


def test_get_columns_shard_loads_match_reference(fleet_dir):
    b = EncoderBundle.open(str(fleet_dir / "wide"))
    assert b.weight_shard_bounds() == [(0, 2), (2, 4), (4, 7)]
    budget = 2 * tregistry.shard_resident_bytes(b, 3, 128) + 64
    treg, jreg = _registries(fleet_dir, ("wide",),
                             device_memory_budget=budget)
    for window in ((0, 3), (1, 2), (3, 7), (0, 1), (5, 6)):
        ts = treg.get_columns("wide", window)
        js = jreg.get_columns("wide", window)
        assert [e.bounds for e in ts] == [e.bounds for e in js]
        assert treg.loaded_shards == jreg.loaded_shards, window
        assert treg.stats() == jreg.stats(), window
        for te, je in zip(ts, js):
            np.testing.assert_array_equal(te.W.numpy(), np.asarray(je.W))
            np.testing.assert_array_equal(
                te.W.numpy(), b.load_weight_shard(te.shard))
    assert treg.loaded_names == [] and treg.shard_loads > 2
    assert treg.evictions > 0
    assert treg.resident_bytes <= budget


# ---------------------------------------------------------------------------
# mixed-wave service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("score_slots", [1, 2, 4])
def test_plan_mixed_waves_matches_reference(score_slots):
    rng = np.random.default_rng(score_slots)
    rows = [int(r) for r in rng.integers(1, 40, size=14)]
    scored = [bool(s) for s in rng.random(14) < 0.5]
    for ladder in ((8,), (4, 16), (3, 5, 16)):
        svc = EncoderService(EncoderRegistry(device="cpu"),
                             wave_buckets=ladder, score_slots=score_slots)
        got = plan_mixed_waves(rows, scored,
                               lambda rem: svc._next_wave(rem, None),
                               score_slots)
        want = jplan(rows, scored, lambda rem: svc._next_wave(rem, None),
                     score_slots)
        assert [(w.rows, w.fill, [tuple(vars(s).values())
                                  for s in w.segments]) for w in got] == \
            [(w.rows, w.fill, [tuple(vars(s).values())
                               for s in w.segments]) for w in want]
    with pytest.raises(ServiceError, match="score_slots"):
        plan_mixed_waves([3], [True], lambda rem: 8, 0)


def _assert_packed_equals_alone(fleet_dir, reqs, buckets, score_slots):
    treg, _ = _registries(fleet_dir)
    packed_svc = EncoderService(treg, wave_buckets=buckets,
                                score_slots=score_slots)
    ref_svc = EncoderService(_registries(fleet_dir)[0], wave_buckets=buckets,
                             score_slots=score_slots)
    packed = packed_svc.serve(reqs)
    alone = reference_serve(ref_svc, reqs)
    for i, (got, want) in enumerate(zip(packed, alone)):
        assert got.error is None and want.error is None
        assert np.array_equal(got.predictions, want.predictions), i
        assert (got.pearson_r is None) == (want.pearson_r is None)
        if got.pearson_r is not None:
            assert np.array_equal(got.pearson_r, want.pearson_r), i
    assert packed_svc.compile_count == len(packed_svc.stats.per_bucket)
    return packed


@pytest.mark.parametrize("buckets,score_slots", [
    ((8,), 1), ((4, 16), 2), ((8, 32), 4), ((3, 5, 16), 2)])
def test_packed_serve_equals_alone_bitwise(fleet_dir, buckets, score_slots):
    rows = [5, 1, 17, 8, 3, 30, 2, 11, 40]
    scored = [True, False, True, True, False, True, True, False, True]
    reqs = _requests(rows, scored, ["m0", "std", "m0", "wide"],
                     seed=sum(buckets))
    _assert_packed_equals_alone(fleet_dir, reqs, buckets, score_slots)


@pytest.mark.parametrize("buckets", [(16,), (4, 16)])
def test_service_matches_reference_service(fleet_dir, buckets):
    rows = [9, 23, 4, 31, 12, 7]
    scored = [True, False, True, True, False, True]
    reqs = _requests(rows, scored, list(MODELS), seed=5)
    treg, jreg = _registries(fleet_dir)
    tsvc = EncoderService(treg, wave_buckets=buckets, score_slots=2)
    jsvc = JService(jreg, wave_buckets=buckets, score_slots=2)
    got, want = tsvc.serve(reqs), jsvc.serve(_as_reference(reqs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.predictions, w.predictions, **F32)
        assert (g.pearson_r is None) == (w.pearson_r is None)
        if g.pearson_r is not None:
            np.testing.assert_allclose(g.pearson_r, w.pearson_r, **R_TOL)
    assert tsvc.stats.to_dict() == jsvc.stats.to_dict()
    assert tsvc.compile_count == jsvc.compile_count
    # Served predictions are the encoder's own (standardize → X·W →
    # de-standardize) within f32 tolerance, and r the §4.1 metric.
    for q, g in zip(reqs, got):
        enc = TEncoder.load(str(fleet_dir / q.model), device="cpu")
        std = enc.standardizer_
        X = torch.from_numpy(q.features)
        P_ = enc.predict(X if std is None else std.apply_x(X))
        P_ = P_ if std is None else std.unapply_y(P_)
        np.testing.assert_allclose(g.predictions, P_.numpy(), **F32)
        if q.targets is not None:
            from repro_torch.kernels import ops
            r = ops.pearson_r(torch.from_numpy(q.targets),
                              torch.from_numpy(g.predictions))
            np.testing.assert_allclose(g.pearson_r, r.numpy(), **R_TOL)


def test_compile_count_counts_wave_signatures(fleet_dir):
    treg, jreg = _registries(fleet_dir, ("m0", "m1"))
    tsvc, jsvc = (EncoderService(treg, wave_rows=32),
                  JService(jreg, wave_rows=32))
    X = _problem(99)[0]
    for svc, cls in ((tsvc, PredictRequest), (jsvc, JRequest)):
        svc.serve([cls("m0", X[:50]), cls("m1", X[:20])])
        assert svc.compile_count == 1        # two models, one shape
        svc.serve([cls("m0", X[:10]), cls("m0", X[:5], targets=X[:5, :T])])
        assert svc.compile_count == 1        # scoring adds no signature
        svc.serve([cls("m1", X[:10])], wave_rows=16)
        assert svc.compile_count == 2        # new shape → one more


def test_row_bits_do_not_depend_on_bucket_or_offset(fleet_dir):
    """A row's prediction bits at every bucket of the ladder and every
    offset in the wave equal its bits alone in the smallest wave."""
    treg, _ = _registries(fleet_dir, ("std",))
    e = treg.get("std")
    args = (e.weights, e.mu_x, e.sd_x, e.mu_y, e.sd_y)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, P)).astype(np.float32))
    alone = tservice.predict_rows(x, *args)[0]
    for bucket in (1, 5, 32, 33, 128):
        wave = torch.from_numpy(
            rng.standard_normal((bucket, P)).astype(np.float32))
        for off in range(bucket):
            w = wave.clone()
            w[off] = x[0]
            assert torch.equal(tservice.predict_rows(w, *args)[off], alone), \
                (bucket, off)


def test_chain_sums_is_a_sequential_chain():
    """The per-slot sums are the sequential f32 chain over the rows,
    zero-weight rows adding exact zeros."""
    rng = np.random.default_rng(6)
    m, s, t = 21, 3, 5
    Y = torch.from_numpy(rng.standard_normal((m, t)).astype(np.float32))
    Pr = torch.from_numpy(rng.standard_normal((m, t)).astype(np.float32))
    onehot = torch.zeros(m, s)
    onehot[torch.arange(m), torch.from_numpy(rng.integers(0, s, m))] = 1.0
    onehot[::4] = 0.0
    start = torch.from_numpy(rng.standard_normal((s, 5, t)).astype(
        np.float32))
    got = tservice.chain_sums(start, Y, Pr, onehot)
    want = start.clone()
    for i in range(m):
        terms = torch.stack([Y[i], Pr[i], Y[i] * Y[i], Pr[i] * Pr[i],
                             Y[i] * Pr[i]])
        want = want + onehot[i][:, None, None] * terms[None]
    assert torch.equal(got, want)


def test_predict_columns_matches_reference(fleet_dir):
    b = EncoderBundle.open(str(fleet_dir / "wide"))
    budget = 2 * tregistry.shard_resident_bytes(b, 3, 128) + 64
    treg, jreg = _registries(fleet_dir, ("wide",),
                             device_memory_budget=budget)
    tsvc = EncoderService(treg, wave_buckets=(8, 32))
    jsvc = JService(jreg, wave_buckets=(8, 32))
    X = _problem(7, n=45)[0]
    W = torch.from_numpy(np.concatenate(
        [b.load_weight_shard(i) for i in range(3)], axis=1))
    for window in ((1, 5), (4, 7), (0, 7)):
        got = tsvc.predict_columns("wide", X, window)
        want = jsvc.predict_columns("wide", X, window)
        assert got.shape == (45, window[1] - window[0])
        np.testing.assert_allclose(got, want, **F32)
        full = tsvc.predict_columns("wide", X, (0, 7))
        jsvc.predict_columns("wide", X, (0, 7))
        np.testing.assert_array_equal(got, full[:, window[0]:window[1]])
        np.testing.assert_allclose(
            got, (torch.from_numpy(X) @ W).numpy()[:, window[0]:window[1]],
            **F32)
    assert treg.stats() == jreg.stats()
    with pytest.raises(ServiceError, match="column window"):
        tsvc.predict_columns("wide", X, (3, 3))
    with pytest.raises(ServiceError, match="incompatible"):
        tsvc.predict_columns("wide", X[:, :3], (0, 2))


def test_service_rejects_bad_requests_before_any_compute(fleet_dir):
    treg, _ = _registries(fleet_dir, ("m0", "m1"))
    svc = EncoderService(treg, wave_rows=16)
    good = PredictRequest("m0", _problem(1)[0][:5])
    for bad, match in (
            (PredictRequest("m1", np.zeros((4, P + 1), np.float32)),
             "incompatible"),
            (PredictRequest("m1", np.zeros((0, P), np.float32)),
             "incompatible"),
            (PredictRequest("m1", np.zeros((4, P), np.float32),
                            targets=np.zeros((3, T), np.float32)),
             "targets")):
        with pytest.raises(ServiceError, match=match):
            svc.serve([good, bad])
    assert treg.loaded_names == [] and svc.stats.waves == 0
    for kw in (dict(wave_rows=0), dict(wave_buckets=(0, 4)),
               dict(score_slots=0)):
        with pytest.raises(ServiceError):
            EncoderService(treg, **kw)


@pytest.mark.parametrize("fault", ["truncated", "missing"])
def test_faulty_shard_degrades_only_its_own_tenant(fleet_dir, tmp_path,
                                                   fault):
    import shutil

    root = tmp_path / "fleet"
    for name in ("m0", "m1", "std"):
        shutil.copytree(fleet_dir / name, root / name)
    treg, _ = _registries(root, ("m0", "m1", "std"))
    svc = EncoderService(treg, wave_buckets=(4, 16), score_slots=2)
    reqs = _requests([7, 12, 3, 20, 9], [True, False, True, False, True],
                     ["m0", "m1", "std"], seed=8)
    clean = reference_serve(
        EncoderService(_registries(fleet_dir, ("m0", "m1", "std"))[0],
                       wave_buckets=(4, 16), score_slots=2), reqs)
    b = EncoderBundle.open(str(root / "m1"))
    shard = os.path.join(str(root / "m1"), "step_0",
                         b._leaves()["W/000"]["file"])
    if fault == "truncated":
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) // 2)
    else:
        os.remove(shard)
    out = svc.serve(reqs)
    for q, got, want in zip(reqs, out, clean):
        if q.model == "m1":
            assert isinstance(got.error, BundleError)
            assert got.predictions is None
        else:
            assert got.error is None
            assert np.array_equal(got.predictions, want.predictions)
            if want.pearson_r is not None:
                assert np.array_equal(got.pearson_r, want.pearson_r)
    assert "m1" not in treg.loaded_names
    bad_tenants = [q.tenant for q in reqs if q.model == "m1"]
    assert bad_tenants == ["tenant-1", "tenant-1"]
    assert svc.stats.per_tenant["tenant-1"]["errors"] == 2
    assert svc.stats.per_tenant["tenant-0"]["errors"] == 0
    # The fleet keeps serving the healthy tenants on the next batch.
    again = svc.serve([reqs[0]])
    assert np.array_equal(again[0].predictions, clean[0].predictions)


def test_prefetch_next_matches_non_prefetch(fleet_dir):
    def serve(prefetch):
        treg, _ = _registries(fleet_dir, ("m0", "m1", "std"), wave_rows=16)
        svc = EncoderService(treg, wave_rows=16, prefetch_next=prefetch)
        X = _problem(1, n=10)[0]
        out = svc.serve([PredictRequest(m, X) for m in ("m0", "m1", "std")])
        return out, treg

    plain, _ = serve(False)
    fetched, reg = serve(True)
    for a, b in zip(plain, fetched):
        assert np.array_equal(a.predictions, b.predictions)
    assert reg.loads == 3 and reg.hits >= 2


def test_registry_threads_never_exceed_budget(fleet_dir):
    need = tregistry.bundle_resident_bytes(
        EncoderBundle.open(str(fleet_dir / "m0")), 32)
    budget = int(2.5 * need)
    treg, _ = _registries(fleet_dir, device_memory_budget=budget,
                          wave_rows=32)
    failures = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(20):
                name = MODELS[int(rng.integers(len(MODELS)))]
                assert treg.get(name).weights.shape == (P, T)
                assert treg.resident_bytes <= budget
        except Exception as e:              # noqa: BLE001 - reported below
            failures.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not failures, failures
    assert treg.peak_resident_bytes <= budget and treg.evictions > 0


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

def test_trace_digest_and_payloads_match_reference(tmp_path):
    kw = dict(n_models=4, n_requests=30, p=P, t=T, wave_rows=16)
    t_spec = ttraffic.make_mixed_trace(5, **kw)
    j_spec = jtraffic.make_mixed_trace(5, **kw)
    assert [vars(e) for e in t_spec.entries] == \
        [vars(e) for e in j_spec.entries]
    assert t_spec.digest() == j_spec.digest() == \
        ttraffic.trace_digest(j_spec.entries)
    # Saved by one package, loaded by the other, digest-checked.
    j_back = jtraffic.load_trace(ttraffic.save_trace(
        str(tmp_path / "t.json"), t_spec))
    t_back = ttraffic.load_trace(jtraffic.save_trace(
        str(tmp_path / "j.json"), j_spec))
    assert j_back.digest() == t_back.digest() == t_spec.digest()
    models = [f"m{i}" for i in range(4)]
    for a, b in zip(ttraffic.replay_requests(t_back, models),
                    jtraffic.replay_requests(j_back, models)):
        assert (a.model, a.tenant) == (b.model, b.tenant)
        assert np.array_equal(a.features, b.features)
        assert (a.targets is None) == (b.targets is None)
        if a.targets is not None:
            assert np.array_equal(a.targets, b.targets)
    doc = json.load(open(tmp_path / "t.json"))
    doc["entries"][0][2] += 1
    json.dump(doc, open(tmp_path / "t.json", "w"))
    with pytest.raises(ValueError, match="digest mismatch"):
        ttraffic.load_trace(str(tmp_path / "t.json"))
    with pytest.raises(ValueError, match="trace wants"):
        ttraffic.replay_requests(t_spec, models[:2])


def test_ragged_requests_match_reference():
    models = ["a", "b", "c"]
    got = ttraffic.ragged_requests(np.random.default_rng(3), models, P, 16,
                                   12)
    want = jtraffic.ragged_requests(np.random.default_rng(3), models, P, 16,
                                    12)
    for g, w in zip(got, want):
        assert g.model == w.model
        assert np.array_equal(g.features, w.features)
        assert 8 <= g.features.shape[0] < 32


def test_build_synthetic_fleet_fits_reuses_and_refuses(tmp_path, capsys):
    fleet = ttraffic.build_synthetic_fleet(str(tmp_path), 2, n=120, p=P,
                                           t=T, device="cpu")
    assert [name for name, _ in fleet] == ["sub-01", "sub-02"]
    b = EncoderBundle.open(fleet[0][1])
    assert b.shape == (P, T) and b.has_standardizer
    assert JBundle.open(fleet[1][1]).shape == (P, T)
    again = ttraffic.build_synthetic_fleet(str(tmp_path), 2, n=120, p=P,
                                           t=T, device="cpu")
    assert again == fleet and "reusing bundle" in capsys.readouterr().out
    with pytest.raises(ValueError, match="shape"):
        ttraffic.build_synthetic_fleet(str(tmp_path), 1, n=120, p=P + 1,
                                       t=T, device="cpu")


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------

def test_residency_map_publish_expire_and_lock_timeout(tmp_path):
    clock = [100.0]
    rmap = ResidencyMap(str(tmp_path / "residency.json"),
                        clock=lambda: clock[0], sleep=lambda s: None,
                        lock_timeout_s=0.0)
    rmap.publish("w0", {"m0": 10, "m1": 5}, loads=2)
    clock[0] = 150.0
    rmap.publish("w1", {"m1": 7})
    snap = rmap.snapshot()
    assert snap["workers"]["w0"]["resident_bytes"] == 15
    assert rmap.holders("m1") == ["w0", "w1"]
    assert rmap.holders("m1", ttl_s=20.0) == ["w1"]
    assert rmap.fleet_resident_bytes() == 22
    assert rmap.expire_dead(20.0) == ["w0"]
    assert list(rmap.snapshot()["workers"]) == ["w1"]
    rmap.heartbeat("w2")
    assert rmap.snapshot()["workers"]["w2"]["models"] == {}
    rmap.retire("w1")
    assert sorted(rmap.snapshot()["workers"]) == ["w2"]
    import fcntl
    fd = os.open(str(tmp_path / "residency.json.lock"), os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_EX)
    try:
        with pytest.raises(tfleet.FleetError, match="could not acquire"):
            rmap.publish("w3", {})
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def test_fleet_registry_publishes_loads_and_evictions(fleet_dir, tmp_path):
    need = tregistry.bundle_resident_bytes(
        EncoderBundle.open(str(fleet_dir / "m0")), 16)
    rmap = ResidencyMap(str(tmp_path / tfleet.RESIDENCY_MAP))
    reg = FleetRegistry(worker_id="w0", residency_map=rmap,
                        device_memory_budget=int(1.5 * need), wave_rows=16,
                        device="cpu")
    for name in ("m0", "m1", "wide"):
        reg.add(name, str(fleet_dir / name))
    reg.get("m0")
    assert rmap.holders("m0") == ["w0"]
    reg.get("m1")                                   # evicts m0
    row = rmap.snapshot()["workers"]["w0"]
    assert list(row["models"]) == ["m1"] and row["evictions"] == 1
    reg.get_columns("wide", (0, 2))                 # evicts m1
    assert list(rmap.snapshot()["workers"]["w0"]["models"]) == \
        ["wide#shard0"]
    reg.evict("wide")
    assert rmap.snapshot()["workers"]["w0"]["models"] == {}
    reg.close()
    assert rmap.snapshot()["workers"] == {}


def _frontend(fleet_dir, max_pending_rows):
    treg, _ = _registries(fleet_dir, ("m0", "m1"), wave_rows=16)
    svc = EncoderService(treg, wave_rows=16)
    return FleetFrontend(svc, max_pending_rows=max_pending_rows), svc


def test_frontend_backpressure_rejects_typed(fleet_dir):
    fe, svc = _frontend(fleet_dir, max_pending_rows=30)
    X = np.zeros((20, P), np.float32)
    fe.submit(PredictRequest("m0", X, tenant="a"))
    with pytest.raises(ServiceError, match="admission rejected"):
        fe.submit(PredictRequest("m1", X, tenant="b"))
    assert fe.rejected == 1 and fe.pending_rows == 20
    assert svc.stats.per_tenant["b"]["rejected"] == 1
    out = fe.flush()
    assert len(out) == 1 and out[0].error is None
    fe.submit(PredictRequest("m1", X, tenant="b"))
    assert fe.pending_rows == 20
    with pytest.raises(ServiceError, match="max_pending_rows"):
        FleetFrontend(svc, max_pending_rows=0)


def test_frontend_replay_drains_and_matches_direct_serve(fleet_dir):
    fe, svc = _frontend(fleet_dir, max_pending_rows=64)
    reqs = _requests([int(r) for r in
                      np.random.default_rng(0).integers(5, 40, 12)],
                     [i % 3 == 0 for i in range(12)], ["m0", "m1"], seed=9)
    results, rejections = tfleet.replay(fe, reqs)
    assert rejections and fe.pending_rows == 0
    alone = reference_serve(_frontend(fleet_dir, 64)[1], reqs)
    for got, want in zip(results, alone):
        assert got.error is None
        assert np.array_equal(got.predictions, want.predictions)
        if want.pearson_r is not None:
            assert np.array_equal(got.pearson_r, want.pearson_r)
    assert svc.stats.rows == sum(q.features.shape[0] for q in reqs)


def test_frontend_readmits_a_batch_lost_with_its_worker(fleet_dir):
    fe, svc = _frontend(fleet_dir, max_pending_rows=100)
    serve = svc.serve
    calls = {"n": 0}

    def flaky(batch, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise WorkerLost("worker died mid-flight")
        return serve(batch, **kw)

    svc.serve = flaky
    reqs = _requests([6, 9], [False, True], ["m0", "m1"], seed=10)
    results, rejections = fe.replay(reqs)
    assert not rejections and fe.replayed == 2 and calls["n"] == 2
    assert all(r is not None and r.error is None for r in results)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_row_bits_and_packed_serve(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wave products run on cuBLAS")
    reg = EncoderRegistry(device="cuda")
    for i, name in enumerate(MODELS):
        X, Y = _problem(20 + i)
        state = tpipeline.run_stages(
            X + i, Y - i, [tpipeline.split(seed=i), tpipeline.standardize(),
                           tpipeline.fit(n_folds=3, device="cpu")],
            device="cpu")
        reg.add(name, state.encoder.save(str(tmp_path / name),
                                         weight_shards=1 + i % 2))
    e = reg.get("std")
    args = (e.weights, e.mu_x, e.sd_x, e.mu_y, e.sd_y)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((1, P)).astype(
        np.float32)).cuda()
    alone = tservice.predict_rows(x, *args)[0]
    for bucket in (1, 32, 33, 128):
        wave = torch.randn(bucket, P, device="cuda")
        for off in range(bucket):
            w = wave.clone()
            w[off] = x[0]
            assert torch.equal(tservice.predict_rows(w, *args)[off], alone)
    rows = [5, 1, 17, 8, 3, 30, 2, 11, 40]
    scored = [True, False, True, True, False, True, True, False, True]
    reqs = _requests(rows, scored, list(MODELS), seed=12)
    svc = EncoderService(reg, wave_buckets=(8, 32), score_slots=2)
    packed = svc.serve(reqs)
    alone_out = reference_serve(EncoderService(reg, wave_buckets=(8, 32),
                                               score_slots=2), reqs)
    for got, want in zip(packed, alone_out):
        assert np.array_equal(got.predictions, want.predictions)
        if want.pearson_r is not None:
            assert np.array_equal(got.pearson_r, want.pearson_r)
