"""The multi-device slice held against the reference: B-MOR and dual B-MOR,
distributed MOR, the sharded streamed finalize and the target-sharded
bundle load, on the CPU.

The parent writes every input with numpy from fixed seeds.  Two runs then
go at once, each in its own processes:

* the reference, ONE subprocess with 8 virtual JAX devices, calls
  ``repro.core.bmor.bmor_fit``/``bmor_fit_dual``,
  ``repro.core.mor.mor_fit_distributed``,
  ``repro.core.foldstats.compute_sharded_chunked(mesh=)`` and the bundle's
  sharded load on them (``bmor_fit`` directly for the padded layout: the
  reference's estimator fails there, slicing a target-sharded W);
* the port, ONE 8-rank gloo world (``file://`` rendezvous, one process
  and one thread a rank), runs ``BrainEncoder`` and the functions of
  ``repro_torch.core.bmor``/``mor`` on the same inputs.

Each check of the reference's ``tests/helpers/encoder_checks.py`` and
``distributed_checks.py`` is one test case on those results, with the
port's tolerances (``tests/test_kernels.py::_tol``: f32 rtol 1e-4 / atol
2e-4, bf16 2e-2; the streamed bf16 case keeps the reference's 5e-2).  λ
is equal; no parity is taken on eigenvectors.  Every spawn has its own
time limit and fails rather than hangs.

    python tests/test_torch_distributed.py --worker RANK WORLD INIT IN OUT
    python tests/test_torch_distributed.py --reference IN OUT
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
SPAWN_TIMEOUT_S = 150
F32 = dict(rtol=1e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


# -- inputs ------------------------------------------------------------------
def make_problem(seed: int, n: int, p: int, t: int, noise: float = 0.01):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    W = (rng.standard_normal((p, t)) / np.sqrt(p)).astype(np.float32)
    Y = (X @ W + noise * rng.standard_normal((n, t))).astype(np.float32)
    return X, Y


def perbatch_problem():
    """Clean targets in batch 0, pure noise in batch 1 (per-batch λ)."""
    rng = np.random.default_rng(9)
    X = rng.standard_normal((60, 12)).astype(np.float32)
    W = rng.standard_normal((12, 8)).astype(np.float32)
    clean = X @ W + 0.001 * rng.standard_normal((60, 8))
    noisy = 5.0 * rng.standard_normal((60, 8))
    return X, np.concatenate([clean, noisy], axis=1).astype(np.float32)


def write_inputs(root: str) -> str:
    import torch

    from repro_torch.data.store import RunStore

    arrays = {}
    for name, args in (("auto", (0, 128, 16, 64)), ("dual", (1, 40, 96, 16)),
                       ("pad", (2, 96, 12, 30)), ("round", (3, 101, 8, 16)),
                       ("bundle", (5, 256, 24, 64)), ("pod", (7, 48, 8, 16)),
                       ("mor", (8, 40, 8, 16))):
        arrays[f"{name}_X"], arrays[f"{name}_Y"] = make_problem(*args)
    arrays["bundle_Xnew"] = np.random.default_rng(6).standard_normal(
        (96, 24)).astype(np.float32)
    arrays["perbatch_X"], arrays["perbatch_Y"] = perbatch_problem()
    X, Y = make_problem(4, 409, 16, 8, noise=0.3)
    for tag, dt, offset in (("f32", torch.float32, 3.0),
                            ("bf16", torch.bfloat16, 0.0)):
        store = RunStore.create(os.path.join(root, f"store_{tag}"),
                                n_folds=5, dtype=dt)
        Xs = torch.from_numpy(X).to(dt)
        Ys = torch.from_numpy(Y + offset).to(dt)
        store.write(Xs[:250], Ys[:250], "r1")
        store.write(Xs[250:], Ys[250:], "r2")
    path = os.path.join(root, "inputs.npz")
    np.savez(path, **arrays)
    return path


# -- the reference (8 virtual JAX devices) -----------------------------------
def run_reference(inputs: str, out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.core import bmor, foldstats, mor, ridge
    from repro.core.ridge import RidgeCVConfig
    from repro.data.store import RunStore
    from repro.encoding import BrainEncoder, EncoderConfig, resolve

    assert jax.device_count() == WORLD, jax.device_count()
    a = dict(np.load(inputs))
    res = {}

    def bmor_at(tag, X, Y, shape, names, data_axis, cfg):
        mesh = jax.make_mesh(shape, names)
        Xs = jax.device_put(jnp.asarray(X), NamedSharding(
            mesh, P(data_axis, None)))
        Ys = jax.device_put(jnp.asarray(Y), NamedSharding(
            mesh, P(data_axis, names[-1])))
        r = bmor.bmor_fit(Xs, Ys, mesh, data_axis=data_axis, cfg=cfg)
        res[f"{tag}_W"] = np.asarray(r.weights)
        res[f"{tag}_lam"] = np.asarray(r.best_lambda)
        res[f"{tag}_cv"] = np.asarray(r.cv_scores)

    # auto → B-MOR, at the layout the reference's dispatch picks.
    cfg = EncoderConfig(n_folds=4)
    d = resolve(cfg, 128, 16, 64, WORLD)
    res["auto_layout"] = np.array([d.data_shards, d.target_shards])
    bmor_at("auto", a["auto_X"], a["auto_Y"],
            (d.data_shards, d.target_shards), ("data", "model"), "data",
            cfg.ridge_cv_config("eigh"))
    # auto → dual B-MOR.
    d = resolve(cfg, 40, 96, 16, WORLD)
    res["dual_layout"] = np.array([d.data_shards, d.target_shards])
    mesh = jax.make_mesh((1, d.target_shards), ("data", "model"))
    Ys = jax.device_put(jnp.asarray(a["dual_Y"]),
                        NamedSharding(mesh, P(None, "model")))
    r = bmor.bmor_fit_dual(jnp.asarray(a["dual_X"]), Ys, mesh,
                           cfg=cfg.ridge_cv_config("dual"))
    res["dual_W"], res["dual_lam"], res["dual_cv"] = (
        np.asarray(r.weights), np.asarray(r.best_lambda),
        np.asarray(r.cv_scores))
    # The padded 2×4 layout on t = 30, zero-padded to 32 as ShardingPlan
    # does; the reference's estimator fails slicing W, so bmor_fit direct.
    Y = np.concatenate([a["pad_Y"], np.zeros((96, 2), np.float32)], axis=1)
    bmor_at("pad", a["pad_X"], Y, (2, 4), ("data", "model"), "data",
            EncoderConfig(n_folds=3).ridge_cv_config("eigh"))
    res["pad_W"] = res["pad_W"][:, :30]
    # Row rounding: 101 rows on 4 data shards keep 100.
    bmor_at("round", a["round_X"][:100], a["round_Y"][:100], (4, 2),
            ("data", "model"), "data",
            EncoderConfig(n_folds=3).ridge_cv_config("eigh"))
    # The (pod, data, model) axes.
    bmor_at("pod", a["pod_X"], a["pod_Y"], (2, 2, 2),
            ("pod", "data", "model"), ("pod", "data"),
            RidgeCVConfig(n_folds=3))
    # Per-batch λ, at the port's (4, 2) layout.
    bmor_at("perbatch", a["perbatch_X"], a["perbatch_Y"], (4, 2),
            ("data", "model"), "data", RidgeCVConfig(n_folds=3))
    # Distributed MOR.
    res["mor_W"] = np.asarray(mor.mor_fit_distributed(
        jnp.asarray(a["mor_X"]), jnp.asarray(a["mor_Y"]),
        jax.make_mesh((1, WORLD), ("data", "model")),
        cfg=RidgeCVConfig(n_folds=4, lambdas=(0.1, 1.0, 100.0))))
    # The sharded streamed finalize over 8 row windows, and the in-memory
    # fit of the same rows.
    root = os.path.dirname(inputs)
    mesh = jax.make_mesh((WORLD,), ("data",))
    for tag in ("f32", "bf16"):
        store = RunStore.open(os.path.join(root, f"store_{tag}"))
        n = store.shape[0]
        streams = [store.iter_chunks(37, row_range=w)
                   for w in foldstats.shard_row_ranges(n, WORLD)]
        stats = foldstats.compute_sharded_chunked(
            streams, n, 5, mesh=mesh, chunk_rows=37)
        r = ridge.ridge_cv_from_stats(
            stats, EncoderConfig(n_folds=5).ridge_cv_config("eigh"))
        res[f"stream_{tag}_W"] = np.asarray(r.weights)
        res[f"stream_{tag}_lam"] = np.asarray(r.best_lambda)
        X, Y = store.load()
        enc = BrainEncoder(n_folds=5, solver="ridge", method="eigh").fit(
            jnp.asarray(X), jnp.asarray(Y))
        res[f"stream_{tag}_mem_W"] = np.asarray(enc.weights_)
        res[f"stream_{tag}_mem_lam"] = enc.report_.best_lambda
    # The bundle's sharded load, f32 and bf16 weights.
    enc = BrainEncoder(n_folds=4, solver="ridge", method="eigh").fit(
        jnp.asarray(a["bundle_X"]), jnp.asarray(a["bundle_Y"]))
    for tag, wdt in (("f32", None), ("bf16", "bfloat16")):
        path = os.path.join(out, f"ref_bundle_{tag}")
        enc.save(path, weight_shards=WORLD, weight_dtype=wdt)
        sharded = BrainEncoder.load(path, target_shards=WORLD)
        res[f"bundle_{tag}_pred"] = np.asarray(
            sharded.predict(jnp.asarray(a["bundle_Xnew"])))
    np.savez(os.path.join(out, "reference.npz"), **res)


# -- the port (one rank of an 8-rank gloo world) -----------------------------
def run_rank(rank: int, world: int, init: str, inputs: str,
             out: str) -> None:
    import torch

    torch.set_num_threads(1)
    from repro_torch.core import bmor, compat, mor
    from repro_torch.core.foldstats import compute_sharded_chunked
    from repro_torch.core.ridge import RidgeCVConfig
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder, ShardingPlan

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dev = compat.init_from_env("cpu", init_method=init, timeout_s=90)
    a = dict(np.load(inputs))
    res: dict = {}
    msgs: dict = {}

    def keep(tag, enc):
        r = enc.report_
        res[f"{tag}_W"] = enc.weights_.numpy()
        res[f"{tag}_lam"] = r.best_lambda
        res[f"{tag}_cv"] = r.cv_scores
        d = r.decision
        msgs[f"{tag}_decision"] = [d.solver, d.method, d.data_shards,
                                   d.target_shards]

    def enc(**kw):
        return BrainEncoder(device=dev, **kw)

    keep("auto", enc(n_folds=4).fit(a["auto_X"], a["auto_Y"]))
    keep("dual", enc(n_folds=4).fit(a["dual_X"], a["dual_Y"]))
    keep("pad", enc(solver="bmor", data_shards=2, target_shards=4,
                    n_folds=3).fit(a["pad_X"], a["pad_Y"]))
    keep("round", enc(solver="bmor", data_shards=4, target_shards=2,
                      n_folds=3).fit(a["round_X"], a["round_Y"]))

    # The (pod, data, model) axes and per-batch λ, through bmor_fit.
    def bmor_at(tag, X, Y, shape, names, data_axis, cfg):
        mesh = compat.make_mesh(shape, names, device=dev)
        plan = ShardingPlan(data_shards=mesh.size(data_axis),
                            target_shards=shape[-1], data_axis=data_axis,
                            target_axis=names[-1])
        X_l, Y_l = plan.place(mesh, X, Y)
        r = bmor.bmor_fit(X_l, Y_l, mesh, data_axis=data_axis,
                          target_axis=names[-1], cfg=cfg)
        res[f"{tag}_W"] = r.weights.numpy()
        res[f"{tag}_lam"] = r.best_lambda.numpy()
        res[f"{tag}_cv"] = r.cv_scores.numpy()

    bmor_at("pod", a["pod_X"], a["pod_Y"], (2, 2, 2),
            ("pod", "data", "model"), ("pod", "data"),
            RidgeCVConfig(n_folds=3))
    bmor_at("perbatch", a["perbatch_X"], a["perbatch_Y"], (4, 2),
            ("data", "model"), "data", RidgeCVConfig(n_folds=3))

    # Distributed MOR: the function, and the estimator's sharded plan.
    mor_cfg = RidgeCVConfig(n_folds=4, lambdas=(0.1, 1.0, 100.0))
    mesh = compat.make_mesh((1, world), ("data", "model"), device=dev)
    plan = ShardingPlan(data_shards=1, target_shards=world)
    X_l, Y_l = plan.place(mesh, a["mor_X"], a["mor_Y"])
    res["mor_W"] = mor.mor_fit_distributed(X_l, Y_l, mesh,
                                           cfg=mor_cfg).numpy()
    keep("mor_est", enc(solver="mor", target_shards=world, n_folds=4,
                        lambdas=(0.1, 1.0, 100.0)).fit(a["mor_X"],
                                                       a["mor_Y"]))
    try:
        enc(solver="mor", target_shards=world, mor_taskwise=True).fit(
            a["mor_X"], a["mor_Y"])
    except ValueError as e:
        msgs["mor_taskwise"] = str(e)

    # The sharded streamed fit over 8 row windows, and the in-memory fit.
    root = os.path.dirname(inputs)
    for tag in ("f32", "bf16"):
        store = RunStore.open(os.path.join(root, f"store_{tag}"))
        e = enc(n_folds=5, device_memory_budget=1, chunk_rows=37)
        keep(f"stream_{tag}", e.fit(store=store))
        msgs[f"stream_{tag}_compiles"] = e.stream_stats_["compile_count"]
        keep(f"stream_{tag}_mem", enc(n_folds=5, solver="ridge",
                                      method="eigh").fit(*store.load()))
    # A mesh axis whose size differs from the stream count.
    try:
        compute_sharded_chunked([iter(())] * 3, 409, 5,
                                mesh=compat.make_mesh((world,), ("data",),
                                                      device=dev),
                                device=dev)
    except ValueError as e:
        msgs["stream_mismatch"] = str(e)

    # The bundle: saved by rank 0, loaded unsharded and target-sharded.
    fitted = enc(n_folds=4, solver="ridge", method="eigh").fit(
        a["bundle_X"], a["bundle_Y"])
    Xnew = torch.from_numpy(a["bundle_Xnew"])
    res["bundle_fit_pred"] = fitted.predict(Xnew).numpy()
    W = fitted.weights_
    res["bundle_cast_pred"] = (Xnew @ W.to(torch.bfloat16).float()).numpy()
    for tag, wdt in (("f32", None), ("bf16", "bfloat16")):
        path = os.path.join(out, f"bundle_{tag}")
        fitted.save(path, overwrite=True, weight_shards=world,
                    weight_dtype=wdt)
        whole = BrainEncoder.load(path, device=dev)
        sharded = BrainEncoder.load(path, target_shards=world, device=dev)
        res[f"bundle_{tag}_whole_pred"] = whole.predict(Xnew).numpy()
        res[f"bundle_{tag}_pred"] = sharded.predict(Xnew).numpy()
        res[f"bundle_{tag}_whole_W"] = whole.weights_.float().numpy()
        res[f"bundle_{tag}_W"] = sharded.weights_.float().numpy()
        res[f"bundle_{tag}_block_cols"] = np.array(
            sharded.report_.weights.shape)
    # The registry's sharded residency: its account, and the sharded
    # encoder it serves from.
    from repro_torch.serving_encoders import EncoderRegistry
    from repro_torch.serving_encoders.registry import bundle_resident_bytes
    reg = EncoderRegistry(target_shards=world, device=dev)
    bundle = reg.add("m", os.path.join(out, "bundle_f32"))
    entry = reg.get("m")
    res["registry_pred"] = entry.encoder.predict(Xnew).numpy()
    res["registry_charge"] = np.array(
        [entry.resident_bytes, bundle_resident_bytes(bundle, 128, world)])
    try:
        BrainEncoder.load(os.path.join(out, "bundle_f32"), target_shards=3,
                          device=dev)
    except Exception as e:                  # noqa: BLE001 — recorded
        msgs["bundle_indivisible"] = f"{type(e).__name__}: {e}"

    # A layout wider than the world.
    try:
        ShardingPlan(data_shards=4, target_shards=4).build_mesh(dev)
    except ValueError as e:
        msgs["too_wide"] = str(e)
    try:
        enc(solver="bmor", data_shards=4, target_shards=4).fit(
            a["auto_X"], a["auto_Y"])
    except ValueError as e:
        msgs["too_wide_fit"] = str(e)
    res["messages"] = np.array(json.dumps(msgs))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    compat.shutdown()


# -- the two runs, once per session ------------------------------------------
def _spawn(argv: list[str], env: dict, log: str) -> subprocess.Popen:
    f = open(log, "w")
    try:
        return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 *argv], env=env, stdout=f,
                                stderr=subprocess.STDOUT, cwd=REPO)
    finally:
        f.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    inputs = write_inputs(root)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{WORLD}")
    init = "file://" + os.path.join(root, "rendezvous")
    procs = {"reference": _spawn(["--reference", inputs, root], ref_env,
                                 os.path.join(root, "reference.log"))}
    for r in range(WORLD):
        procs[f"rank{r}"] = _spawn(
            ["--worker", str(r), str(WORLD), init, inputs, root], env,
            os.path.join(root, f"rank{r}.log"))
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    failed = []
    try:
        for name, p in procs.items():
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((name, rc))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        logs = "\n".join(
            f"--- {name} ({rc}) ---\n"
            + open(os.path.join(root, f"{name}.log")).read()[-4000:]
            for name, rc in failed)
        pytest.fail(f"spawned runs failed: {failed}\n{logs}")
    ref = dict(np.load(os.path.join(root, "reference.npz")))
    ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
             for r in range(WORLD)]
    for r in ranks:
        r["messages"] = json.loads(str(r["messages"]))
    return {"ref": ref, "ranks": ranks, "inputs": dict(np.load(inputs)),
            "inputs_path": inputs}


def _same_on_every_rank(runs, key):
    """Every rank ends with the same full result, bit for bit."""
    first = runs["ranks"][0][key]
    for r in runs["ranks"][1:]:
        assert np.array_equal(r[key], first, equal_nan=True), key
    return first


def _held(runs, tag, tol=F32):
    ref = runs["ref"]
    W = _same_on_every_rank(runs, f"{tag}_W")
    lam = _same_on_every_rank(runs, f"{tag}_lam")
    np.testing.assert_array_equal(lam, ref[f"{tag}_lam"])
    np.testing.assert_allclose(W, ref[f"{tag}_W"], **tol)
    if f"{tag}_cv" in ref:
        cv = _same_on_every_rank(runs, f"{tag}_cv")
        np.testing.assert_allclose(cv, ref[f"{tag}_cv"], **tol)
    return W, lam


def test_auto_resolves_bmor_primal(runs):
    W, lam = _held(runs, "auto")
    msgs = runs["ranks"][0]["messages"]
    c_d, c_t = runs["ref"]["auto_layout"].tolist()
    assert msgs["auto_decision"] == ["bmor", "eigh", c_d, c_t]
    assert W.shape == (16, 64) and lam.shape == (c_t,)


def test_auto_resolves_bmor_dual(runs):
    import torch

    from repro_torch.core import ridge

    W, lam = _held(runs, "dual")
    c_t = int(runs["ref"]["dual_layout"][1])
    assert runs["ranks"][0]["messages"]["dual_decision"] == [
        "bmor_dual", "dual", 1, c_t]
    # Each batch against the one-device dual solve at its own λ.
    X = torch.from_numpy(runs["inputs"]["dual_X"])
    Y = torch.from_numpy(runs["inputs"]["dual_Y"])
    cfg = ridge.RidgeCVConfig(n_folds=4, method="dual")
    f = ridge.factorize(X, cfg)
    width = Y.shape[1] // c_t
    for i, lam_i in enumerate(lam):
        cols = slice(i * width, (i + 1) * width)
        W_ref = ridge.solve(f, Y[:, cols], torch.tensor(lam_i,
                                                        dtype=torch.float32),
                            X=X)
        np.testing.assert_allclose(W[:, cols], W_ref.numpy(), **F32)


def test_padded_2x4_layout(runs):
    """t = 30 on 4 target shards: padded to 32, sliced back — the check
    the reference's own estimator fails."""
    W, lam = _held(runs, "pad")
    assert W.shape == (12, 30) and lam.shape == (4,)
    assert runs["ranks"][0]["messages"]["pad_decision"] == [
        "bmor", "eigh", 2, 4]


def test_row_rounding_4x2(runs):
    W, _ = _held(runs, "round")
    assert W.shape == (8, 16)


def test_multipod_axes(runs):
    _held(runs, "pod")


def test_distributed_mor(runs):
    W = _same_on_every_rank(runs, "mor_W")
    np.testing.assert_allclose(W, runs["ref"]["mor_W"], **F32)
    np.testing.assert_array_equal(_same_on_every_rank(runs, "mor_est_W"), W)
    msgs = runs["ranks"][0]["messages"]
    assert msgs["mor_est_decision"] == ["mor", "eigh", 1, WORLD]
    assert "mor_taskwise=True is incompatible" in msgs["mor_taskwise"]


def test_per_batch_lambda(runs):
    _, lam = _held(runs, "perbatch")
    assert lam[0] <= 1.0 and lam[1] >= 100.0, lam


@pytest.mark.parametrize("tag,tol", [("f32", F32),
                                     ("bf16", dict(rtol=5e-2, atol=5e-2))])
def test_sharded_streamed_parity(runs, tag, tol):
    """8 row windows, one per rank, one psum of the stacked [G|C]: λ equal
    to the in-memory fit and to the reference's sharded finalize."""
    msgs = runs["ranks"][0]["messages"]
    assert msgs[f"stream_{tag}_decision"] == ["ridge", "chunked", WORLD, 1]
    assert msgs[f"stream_{tag}_compiles"] == 1
    W, lam = _held(runs, f"stream_{tag}", tol)
    W_mem = _same_on_every_rank(runs, f"stream_{tag}_mem_W")
    np.testing.assert_array_equal(
        lam, _same_on_every_rank(runs, f"stream_{tag}_mem_lam"))
    np.testing.assert_allclose(W, W_mem, **tol)
    np.testing.assert_allclose(W_mem, runs["ref"][f"stream_{tag}_mem_W"],
                               **tol)
    assert "has 8 shards but 3 shard streams" in msgs["stream_mismatch"]


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_sharded_bundle_load_bitwise(runs, tag):
    """Each rank holds its column block; predict gathers the columns and
    equals the unsharded load bit for bit."""
    r0 = runs["ranks"][0]
    assert r0[f"bundle_{tag}_block_cols"].tolist() == [24, 64 // WORLD]
    pred = _same_on_every_rank(runs, f"bundle_{tag}_pred")
    whole = _same_on_every_rank(runs, f"bundle_{tag}_whole_pred")
    assert np.array_equal(pred.view(np.int32), whole.view(np.int32))
    assert np.array_equal(_same_on_every_rank(runs, f"bundle_{tag}_W"),
                          r0[f"bundle_{tag}_whole_W"])
    want = r0["bundle_fit_pred" if tag == "f32" else "bundle_cast_pred"]
    assert np.array_equal(pred.view(np.int32), want.view(np.int32))
    # Against the reference's own fit and sharded load: its W differs in
    # the last bits, which can round a weight to the next bf16 value.
    np.testing.assert_allclose(pred, runs["ref"][f"bundle_{tag}_pred"],
                               **(F32 if tag == "f32" else BF16))
    assert "do not divide over target_shards=3" in \
        r0["messages"]["bundle_indivisible"]


def test_sharded_registry(runs):
    """``EncoderRegistry(target_shards=8)`` charges the reference's
    per-device account and serves from the sharded load, bitwise."""
    from repro.serving_encoders import EncoderBundle as JBundle
    from repro.serving_encoders.registry import \
        bundle_resident_bytes as jcharge

    r0 = runs["ranks"][0]
    pred = _same_on_every_rank(runs, "registry_pred")
    assert np.array_equal(pred.view(np.int32),
                          r0["bundle_f32_whole_pred"].view(np.int32))
    got, want = r0["registry_charge"].tolist()
    assert got == want
    # The same number from the reference's account of the same bundle.
    root = os.path.join(os.path.dirname(runs["inputs_path"]), "bundle_f32")
    assert want == jcharge(JBundle.open(root), 128, WORLD)


def test_layout_wider_than_world_raises(runs):
    msgs = runs["ranks"][0]["messages"]
    assert "plan wants 16 devices, have 8" in msgs["too_wide"]
    assert "pinned layout 4x4 needs more than the 8 available" in \
        msgs["too_wide_fit"]


# -- in-process: the pure dispatch and the refusals --------------------------
SHAPES = [(4096, 64, 2048), (128, 16, 64), (40, 96, 16), (100, 10, 5),
          (7, 3, 40)]


@pytest.mark.parametrize("n,p,t", SHAPES)
@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_best_bmor_layout_matches_reference(n, p, t, devices):
    from repro.core.complexity import RidgeWorkload as JWorkload
    from repro.encoding import dispatch as jdispatch
    from repro_torch.core.complexity import RidgeWorkload
    from repro_torch.encoding import dispatch

    for pins in ((None, None), (1, None), (None, devices), (devices, 1)):
        got = dispatch._best_bmor_layout(RidgeWorkload(n=n, p=p, t=t, r=11),
                                         devices, *pins)
        want = jdispatch._best_bmor_layout(JWorkload(n=n, p=p, t=t, r=11),
                                           devices, *pins)
        assert got == want, (pins, got, want)


@pytest.mark.parametrize("solver", ["auto", "bmor", "bmor_dual"])
@pytest.mark.parametrize("n,p,t", SHAPES)
def test_dispatch_matches_reference_on_eight_devices(solver, n, p, t):
    from repro.encoding import EncoderConfig as JConfig
    from repro.encoding import resolve as jresolve
    from repro_torch.encoding import EncoderConfig, dispatch

    got = dispatch.resolve(EncoderConfig(solver=solver), n, p, t, WORLD,
                           device="cpu")
    want = jresolve(JConfig(solver=solver), n, p, t, WORLD)
    assert (got.solver, got.method, got.data_shards, got.target_shards,
            got.predicted_cost) == (want.solver, want.method,
                                    want.data_shards, want.target_shards,
                                    want.predicted_cost)
    assert got.rationale.split("; kernel tier")[0] == \
        want.rationale.split("; kernel tier")[0]


def test_dispatch_cost_sanity():
    """The §3 model ranks the auto layout no worse than every divisor
    layout it rejected (the reference's ``check_dispatch_cost_sanity``)."""
    from repro_torch.core import complexity
    from repro_torch.encoding import EncoderConfig, dispatch

    cfg = EncoderConfig()
    n, p, t = 4096, 64, 2048
    d = dispatch.resolve(cfg, n, p, t, WORLD, device="cpu")
    w = complexity.RidgeWorkload(n=n, p=p, t=t, r=len(cfg.lambdas))
    for c_d in (1, 2, 4, 8):
        assert d.predicted_cost <= complexity.t_bmor_sharded(
            w, c_d, WORLD // c_d) + 1e-9, c_d


@pytest.mark.parametrize("n_total,n_folds,lo,hi", [
    (101, 5, 0, 26), (101, 5, 26, 77), (101, 5, 75, 101), (40, 4, 12, 18),
    (409, 5, 51, 102)])
def test_partial_fold_stats_matches_reference(n_total, n_folds, lo, hi):
    """A rank's window [lo, hi) of the global rows: fold ids as the
    reference computes them, and the per-fold partials (one product over
    the window's fold runs) against the reference's masked products; a
    fold the window misses is exact zeros."""
    import jax.numpy as jnp
    import torch

    from repro.core import foldstats as jfs
    from repro_torch.core import foldstats as tfs

    X, Y = make_problem(11, n_total, 6, 3)
    rows = np.arange(lo, hi)
    t_ids = tfs.fold_of_rows(torch.from_numpy(rows), n_total, n_folds)
    j_ids = jfs.fold_of_rows(jnp.asarray(rows), n_total, n_folds)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    G, C = tfs.partial_fold_stats(torch.from_numpy(X[lo:hi]),
                                  torch.from_numpy(Y[lo:hi]), t_ids, n_folds)
    jG, jC = jfs.partial_fold_stats(jnp.asarray(X[lo:hi]),
                                    jnp.asarray(Y[lo:hi]), j_ids, n_folds)
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), **F32)
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), **F32)
    for f in set(range(n_folds)) - set(t_ids.tolist()):
        assert not G[f].any() and not C[f].any()
    with pytest.raises(ValueError, match="non-decreasing"):
        tfs.partial_fold_stats(torch.from_numpy(X[:4]), torch.from_numpy(
            Y[:4]), torch.tensor([0, 1, 0, 1]), n_folds)


@pytest.mark.parametrize("coll", [0.0, 3.2e9, 4.5e12])
def test_roofline_collective_term_matches_reference(coll):
    """The collective term over one link rate: the reference's
    ``ici_bw · ici_links``, NVLink's data-sheet rate by default (the
    port's ``hlo_analysis.roofline_terms``, which ``encoding_roofline``
    calls)."""
    from repro.launch.hlo_analysis import roofline_terms as jterms
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch import roofline_report as rr

    got = ha.roofline_terms(1e12, 2e11, coll, peak_flops=67e12,
                            hbm_bw=3.35e12)
    want = jterms(1e12, 2e11, coll, peak_flops=67e12, hbm_bw=3.35e12,
                  ici_bw=rr.H100_NVLINK_BW, ici_links=1)
    assert got == pytest.approx(want) and got.keys() == want.keys()
    assert got["t_collective_s"] == coll / 900e9


def test_mesh_without_process_group_raises():
    from repro_torch.core import compat
    from repro_torch.encoding import BrainEncoder

    assert not compat.is_initialized() and compat.device_count() == 1
    with pytest.raises(RuntimeError, match="no torch.distributed process "
                                           "group"):
        compat.make_mesh((1, 1), ("data", "model"), device="cpu")
    X, Y = make_problem(0, 32, 4, 6)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        BrainEncoder(solver="bmor", device="cpu").fit(X, Y)


def test_nccl_on_cpu_raises(monkeypatch):
    from repro_torch.core import compat

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="nccl backend runs on CUDA"):
        compat.init_from_env("cpu", "nccl")
    assert not compat.is_initialized()


def _main(argv: list[str]) -> int:
    try:
        if argv[0] == "--worker":
            run_rank(int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5])
        elif argv[0] == "--reference":
            run_reference(argv[1], argv[2])
        else:
            raise SystemExit(f"unknown mode {argv[0]!r}")
    except Exception:                       # noqa: BLE001 — exit code
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
