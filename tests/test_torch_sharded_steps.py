"""The sharded train, prefill and decode steps (``launch/steps.py`` over a
mesh) held against the one-device port step and the reference's sharded
step, on the CPU.

The parent draws every parameter tree with the reference's ``model.init``
and every batch with numpy, from fixed seeds, and writes them to disk.
Three runs then go at once, each in its own processes:

* the port, ONE 8-rank gloo world (one process a rank): each rank places
  the same numpy weights on its mesh (``convert.shard_params``) and runs
  ``steps.build_step``'s steps on DTensors;
* the port on one device: a world of one, a (1, 1) mesh, the same steps;
* the reference, ONE subprocess with 8 forced host devices: its
  ``build_train_step``/``build_prefill_step``/``build_decode_step``,
  jitted with their input shardings.

Cases (smoke configs, f32):

* train: qwen3-1.7b (dense) on (4, 2), also under ``tp_fsdp`` and with
  2 microbatches, phi3.5-moe (MoE) on (4, 2), also with MoE groups
  that span data ranks, and zamba2-2.7b and seamless-m4t-medium (MHA:
  two query and two K/V heads a rank) on (4, 2): three AdamW steps
  (``OPT``);
* serve: gemma2-2b (softcap, a 32-token window, ``flash_threshold =
  flash_block = 16`` so the blockwise path runs, 2 KV heads on a 4-wide
  model axis: replicated K/V), zamba2-2.7b, seamless-m4t-medium,
  phi3.5-moe and llava-next-34b (prefix embeddings) on (2, 4): a prefill
  and four greedy decode steps; gemma2-2b also at batch 1 (the cache
  sequence split over ``data``) and under ``tp_cacheseq`` (split over
  ``model``); zamba2-2.7b and seamless-m4t-medium also on (4, 2), where
  a rank holds two query and two K/V heads.

Losses, gradient norms, parameters and logits are held to ``rtol=1e-4,
atol=2e-4`` (``tests/test_kernels.py::_tol``'s f32 tolerance); greedy
tokens are equal.  AdamW runs with ``eps`` 1e-6 (``OPT``): at the default
1e-8 an element whose gradient lies at f32 rounding level (one embedding
entry: 6.5e-9 against its leaf's 0.1) takes an update that the rounding
sets, and two summation orders move it 4.3e-4 apart in three steps, so
the comparison would measure the rounding, not the sharding.  A case's
failure in a rank is recorded and fails its own test.

    python tests/test_torch_sharded_steps.py --worker RANK WORLD INIT ROOT
    python tests/test_torch_sharded_steps.py --single ROOT
    python tests/test_torch_sharded_steps.py --reference ROOT
"""
from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_world  # noqa: E402

WORLD = 8
SPAWN_TIMEOUT_S = 240
F32 = dict(rtol=1e-4, atol=2e-4)
# AdamW of the train cases (eps: see the module docstring).
OPT = dict(lr=1e-3, eps=1e-6)
TRAIN_STEPS = 3
DECODE_STEPS = 4

# name → (arch, mesh (data, model), batch, seq, rules)
TRAIN = {
    "qwen3": ("qwen3-1.7b", (4, 2), 8, 16, "tp"),
    "qwen3_fsdp": ("qwen3-1.7b", (4, 2), 8, 16, "tp_fsdp"),
    "qwen3_micro": ("qwen3-1.7b", (4, 2), 8, 16, "tp"),
    "phi": ("phi3.5-moe-42b-a6.6b", (4, 2), 8, 32, "tp"),
    # 32 tokens a data rank: each 64-token MoE group spans two ranks.
    "phi_spans": ("phi3.5-moe-42b-a6.6b", (4, 2), 8, 16, "tp"),
    # MHA with its K/V heads split over model, two a rank.
    "zamba2": ("zamba2-2.7b", (4, 2), 8, 16, "tp"),
    "seamless": ("seamless-m4t-medium", (4, 2), 8, 16, "tp"),
}
MICROBATCH = {"qwen3_micro": 2}
SERVE = {
    "gemma2": ("gemma2-2b", (2, 4), 2, 64, "tp"),
    "gemma2_b1": ("gemma2-2b", (2, 4), 1, 64, "tp"),
    "gemma2_cacheseq": ("gemma2-2b", (2, 4), 2, 64, "tp_cacheseq"),
    "zamba2": ("zamba2-2.7b", (2, 4), 2, 32, "tp"),
    "seamless": ("seamless-m4t-medium", (2, 4), 2, 32, "tp"),
    # Two query and two K/V heads a rank (MHA, K/V split over model).
    "zamba2_4x2": ("zamba2-2.7b", (4, 2), 4, 32, "tp"),
    "seamless_4x2": ("seamless-m4t-medium", (4, 2), 4, 32, "tp"),
    "phi": ("phi3.5-moe-42b-a6.6b", (2, 4), 2, 32, "tp"),
    "llava": ("llava-next-34b", (2, 4), 2, 32, "tp"),
}
# Cases the reference also runs (the rest are held to the one-device port).
REFERENCE = ("qwen3", "phi_spans", "gemma2", "zamba2", "seamless",
             "zamba2_4x2", "seamless_4x2", "phi", "llava")


def _cfg(mod, dt, arch):
    import dataclasses
    cfg = mod.smoke(mod.get_config(arch))
    over = {"param_dtype": dt}
    if arch == "gemma2-2b":
        over.update(flash_threshold=16, flash_block=16)
    return dataclasses.replace(cfg, **over)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _unflat(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


# -- inputs (the parent) -----------------------------------------------------
def write_inputs(root: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import build_model

    arrays = {}
    archs = {a for a, *_ in TRAIN.values()} | {a for a, *_ in SERVE.values()}
    for i, arch in enumerate(sorted(archs)):
        model = build_model(_cfg(configs, jnp.float32, arch))
        tree = jax.tree_util.tree_map(np.asarray,
                                      model.init(jax.random.PRNGKey(i)))
        for k, v in _flat(tree).items():
            arrays[f"params/{arch}/{k}"] = v
    rng = np.random.default_rng(0)
    for name, (arch, _, b, s, _) in TRAIN.items():
        for step in range(TRAIN_STEPS):
            if arch == "seamless-m4t-medium":
                # Half the sequence source frames, half target tokens.
                arrays[f"train/{name}/src_embeds/{step}"] = \
                    rng.standard_normal((b, s // 2, 256)).astype(np.float32)
                arrays[f"train/{name}/tokens/{step}"] = rng.integers(
                    0, 512, (b, s - s // 2)).astype(np.int32)
            else:
                arrays[f"train/{name}/tokens/{step}"] = rng.integers(
                    0, 512, (b, s)).astype(np.int32)
    for name, (arch, _, b, s, _) in SERVE.items():
        if arch == "seamless-m4t-medium":
            arrays[f"serve/{name}/src_embeds"] = rng.standard_normal(
                (b, s, 256)).astype(np.float32)
            arrays[f"serve/{name}/tokens"] = rng.integers(
                0, 512, (b, 1)).astype(np.int32)
        elif arch == "llava-next-34b":
            arrays[f"serve/{name}/prefix_embeds"] = rng.standard_normal(
                (b, s // 2, 256)).astype(np.float32)
            arrays[f"serve/{name}/tokens"] = rng.integers(
                0, 512, (b, s - s // 2)).astype(np.int32)
        else:
            arrays[f"serve/{name}/tokens"] = rng.integers(
                0, 512, (b, s)).astype(np.int32)
    np.savez(os.path.join(root, "inputs.npz"), **arrays)


BATCH_KEYS = ("tokens", "src_embeds", "prefix_embeds")


def _first_pos(arch: str, s: int) -> int:
    """The position of the first decoded token after the prefill."""
    return 1 if arch == "seamless-m4t-medium" else s


# -- the port (ranks of the world, or a world of one) -------------------------
def run_port(root: str, tag: str, single: bool) -> None:
    import torch

    from repro_torch import configs, convert
    from repro_torch.core import compat
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import InputShape
    from repro_torch.optim import AdamWConfig, adamw_init

    a = dict(np.load(os.path.join(root, "inputs.npz")))
    res: dict = {}
    errors: dict = {}

    def mesh_of(shape):
        return make_host_mesh(model=1 if single else shape[1], device="cpu")

    def full(t):
        return (t.full_tensor() if steps.is_dtensor(t) else t).detach(
        ).clone()

    for name, (arch, mshape, b, s, rules) in TRAIN.items():
        try:
            cfg = _cfg(configs, torch.float32, arch)
            mesh = mesh_of(mshape)
            tree = convert.model_params_from_numpy(
                _unflat(a, f"params/{arch}/"), cfg, device="cpu")
            params = convert.shard_params(tree, cfg, mesh, rules)
            opt = adamw_init(params)
            bundle = steps.build_step(
                cfg, mesh, InputShape("t", s, b, "train"), rules,
                opt=AdamWConfig(**OPT), microbatch=MICROBATCH.get(name, 1))
            loss, gnorm = [], []
            for step in range(TRAIN_STEPS):
                batch = {k: torch.from_numpy(a[f"train/{name}/{k}/{step}"])
                         for k in BATCH_KEYS
                         if f"train/{name}/{k}/{step}" in a}
                params, opt, met = bundle.fn(params, opt, batch)
                loss.append(float(met["loss"]))
                gnorm.append(float(met["grad_norm"]))
            res[f"train/{name}/loss"] = np.array(loss)
            res[f"train/{name}/gnorm"] = np.array(gnorm)
            for k, v in _flat(params).items():
                res[f"train/{name}/params/{k}"] = full(v).numpy()
        except Exception:                   # noqa: BLE001 — recorded
            errors[f"train/{name}"] = traceback.format_exc()

    for name, (arch, mshape, b, s, rules) in SERVE.items():
        try:
            cfg = _cfg(configs, torch.float32, arch)
            mesh = mesh_of(mshape)
            tree = convert.model_params_from_numpy(
                _unflat(a, f"params/{arch}/"), cfg, device="cpu")
            params = convert.shard_params(tree, cfg, mesh, rules)
            batch = {k: torch.from_numpy(a[f"serve/{name}/{k}"])
                     for k in BATCH_KEYS if f"serve/{name}/{k}" in a}
            pre = steps.build_step(cfg, mesh,
                                   InputShape("p", s, b, "prefill"), rules)
            dec = steps.build_step(cfg, mesh,
                                   InputShape("d", s, b, "decode"), rules)
            logits, cache = pre.fn(params, batch)
            outs, toks = [full(logits).numpy()], []
            pos = _first_pos(arch, s)
            for i in range(DECODE_STEPS):
                tok = full(logits)[:, -1].argmax(-1).to(torch.int32)[:, None]
                toks.append(tok.numpy())
                logits, cache = dec.fn(params, cache, tok, pos + i)
                outs.append(full(logits).numpy())
            res[f"serve/{name}/logits"] = np.stack(outs)
            res[f"serve/{name}/tokens"] = np.concatenate(toks, axis=1)
        except Exception:                   # noqa: BLE001 — recorded
            errors[f"serve/{name}"] = traceback.format_exc()

    if not single:
        try:
            res.update(shard_checks(a))
        except Exception:                   # noqa: BLE001 — recorded
            errors["shards"] = traceback.format_exc()
    res["errors"] = np.array(json.dumps(errors))
    np.savez(os.path.join(root, f"{tag}.npz"), **res)
    compat.barrier()
    compat.shutdown()


def shard_checks(a: dict) -> dict:
    """On (4, 2), (2, 4) and (2, 2, 2): every parameter's and moment's local
    shard has its spec's shape and owns only its block's bytes; a train
    step's collectives, counted by CommDebugMode and by the step's tally."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import configs, convert
    from repro_torch.launch import hlo_analysis, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import InputShape
    from repro_torch.models.params import leaves, specs
    from repro_torch.optim import adamw_init

    out = {}
    for mshape in ((4, 2), (2, 4), (2, 2, 2)):
        pod = mshape[0] if len(mshape) == 3 else 1
        mesh = make_host_mesh(model=mshape[-1], pod=pod, device="cpu")
        mtag = "x".join(map(str, mshape))
        for arch in ("qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b"):
            for rules in ("tp", "tp_fsdp"):
                cfg = _cfg(configs, torch.float32, arch)
                tree = convert.model_params_from_numpy(
                    _unflat(a, f"params/{arch}/"), cfg, device="cpu")
                params = convert.shard_params(tree, cfg, mesh, rules)
                opt = adamw_init(params)
                table = steps.rule_table(mesh, 8, rules)
                sp = leaves(specs(build_model(cfg).param_defs(), table,
                                  mesh.shape))
                bad, owned, want = [], 0, 0
                for full_t, spec, p, m, v in zip(
                        leaves(tree), sp, leaves(params), leaves(opt["mu"]),
                        leaves(opt["nu"])):
                    block = steps.NamedSharding(mesh, spec).local_block(
                        full_t)
                    for t, dt in ((p, full_t.dtype), (m, torch.float32),
                                  (v, torch.float32)):
                        loc = t.to_local()
                        if tuple(loc.shape) != tuple(block.shape):
                            bad.append((spec, tuple(loc.shape)))
                        owned += loc.untyped_storage().nbytes()
                        want += block.numel() * dt.itemsize
                    if not torch.equal(p.to_local(), block):
                        bad.append(("values", spec))
                key = f"shards/{mtag}/{arch}/{rules}"
                out[f"{key}/bad"] = np.array(json.dumps([str(x) for x in
                                                         bad]))
                out[f"{key}/bytes"] = np.array([owned, want])
                # 32 tokens a row: every data rank holds whole MoE groups,
                # so no activation is gathered under tp.
                bundle = steps.build_step(
                    cfg, mesh, InputShape("t", 32, 8, "train"), rules)
                batch = {"tokens": torch.from_numpy(
                    a["train/phi/tokens/0"])}
                with CommDebugMode() as comm, \
                        hlo_analysis.count_collectives() as tally:
                    bundle.fn(params, opt, batch)
                counts = {str(k): v for k, v in
                          comm.get_comm_counts().items()}
                ops = {f"{kind}@{'+'.join(axes)}": row for (kind, axes), row
                       in tally.ops.items()}
                out[f"{key}/comm"] = np.array(json.dumps(counts))
                out[f"{key}/tally"] = np.array(json.dumps(ops))
                out[f"{key}/bytes_by_kind"] = np.array(json.dumps(
                    hlo_analysis.collective_bytes(tally)))
    return out


# -- the reference (8 forced host devices) ------------------------------------
def run_reference(root: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.launch import mesh as jmesh
    from repro.launch import steps as jsteps
    from repro.models.config import InputShape
    from repro.optim import AdamWConfig, adamw_init

    assert jax.device_count() == WORLD, jax.device_count()
    a = dict(np.load(os.path.join(root, "inputs.npz")))
    res = {}

    def tree_of(arch):
        return jax.tree_util.tree_map(jnp.asarray,
                                      _unflat(a, f"params/{arch}/"))

    for name in [n for n in TRAIN if n in REFERENCE]:
        arch, mshape, b, s, rules = TRAIN[name]
        cfg = _cfg(configs, jnp.float32, arch)
        mesh = jmesh.make_host_mesh(model=mshape[1])
        bundle = jsteps.build_train_step(cfg, mesh,
                                         InputShape("t", s, b, "train"),
                                         rules, opt=AdamWConfig(**OPT))
        fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                     out_shardings=bundle.out_shardings)
        params = tree_of(arch)
        opt = adamw_init(params)
        loss, gnorm = [], []
        for step in range(TRAIN_STEPS):
            batch = {k: jnp.asarray(a[f"train/{name}/{k}/{step}"])
                     for k in BATCH_KEYS if f"train/{name}/{k}/{step}" in a}
            params, opt, met = fn(params, opt, batch)
            loss.append(float(met["loss"]))
            gnorm.append(float(met["grad_norm"]))
        res[f"train/{name}/loss"] = np.array(loss)
        res[f"train/{name}/gnorm"] = np.array(gnorm)
        for k, v in _flat(jax.tree_util.tree_map(np.asarray,
                                                 params)).items():
            res[f"train/{name}/params/{k}"] = v

    for name in [n for n in SERVE if n in REFERENCE]:
        arch, mshape, b, s, rules = SERVE[name]
        cfg = _cfg(configs, jnp.float32, arch)
        mesh = jmesh.make_host_mesh(model=mshape[1])
        pre = jsteps.build_prefill_step(cfg, mesh,
                                        InputShape("p", s, b, "prefill"),
                                        rules)
        dec = jsteps.build_decode_step(cfg, mesh,
                                       InputShape("d", s, b, "decode"),
                                       rules)
        pfn = jax.jit(pre.fn, in_shardings=pre.in_shardings)
        dfn = jax.jit(dec.fn, in_shardings=(dec.in_shardings[0], None,
                                            dec.in_shardings[2],
                                            dec.in_shardings[3]))
        params = tree_of(arch)
        batch = {k: jnp.asarray(a[f"serve/{name}/{k}"])
                 for k in BATCH_KEYS if f"serve/{name}/{k}" in a}
        logits, cache = pfn(params, batch)
        outs, toks = [np.asarray(logits)], []
        pos = _first_pos(arch, s)
        for i in range(DECODE_STEPS):
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok))
            logits, cache = dfn(params, cache, tok, jnp.int32(pos + i))
            outs.append(np.asarray(logits))
        res[f"serve/{name}/logits"] = np.stack(outs)
        res[f"serve/{name}/tokens"] = np.concatenate(toks, axis=1)
    np.savez(os.path.join(root, "reference.npz"), **res)


# -- the fixture ---------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded"))
    write_inputs(root)
    me = os.path.abspath(__file__)
    init = "file://" + os.path.join(root, "rendezvous")
    jobs = {"reference": (["--reference", root],
                          torch_world.reference_env(WORLD)),
            "single": (["--single", root], torch_world.env())}
    for r in range(WORLD):
        jobs[f"rank{r}"] = (["--worker", str(r), str(WORLD), init, root],
                            torch_world.env())
    failed = torch_world.run_all(me, jobs, root, SPAWN_TIMEOUT_S)
    if failed:
        pytest.fail(f"spawned runs failed: {failed}\n"
                    + torch_world.failure_report(root, failed))
    out = {name: dict(np.load(os.path.join(root, f"{name}.npz")))
           for name in ["reference", "single"] +
           [f"rank{r}" for r in range(WORLD)]}
    for name, r in out.items():
        if "errors" in r:
            r["errors"] = json.loads(str(r["errors"]))
    return out


def _ok(runs, case):
    for name in ["single"] + [f"rank{r}" for r in range(WORLD)]:
        err = runs[name]["errors"].get(case)
        assert err is None, f"{name}: {err}"


def _same_on_every_rank(runs, key):
    first = runs["rank0"][key]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(runs[f"rank{r}"][key], first,
                                      err_msg=key)
    return first


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_matches_one_device(runs, name):
    """Loss, gradient norm and the parameters after three steps."""
    _ok(runs, f"train/{name}")
    single = runs["single"]
    for what in ("loss", "gnorm"):
        got = _same_on_every_rank(runs, f"train/{name}/{what}")
        np.testing.assert_allclose(got, single[f"train/{name}/{what}"], **F32)
    keys = [k for k in single if k.startswith(f"train/{name}/params/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(_same_on_every_rank(runs, k), single[k],
                                   err_msg=k, **F32)


@pytest.mark.parametrize("name", [n for n in TRAIN if n in REFERENCE])
def test_sharded_train_matches_the_reference_sharded_step(runs, name):
    _ok(runs, f"train/{name}")
    ref = runs["reference"]
    for what in ("loss", "gnorm"):
        np.testing.assert_allclose(runs["rank0"][f"train/{name}/{what}"],
                                   ref[f"train/{name}/{what}"], **F32)
    keys = [k for k in ref if k.startswith(f"train/{name}/params/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(runs["rank0"][k], ref[k], err_msg=k,
                                   **F32)


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_prefill_decode_match_one_device(runs, name):
    """Logits of the prefill and four decode steps; greedy tokens equal."""
    _ok(runs, f"serve/{name}")
    single = runs["single"]
    logits = _same_on_every_rank(runs, f"serve/{name}/logits")
    np.testing.assert_allclose(logits, single[f"serve/{name}/logits"], **F32)
    np.testing.assert_array_equal(
        _same_on_every_rank(runs, f"serve/{name}/tokens"),
        single[f"serve/{name}/tokens"])


@pytest.mark.parametrize("name", [n for n in SERVE if n in REFERENCE])
def test_sharded_prefill_decode_match_the_reference(runs, name):
    _ok(runs, f"serve/{name}")
    ref = runs["reference"]
    np.testing.assert_allclose(runs["rank0"][f"serve/{name}/logits"],
                               ref[f"serve/{name}/logits"], **F32)
    np.testing.assert_array_equal(runs["rank0"][f"serve/{name}/tokens"],
                                  ref[f"serve/{name}/tokens"])
    np.testing.assert_array_equal(runs["single"][f"serve/{name}/tokens"],
                                  ref[f"serve/{name}/tokens"])


SHARD_CASES = [(m, a, r) for m in ("4x2", "2x4", "2x2x2")
               for a in ("qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b")
               for r in ("tp", "tp_fsdp")]


@pytest.mark.parametrize("mesh,arch,rules", SHARD_CASES)
def test_local_shards_have_their_specs_shapes(runs, mesh, arch, rules):
    """Each parameter's and moment's local shard has its spec's shape and
    holds its block's values; a rank owns exactly its blocks' bytes."""
    for r in range(WORLD):
        res = runs[f"rank{r}"]
        assert runs[f"rank{r}"]["errors"].get("shards") is None, \
            res["errors"]["shards"]
        key = f"shards/{mesh}/{arch}/{rules}"
        assert json.loads(str(res[f"{key}/bad"])) == [], key
        owned, want = res[f"{key}/bytes"]
        assert owned == want, (key, owned, want)


@pytest.mark.parametrize("mesh,arch,rules", SHARD_CASES)
def test_train_step_collectives(runs, mesh, arch, rules):
    """The gradients' all_reduce runs over the data axes; under ``tp`` no
    weight is gathered (nothing silently replicated), under ``tp_fsdp``
    the embed dim's gather and its reduce_scatter run over them."""
    daxes = "pod+data" if mesh == "2x2x2" else "data"
    for r in range(WORLD):
        res = runs[f"rank{r}"]
        assert res["errors"].get("shards") is None, res["errors"]["shards"]
        key = f"shards/{mesh}/{arch}/{rules}"
        comm = json.loads(str(res[f"{key}/comm"]))
        tally = json.loads(str(res[f"{key}/tally"]))
        by_kind = json.loads(str(res[f"{key}/bytes_by_kind"]))
        reduces = sum(v for k, v in comm.items() if "allreduce" in k or
                      "all_reduce" in k)
        gathers = sum(v for k, v in comm.items() if "gather" in k)
        scatters = sum(v for k, v in comm.items() if "scatter" in k)
        assert reduces > 0, comm
        assert tally[f"all-reduce@{daxes}"][0] > 0, tally
        assert tally.get("all-reduce@model", [0])[0] > 0, tally
        assert set(by_kind) == {"all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"}
        assert sum(row[0] for row in tally.values()) == \
            reduces + gathers + scatters, (comm, tally)
        if rules == "tp":
            assert gathers == 0 and scatters == 0, comm
            assert by_kind["all-gather"] == 0 == by_kind["reduce-scatter"]
        else:
            assert tally[f"all-gather@{daxes}"][0] > 0, tally
            assert tally[f"reduce-scatter@{daxes}"][0] > 0, tally
            assert gathers > 0 and scatters > 0, comm


def _main(argv: list[str]) -> int:
    try:
        if argv[0] == "--worker":
            rank, world, init, root = int(argv[1]), int(argv[2]), argv[3], \
                argv[4]
            torch_world.join(rank, world, init)
            run_port(root, f"rank{rank}", single=False)
        elif argv[0] == "--single":
            import torch

            from repro_torch.core import compat
            torch.set_num_threads(1)
            compat.init_world_of_one("cpu")
            run_port(argv[1], "single", single=True)
        elif argv[0] == "--reference":
            run_reference(argv[1])
        else:
            raise SystemExit(f"unknown mode {argv[0]!r}")
    except Exception:                       # noqa: BLE001 — exit code
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
