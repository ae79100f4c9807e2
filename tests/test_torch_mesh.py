"""The device mesh, the rule tables and the collective count of the port
(``launch/mesh.py``, ``models.params.RULES``/``specs``/``abstract``,
``launch/steps.py``' ``rule_table``/``named``/``batch_shardings``,
``launch/hlo_analysis.py``) held against the reference.

Spec parity runs in this process, with no world: for every architecture,
rule table and production mesh ((16, 16) and (2, 16, 16)), at a batch
that the data axes divide and one they do not, the port's spec of every
parameter and decode-cache leaf equals the reference's ``PartitionSpec``
as a tuple.  The meshes' behaviour over ranks runs in ONE 8-rank gloo
world (one process a rank), whose results the tests read.

    python tests/test_torch_mesh.py --worker RANK WORLD INIT ROOT
"""
from __future__ import annotations

import json
import os
import sys
import traceback
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_world  # noqa: E402

WORLD = 8
SPAWN_TIMEOUT_S = 120
PROD = {"16x16": (("data", "model"), (16, 16)),
        "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
RULE_TABLES = ("tp", "tp_fsdp", "tp_cacheseq")


def _fake_mesh(names, sizes):
    """What ``rule_table`` reads of a mesh: axis names and sizes."""
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


def _walk(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _both(arch, names, sizes, batch, rules, what):
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models import build_model as jbuild
    from repro.models.params import specs as jspecs
    from repro_torch import configs as tconfigs
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import build_model as tbuild
    from repro_torch.models.params import specs as tspecs

    mesh = _fake_mesh(names, sizes)
    jt = jsteps.rule_table(mesh, batch, rules)
    tt = tsteps.rule_table(mesh, batch, rules)
    assert jt == tt
    jm = jbuild(jconfigs.get_config(arch))
    tm = tbuild(tconfigs.get_config(arch))
    if what == "params":
        jd, td = jm.param_defs(), tm.param_defs()
    else:
        jd, td = jm.cache_defs(batch, 32_768), tm.cache_defs(batch, 32_768)
    got = dict(_walk(tspecs(td, tt, mesh.shape)))
    want = {k: tuple(v) for k, v in _walk(jspecs(jd, jt, dict(mesh.shape)))}
    return got, want


@pytest.mark.parametrize("batch", [256, 3], ids=["divides", "replicated"])
@pytest.mark.parametrize("prod", list(PROD))
@pytest.mark.parametrize("rules", RULE_TABLES)
@pytest.mark.parametrize("arch", [
    "mamba2-130m", "qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "llava-next-34b",
    "zamba2-2.7b", "gemma-7b", "grok-1-314b", "gemma3-12b",
    "seamless-m4t-medium", "gemma2-2b"])
def test_param_specs_equal_the_reference(arch, rules, prod, batch):
    got, want = _both(arch, *PROD[prod], batch, rules, "params")
    assert got == want


@pytest.mark.parametrize("batch", [128, 1], ids=["divides", "replicated"])
@pytest.mark.parametrize("prod", list(PROD))
@pytest.mark.parametrize("rules", RULE_TABLES)
@pytest.mark.parametrize("arch", [
    "qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b", "gemma3-12b",
    "seamless-m4t-medium", "gemma2-2b", "mamba2-130m"])
def test_cache_specs_equal_the_reference(arch, rules, prod, batch):
    got, want = _both(arch, *PROD[prod], batch, rules, "cache")
    assert got == want


def test_the_arch_list_is_the_reference_one():
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    assert tuple(tconfigs.ARCH_IDS) == tuple(jconfigs.ARCH_IDS)


def test_specs_subtleties():
    """A mesh axis is used once per spec (the first logical axis wins),
    and a dim that its axes do not divide is replicated."""
    import torch

    from repro_torch.models.params import ParamDef, specs

    table = {"expert": "model", "embed": None, "mlp": "model",
             "kv": "model", "heads": "model"}
    moe = ParamDef((4, 8, 2, 16), ("expert", "embed", None, "mlp"))
    assert specs(moe, table, {"model": 4}) == ("model", None, None, None)
    assert specs(moe, table, {"model": 8}) == (None, None, None, "model")
    kv = ParamDef((256, 2, 64), ("embed", "kv", None), dtype=torch.float32)
    assert specs(kv, table, {"model": 4}) == (None, None, None)
    assert specs(kv, table, {"model": 2}) == (None, "model", None)
    assert specs(kv, table) == (None, "model", None)


def test_abstract_allocates_nothing():
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models.params import abstract, is_def, leaves

    defs = build_model(configs.get_config("grok-1-314b")).param_defs()
    metas = leaves(abstract(defs))
    assert all(is_def(d) for d in leaves(defs))
    assert all(t.device.type == "meta" for t in metas)
    assert [(tuple(t.shape), t.dtype) for t in metas] == \
        [(d.shape, d.dtype) for d in leaves(defs)]
    assert sum(t.numel() for t in metas) > 3e11       # 314B, not allocated


def test_named_placements_and_batch_shardings():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import steps

    mesh = _fake_mesh(("pod", "data", "model"), (2, 4, 2))
    sh = steps.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    tree = steps.named(mesh, {"a": (None, "model"), "b": {"c": ()}})
    assert tree["a"].placements == (Replicate(), Replicate(), Shard(1))
    assert tree["b"]["c"].placements == (Replicate(),) * 3
    spec = {"tokens": ((16, 8), None), "src_embeds": ((16, 4, 3), None)}
    got = steps.batch_shardings(mesh, spec, 16)
    assert got["tokens"].spec == (("pod", "data"), None)
    assert got["src_embeds"].spec == (("pod", "data"), None, None)
    assert steps.batch_shardings(mesh, spec, 12)["tokens"].spec == \
        (None, None)


@pytest.mark.parametrize("ranks,micro", [(256, 4), (8, None)])
def test_build_step_dispatch(monkeypatch, ranks, micro):
    """``build_step`` as the reference's: train steps on ≥ 64 ranks
    accumulate 4 microbatches, long_500k makes every attention layer a
    sliding window, prefill and decode take no microbatch."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models.config import INPUT_SHAPES

    seen = {}
    for kind in ("train", "prefill", "decode"):
        monkeypatch.setattr(
            steps, f"build_{kind}_step",
            lambda cfg, mesh, shape, rules, _k=kind, **kw: seen.update(
                {_k: (cfg, kw)}))
    mesh = _fake_mesh(("data", "model"), (ranks // 16 or 1, 16))
    mesh.ranks = tuple(range(ranks))
    cfg = configs.get_config("gemma2-2b")
    steps.build_step(cfg, mesh, INPUT_SHAPES["train_4k"])
    steps.build_step(cfg, mesh, INPUT_SHAPES["prefill_32k"], microbatch=4)
    steps.build_step(cfg, mesh, INPUT_SHAPES["long_500k"])
    assert seen["train"][1].get("microbatch") == micro
    assert "microbatch" not in seen["prefill"][1]
    long_cfg = seen["decode"][0]
    assert "global_attn" not in long_cfg.pattern
    assert long_cfg.window <= 4096 and long_cfg.shared_attn_window == 4096
    assert seen["train"][0].pattern == cfg.pattern


def test_mesh_constants_are_the_h100s():
    from repro_torch.launch import mesh

    assert mesh.PEAK_FLOPS_BF16 == 989e12
    assert mesh.HBM_BW == 3.35e12
    assert mesh.ICI_BW_PER_LINK * 18 == 900e9
    assert mesh.data_axes(_fake_mesh(("data", "model"), (2, 2))) == \
        ("data",)
    assert mesh.data_axes(_fake_mesh(("pod", "data", "model"),
                                     (2, 2, 2))) == ("pod", "data")


@pytest.mark.parametrize("coll", [0.0, 3.2e9, 4.5e12])
def test_roofline_terms_match_the_reference(coll):
    from repro.launch.hlo_analysis import roofline_terms as jterms
    from repro_torch.launch import hlo_analysis as ha

    kw = dict(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=50e9, ici_links=18)
    assert ha.roofline_terms(2e12, 4e11, coll, **kw) == \
        pytest.approx(jterms(2e12, 4e11, coll, **kw))
    assert ha.roofline_terms(2e12, 4e11, coll) == \
        ha.roofline_terms(2e12, 4e11, coll, **kw)


def test_memory_dict_matches_the_reference():
    from repro.launch.hlo_analysis import memory_dict as jmem
    from repro_torch.launch.hlo_analysis import memory_dict

    obj = types.SimpleNamespace(argument_size_in_bytes=10,
                                temp_size_in_bytes=7.0, other=1)
    assert memory_dict(obj) == jmem(obj) == {"argument_size_in_bytes": 10,
                                             "temp_size_in_bytes": 7}
    assert memory_dict({"output_size_in_bytes": 3, "x": 1}) == \
        {"output_size_in_bytes": 3}


def test_collective_bytes_keys_are_the_references_op_kinds():
    from repro.launch import hlo_analysis as jha
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.models import spmd

    with ha.count_collectives() as tally:
        spmd.record("all-reduce", ("data",), 64)
        spmd.record("all-reduce", "model", 16)
        spmd.record("all-gather", ("pod", "data"), 8)
    spmd.record("all-reduce", "data", 1000)            # outside: not counted
    got = ha.collective_bytes(tally)
    assert tuple(got) == jha._COLLECTIVES
    assert got == {"all-gather": 8.0, "all-reduce": 80.0,
                   "reduce-scatter": 0.0, "all-to-all": 0.0,
                   "collective-permute": 0.0}
    assert ha.total_collective_bytes(tally) == 88.0
    assert tally.ops[("all-reduce", ("data",))] == [1, 64]


# -- the 8-rank world ----------------------------------------------------------
def run_rank(rank: int, world: int, init: str, root: str) -> None:
    import torch

    from repro_torch.core import compat
    from repro_torch.launch import mesh as mesh_lib

    torch_world.join(rank, world, init)
    res: dict = {}

    def err(fn):
        try:
            fn()
        except Exception as e:                  # noqa: BLE001 — recorded
            return f"{type(e).__name__}: {e}"
        return None

    m = mesh_lib.make_host_mesh(device="cpu")
    res["host"] = [list(m.axis_names), list(m.shape.values()),
                   list(m.device_mesh.mesh_dim_names),
                   m.device_mesh.mesh.tolist(), m.coords]
    p = mesh_lib.make_host_mesh(model=2, pod=2, device="cpu")
    res["pod"] = [list(p.axis_names), list(p.shape.values()),
                  list(mesh_lib.data_axes(p)), p.axis_index(("pod", "data"))]
    res["bad_host"] = err(lambda: mesh_lib.make_host_mesh(model=3,
                                                          device="cpu"))
    res["prod"] = err(lambda: mesh_lib.make_production_mesh(device="cpu"))
    res["multi"] = err(lambda: mesh_lib.make_production_mesh(
        multi_pod=True, device="cpu"))
    # A mesh over a subset of the ranks, in the order given.
    sub = compat.make_mesh((2, 2), ("data", "model"), devices=[7, 5, 3, 1],
                           device="cpu")
    res["sub_member"] = sub.member
    if sub.member:
        t = torch.tensor([float(rank)])
        res["sub"] = [sub.coords, float(sub.psum(t.clone(), "data")),
                      float(sub.psum(t.clone(), ("data", "model"))),
                      sub.device_mesh.mesh.tolist()]
    else:
        res["sub"] = err(lambda: sub.psum(torch.ones(1), "data"))
    res["sub_bad"] = err(lambda: compat.make_mesh(
        (2, 2), ("data", "model"), devices=[0, 1, 2, 2], device="cpu"))
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    compat.barrier()
    compat.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh"))
    init = "file://" + os.path.join(root, "rendezvous")
    jobs = {f"rank{r}": (["--worker", str(r), str(WORLD), init, root],
                         torch_world.env()) for r in range(WORLD)}
    failed = torch_world.run_all(os.path.abspath(__file__), jobs, root,
                                 SPAWN_TIMEOUT_S)
    if failed:
        pytest.fail(f"spawned runs failed: {failed}\n"
                    + torch_world.failure_report(root, failed))
    return [json.load(open(os.path.join(root, f"rank{r}.json")))
            for r in range(WORLD)]


def test_host_mesh_over_the_world(world):
    """The reference's default host mesh of 8 devices: (4, 2) over
    (data, model), ranks row-major, and its DeviceMesh alike."""
    for r, res in enumerate(world):
        names, sizes, dm_names, dm, coords = res["host"]
        assert names == dm_names == ["data", "model"] and sizes == [4, 2]
        assert dm == np.arange(WORLD).reshape(4, 2).tolist()
        assert coords == {"data": r // 2, "model": r % 2}


def test_pod_host_mesh_and_data_axes(world):
    for r, res in enumerate(world):
        names, sizes, daxes, idx = res["pod"]
        assert names == ["pod", "data", "model"] and sizes == [2, 2, 2]
        assert daxes == ["pod", "data"] and idx == r // 2
        assert "does not cover the world of 8 ranks" in res["bad_host"]


def test_production_meshes_name_the_ranks_they_need(world):
    for res in world:
        assert "needs a world of exactly 256 ranks, this one has 8" in \
            res["prod"]
        assert "needs a world of exactly 512 ranks, this one has 8" in \
            res["multi"]


def test_mesh_over_a_subset_of_the_ranks(world):
    """``devices=`` lays the named ranks out row-major in the order given;
    the other ranks hold the mesh but cannot run its collectives."""
    order = [7, 5, 3, 1]
    for r, res in enumerate(world):
        assert res["sub_member"] == (r in order)
        assert "distinct ranks" in res["sub_bad"]
        if r not in order:
            assert "is not in this mesh" in res["sub"]
            continue
        coords, data_sum, all_sum, dm = res["sub"]
        i = order.index(r)
        assert coords == {"data": i // 2, "model": i % 2}
        col = [order[j] for j in range(4) if j % 2 == i % 2]
        assert data_sum == float(sum(col)) and all_sum == float(sum(order))
        assert dm == [[7, 5], [3, 1]]


def _main(argv: list[str]) -> int:
    try:
        if argv[0] == "--worker":
            run_rank(int(argv[1]), int(argv[2]), argv[3], argv[4])
        else:
            raise SystemExit(f"unknown mode {argv[0]!r}")
    except Exception:                       # noqa: BLE001 — exit code
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
