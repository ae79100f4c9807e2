"""The dry run (``launch/dryrun.py``, ``launch/perf.py``), the counter
it reads (``hlo_analysis.count_costs``) and the rest of
``launch/roofline_report.py``, held against the reference on the CPU.

In process: ``_shrink_depth``, ``active_params``,
``model_flops_per_device``, ``predict_roofline``, ``report`` and
``perf``'s label against the reference's.

Spawned at once, each in its own process (``tests/torch_world.py``):

* ``port``: a ``fake`` world of 8 ranks, a (2, 4) mesh; the smoke
  config of qwen3-1.7b, phi3.5-moe, zamba2-2.7b and seamless-m4t-medium
  at 2 pattern repeats, train, prefill and decode (``CASES``), each
  traced by ``dryrun._compile``; the probes' extrapolation against the
  direct count; ``Mesh.device_mesh`` first asked for under
  ``FakeTensorMode``; ``run_one`` in a world of the wrong size;
* ``reference``: 8 forced host devices, the reference's
  ``dryrun._compile`` of the same cases built with ``unroll=True``;
* ``single``: a world of one, a (1, 1) mesh: the counter on fake and
  on real CPU tensors of the same steps;
* ``dryrun`` and ``multipod``: ``python -m repro_torch.launch.dryrun``
  at the production size (256 and 512 fake ranks);
* ``mamba0``/``mamba1``: a 2-rank gloo world, a (1, 2) mesh: a mamba2
  whose 3 SSM heads do not divide the model axis (so every rank holds
  them whole, as mamba2-130m's 24 heads on the 16-wide axis), its
  sharded prefill and decode against the one-device model.

    python tests/test_torch_dryrun.py --port ROOT
    python tests/test_torch_dryrun.py --reference ROOT
    python tests/test_torch_dryrun.py --single ROOT
    python tests/test_torch_dryrun.py --module NAME ARGS...
    python tests/test_torch_dryrun.py --mamba RANK INIT ROOT
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import runpy
import sys
import traceback

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_world  # noqa: E402

WORLD = 8
MESH_MODEL = 4
SPAWN_TIMEOUT_S = 240
ARCH_IDS = ("mamba2-130m", "qwen3-1.7b", "phi3.5-moe-42b-a6.6b",
            "llava-next-34b", "zamba2-2.7b", "gemma-7b", "grok-1-314b",
            "gemma3-12b", "seamless-m4t-medium", "gemma2-2b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CASE_ARCHS = {"qwen3": "qwen3-1.7b", "phi": "phi3.5-moe-42b-a6.6b",
              "zamba2": "zamba2-2.7b", "seamless": "seamless-m4t-medium"}
# kind → (global batch, seq) on the (2, 4) mesh.
KINDS = {"train": (8, 64), "prefill": (4, 64), "decode": (4, 64)}
CASES = [f"{a}-{k}" for a in CASE_ARCHS for k in KINDS]
# The port's product FLOPs over the reference's unrolled program's FLOPs
# (XLA counts elementwise FLOPs too; FlopCounterMode counts products).
# Train and prefill are product-bound: the ratios lie at 0.82–1.12.
# Decode at one token is elementwise-heavy: 0.35–0.59.
FLOP_BAND = {"train": (0.8, 1.2), "prefill": (0.8, 1.2),
             "decode": (0.3, 0.7)}
# The mamba2 case: d_inner 2·192 = 384 in SSM heads of 128 → 3 heads.
MAMBA_ODD = dict(d_model=192, head_dim=128)
F32 = dict(rtol=1e-4, atol=2e-4)
# Outputs the reference donates whose storage the port does not reuse
# (named leaf by leaf in ROADMAP): none.
ALIAS_GAP: dict = {}


def _ref_label(args) -> str:
    """The reference's label expression (``repro/launch/perf.py:95-100``),
    which the reference builds inside ``main`` (importing it sets
    XLA_FLAGS for 512 devices)."""
    return args.label or "+".join(
        k for k, v in [("flash", args.flash),
                       ("padheads", args.pad_heads),
                       ("padvocab", args.pad_vocab),
                       ("mbunroll", args.mb_unroll or None),
                       (f"mb{args.microbatch}", args.microbatch)] if v)


def _cfg(configs, arch: str):
    """The smoke config at 2 pattern repeats (default dtypes)."""
    base = configs.smoke(configs.get_config(arch))
    kw = {"n_layers": 2 * len(base.pattern)}
    if base.n_encoder_layers:
        kw["n_encoder_layers"] = 2
    return dataclasses.replace(base, **kw)


def _shape(config_mod, kind: str):
    b, s = KINDS[kind]
    return config_mod.InputShape(kind[0], s, b, kind)


# -- spawned runs ----------------------------------------------------------
def run_port(root: str) -> None:
    import torch

    from repro_torch import configs
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import config as tconfig

    torch.set_num_threads(1)
    dryrun.fake_world(WORLD)
    mesh = mesh_lib.make_host_mesh(model=MESH_MODEL, device="cpu")
    res: dict = {"cases": {}}
    for case in CASES:
        name, kind = case.split("-")
        cfg = _cfg(configs, CASE_ARCHS[name])
        tr = dryrun._compile(steps.build_step(
            cfg, mesh, _shape(tconfig, kind), unroll=True), mesh)
        res["cases"][case] = {"memory": tr.memory_analysis(),
                              "costs": dryrun._costs(tr)}
    # The probes: a dense train config of 3 repeats, microbatch 1.
    cfg3 = dryrun._shrink_depth(_cfg(configs, "qwen3-1.7b"), 3)
    shape = _shape(tconfig, "train")
    direct = dryrun._costs(dryrun._compile(
        steps.build_step(cfg3, mesh, shape, microbatch=1), mesh))
    probe = {k: dryrun._costs(dryrun._compile(steps.build_step(
        dryrun._shrink_depth(cfg3, k), mesh, shape, unroll=True,
        microbatch=1, microbatch_unroll=True), mesh)) for k in (1, 2)}
    res["probes"] = {"direct": direct, "extrapolated":
                     dryrun._extrapolate(probe, 3)}
    # Mesh.device_mesh first asked for under FakeTensorMode.
    other = mesh_lib.make_host_mesh(model=2, device="cpu")
    with dryrun._fake_mode():
        dm = other.device_mesh
    res["device_mesh"] = [type(dm.mesh).__name__, dm.mesh.tolist(),
                          list(dm.mesh_dim_names)]
    try:
        dryrun.run_one("qwen3-1.7b", "train_4k")
        res["wrong_world"] = None
    except RuntimeError as e:
        res["wrong_world"] = str(e)
    with open(os.path.join(root, "port.json"), "w") as f:
        json.dump(res, f)


def run_reference(root: str) -> None:
    import jax

    # Start the backend on this process's 8 devices before the reference
    # dry run's import rewrites XLA_FLAGS.
    assert jax.device_count() == WORLD, jax.device_count()
    from repro import configs
    from repro.launch import dryrun, mesh as jmesh, steps
    from repro.models import config as jconfig

    mesh = jmesh.make_host_mesh(model=MESH_MODEL)
    res: dict = {}
    for case in CASES:
        name, kind = case.split("-")
        cfg = _cfg(configs, CASE_ARCHS[name])
        compiled = dryrun._compile(steps.build_step(
            cfg, mesh, _shape(jconfig, kind), unroll=True), mesh)
        mem = compiled.memory_analysis()
        res[case] = {"argument": int(mem.argument_size_in_bytes),
                     "alias": int(mem.alias_size_in_bytes),
                     "costs": dryrun._costs(compiled)}
    with open(os.path.join(root, "reference.json"), "w") as f:
        json.dump(res, f)


def run_single(root: str) -> None:
    """One rank, a (1, 1) mesh: the same steps counted on fake tensors
    (``dryrun._compile``) and on real CPU tensors."""
    import torch

    from repro_torch import configs, convert
    from repro_torch.core import compat
    from repro_torch.data import synthetic
    from repro_torch.launch import dryrun, hlo_analysis, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models import config as tconfig
    from repro_torch.optim import adamw_init

    torch.set_num_threads(1)
    compat.init_world_of_one("cpu")
    mesh = make_host_mesh(model=1, device="cpu")
    cfg = _cfg(configs, "qwen3-1.7b")
    g = torch.Generator().manual_seed(5)
    params = convert.shard_params(
        build_model(cfg).init(g, device="cpu"), cfg, mesh)
    res = {}
    for kind in KINDS:
        shape = _shape(tconfig, kind)
        bundle = steps.build_step(cfg, mesh, shape)
        fake = dryrun._compile(bundle, mesh)
        b, s = KINDS[kind]
        if kind == "train":
            args = (params, adamw_init(params), synthetic.make_batch(
                g, cfg, b, s, "train", device="cpu"))
        elif kind == "prefill":
            args = (params, synthetic.make_batch(g, cfg, b, s, "prefill",
                                                 device="cpu"))
        else:
            _, cache = steps.build_step(cfg, mesh, dataclasses.replace(
                shape, kind="prefill")).fn(params, synthetic.make_batch(
                    g, cfg, b, s, "prefill", device="cpu"))
            args = (params, cache, torch.ones((b, 1), dtype=torch.int32),
                    torch.tensor(s - 1, dtype=torch.int32))
        real_args = sum(t.numel() * t.element_size()
                        for t in torch.utils._pytree.tree_leaves(args)
                        if isinstance(t, torch.Tensor))
        with hlo_analysis.count_costs() as real:
            bundle.fn(*args)
        res[kind] = {"fake": dryrun._costs(fake), "real": real.as_dict(),
                     "fake_argument": fake.memory["argument_size_in_bytes"],
                     "real_argument": real_args}
    with open(os.path.join(root, "single.json"), "w") as f:
        json.dump(res, f)
    compat.shutdown()


def run_mamba(rank: int, init: str, root: str) -> None:
    import numpy as np
    import torch

    from repro_torch import configs, convert
    from repro_torch.core import compat
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import InputShape

    torch_world.join(rank, 2, init)
    mesh = make_host_mesh(model=2, device="cpu")
    base = configs.smoke(configs.get_config("mamba2-130m"))
    cfg = dataclasses.replace(
        base, d_model=MAMBA_ODD["d_model"], param_dtype=torch.float32,
        ssm=dataclasses.replace(base.ssm, head_dim=MAMBA_ODD["head_dim"]))
    b, s = 2, 16
    g = torch.Generator().manual_seed(11)
    model = build_model(cfg)
    params = model.init(g, device="cpu")
    batch = synthetic.make_batch(g, cfg, b, s, "prefill", device="cpu")
    sharded = convert.shard_params(params, cfg, mesh)
    logits, cache = steps.build_step(cfg, mesh, InputShape(
        "p", s, b, "prefill")).fn(sharded, batch)
    tok = torch.ones((b, 1), dtype=torch.int32)
    logits2, _ = steps.build_step(cfg, mesh, InputShape(
        "d", s, b, "decode")).fn(sharded, cache, tok, s)
    want, want_cache = model.prefill(params, batch)
    want2, _ = model.decode_step(params, want_cache, tok, s)
    res = {}
    for name, got, full in (("prefill", logits, want),
                            ("decode", logits2, want2)):
        loc = got.to_local()
        v = loc.shape[-1]
        lo = rank * v if v < cfg.vocab else 0
        ref = full[..., lo:lo + v]
        res[name] = [float((loc - ref).abs().max()),
                     float(ref.abs().max()),
                     bool(np.allclose(loc.numpy(), ref.numpy(), **F32))]
    with open(os.path.join(root, f"mamba{rank}.json"), "w") as f:
        json.dump(res, f)
    compat.barrier()
    compat.shutdown()


# -- the fixture -----------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dryrun"))
    env = torch_world.env()
    jobs = {
        "port": (["--port", root], env),
        "reference": (["--reference", root],
                      torch_world.reference_env(WORLD)),
        "single": (["--single", root], env),
        "dryrun": (["--module", "repro_torch.launch.dryrun", "--arch",
                    "qwen3-1.7b", "--shape", "train_4k", "--no-probes",
                    "--json", os.path.join(root, "dry.jsonl")], env),
        "multipod": (["--module", "repro_torch.launch.dryrun", "--arch",
                      "gemma2-2b", "--shape", "decode_32k", "--multi-pod",
                      "--no-probes", "--json",
                      os.path.join(root, "multipod.jsonl")], env),
    }
    init = "file://" + os.path.join(root, "rendezvous")
    for r in range(2):
        jobs[f"mamba{r}"] = (["--mamba", str(r), init, root], env)
    failed = torch_world.run_all(os.path.abspath(__file__), jobs, root,
                                 SPAWN_TIMEOUT_S)
    if failed:
        pytest.fail(f"spawned runs failed: {failed}\n"
                    + torch_world.failure_report(root, failed))
    out = {k: json.load(open(os.path.join(root, f"{k}.json")))
           for k in ("port", "reference", "single", "mamba0", "mamba1")}
    out["root"] = root
    return out


# -- in process: the roofline report and the depth cut ---------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shrink_depth_equals_the_reference(arch):
    from repro import configs as jconfigs
    from repro.launch.dryrun import _shrink_depth as jshrink
    from repro_torch import configs as tconfigs
    from repro_torch.launch.dryrun import _shrink_depth

    for k in (1, 2):
        got = _shrink_depth(tconfigs.get_config(arch), k)
        want = jshrink(jconfigs.get_config(arch), k)
        assert (got.n_layers, got.n_encoder_layers, got.pattern) == \
            (want.n_layers, want.n_encoder_layers, want.pattern)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_equal_the_reference(arch):
    from repro.launch.roofline_report import active_params as jactive
    from repro_torch.launch.roofline_report import active_params

    assert active_params(arch) == jactive(arch)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_per_device_equal_the_reference(arch, shape):
    from repro.launch import roofline_report as jrr
    from repro_torch.launch import roofline_report as trr

    for n in (256, 512):
        assert trr.model_flops_per_device(arch, shape, n) == pytest.approx(
            jrr.model_flops_per_device(arch, shape, n), rel=1e-12)


@pytest.mark.parametrize("kw", [
    dict(rows=128, p=16_384, t=444),
    dict(rows=7_689, p=16_384, t=264_805, wall_s=2.5),
    dict(rows=32, p=2_048, t=6_728, bytes_staged=10**7, peak_flops=67e12,
         mem_bw=3.35e12, wall_s=1e-3)], ids=["nominal", "wall", "staged"])
def test_predict_roofline_equals_the_reference(kw):
    from repro.launch.roofline_report import predict_roofline as jpredict
    from repro_torch.launch.roofline_report import predict_roofline

    got, want = predict_roofline(**kw), jpredict(**kw)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-12), k


def _write_jsonl(tmp_path, rows):
    p = tmp_path / "dry.jsonl"
    with open(p, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(p)


def _table(md: str) -> dict:
    """arch → the cells of its table row."""
    out = {}
    for line in md.splitlines()[2:]:
        cells = [c.strip() for c in line.split("|")[1:-1]]
        out[cells[0]] = cells
    return out


QWEN_ROW = {
    "arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "16x16",
    "rules": "tp", "flops": 7.18e13, "hlo_bytes": 3.73e12,
    "collective_bytes": {"all-reduce": 1.1e11},
    "memory": {"temp_size_in_bytes": int(7.6e9)},
}


def test_roofline_report_table(tmp_path):
    """The reference's ``test_roofline_report_table`` on the port's
    ``report``."""
    from repro_torch.launch import roofline_report

    md = roofline_report.report(_write_jsonl(tmp_path, [QWEN_ROW]))
    assert "qwen3-1.7b" in md and "memory" in md
    line = [ln for ln in md.splitlines() if "qwen3" in ln][0]
    ratio = float(line.split("|")[7].strip().replace("*", ""))
    assert 0.3 < ratio < 1.0


def test_roofline_report_skips_multipod_and_dedups(tmp_path):
    """The reference's ``test_roofline_report_skips_multipod_and_dedups``
    on the port's ``report``."""
    from repro_torch.launch import roofline_report

    base = {
        "arch": "mamba2-130m", "shape": "train_4k", "rules": "tp",
        "flops": 1e12, "hlo_bytes": 1e12, "collective_bytes": {},
        "memory": {"temp_size_in_bytes": 1},
    }
    rows = [dict(base, mesh="16x16"), dict(base, mesh="16x16"),
            dict(base, mesh="2x16x16")]
    md = roofline_report.report(_write_jsonl(tmp_path, rows))
    assert sum("mamba2" in ln for ln in md.splitlines()) == 1


def test_report_columns_against_the_reference_and_h100_terms(tmp_path):
    """Same JSONL through both reports: the 6ND/HLO and temp columns
    equal; the port's t-columns and bottleneck are ``roofline_terms`` at
    the H100 defaults, its lever hint that bottleneck's."""
    from repro.launch import roofline_report as jrr
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch import roofline_report as trr

    rows = [QWEN_ROW,
            dict(QWEN_ROW, arch="gemma2-2b", shape="decode_32k",
                 flops=3.1e9, hlo_bytes=2.2e6,
                 collective_bytes={"all-reduce": 4e6, "all-gather": 1e6}),
            dict(QWEN_ROW, arch="phi3.5-moe-42b-a6.6b", flops=1e15,
                 hlo_bytes=1e9, collective_bytes={"all-reduce": 1e9})]
    path = _write_jsonl(tmp_path, rows)
    got, want = _table(trr.report(path)), _table(jrr.report(path))
    assert set(got) == set(want) == {r["arch"] for r in rows}
    kinds = set()
    for r in rows:
        g, w = got[r["arch"]], want[r["arch"]]
        assert (g[1], g[5], g[6]) == (w[1], w[5], w[6])
        terms = hlo_analysis.roofline_terms(
            r["flops"], r["hlo_bytes"], sum(r["collective_bytes"].values()))
        assert g[2:5] == [f"{terms[k]:.3e}" for k in
                          ("t_compute_s", "t_memory_s", "t_collective_s")]
        assert g[5] == f"**{terms['bottleneck']}**"
        assert g[8] == trr._HINTS[terms["bottleneck"]]
        kinds.add(terms["bottleneck"])
    assert kinds == {"compute", "memory", "collective"}
    rec = json.loads(trr.report(path, md=False))
    assert [r["arch"] for r in rec] == [r["arch"] for r in rows]
    assert set(trr._HINTS) == set(jrr._HINTS)


@pytest.mark.parametrize("argv", [
    [], ["--flash", "8192"], ["--flash", "8192", "--pad-heads", "64"],
    ["--pad-vocab", "151936", "--mb-unroll", "--microbatch", "8"],
    ["--microbatch", "2", "--label", "mine"], ["--mb-unroll"],
    ["--ce-chunks", "4", "--chunk", "128"]])
def test_perf_label_matches_the_reference(argv):
    from repro_torch.launch import perf

    args = perf.parser().parse_args(["--arch", "qwen3-1.7b", "--shape",
                                     "train_4k", *argv])
    assert perf.label(args) == _ref_label(args)


def test_kernel_routes_refuse_fake_tensors():
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops

    with FakeTensorMode():
        x = torch.zeros(8, 4)
        q = torch.zeros(1, 16, 2, 16)
        with pytest.raises(RuntimeError, match="fake tensor"):
            ops.xty(x, x)
        with pytest.raises(RuntimeError, match="fake tensor"):
            ops.mha_flash(q, q, q, 2)


# -- the spawned runs ------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_argument_and_alias_bytes_equal_the_reference(runs, case):
    """Per device: the inputs' local blocks (the batch and tokens at their
    block), and the outputs that are the inputs' storage (the reference's
    donated arguments)."""
    mem = runs["port"]["cases"][case]["memory"]
    ref = runs["reference"][case]
    assert mem["argument_size_in_bytes"] == ref["argument"]
    assert mem["alias_size_in_bytes"] + ALIAS_GAP.get(case, 0) == \
        ref["alias"]
    assert mem["generated_code_size_in_bytes"] == 0
    assert mem["temp_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] >= mem["alias_size_in_bytes"]


@pytest.mark.parametrize("case", CASES)
def test_flops_within_band_of_the_reference_unrolled_count(runs, case):
    got = runs["port"]["cases"][case]["costs"]["flops"]
    want = runs["reference"][case]["costs"]["flops"]
    lo, hi = FLOP_BAND[case.split("-")[1]]
    assert lo <= got / want <= hi, (got, want, got / want)


@pytest.mark.parametrize("case", CASES)
def test_collective_and_byte_counts_are_keyed_as_the_reference(runs, case):
    got = runs["port"]["cases"][case]["costs"]
    want = runs["reference"][case]["costs"]
    assert set(got) == set(want)
    assert set(got["collective_bytes"]) == set(want["collective_bytes"])
    assert got["hlo_bytes"] > 0
    # The (2, 4) mesh's model axis: every case moves bytes over it.
    assert got["collective_bytes"]["all-reduce"] > 0


@pytest.mark.parametrize("kind", list(KINDS))
def test_fake_and_real_counts_are_equal(runs, kind):
    r = runs["single"][kind]
    assert r["fake"] == r["real"]
    assert r["fake"]["flops"] > 0 and r["fake"]["hlo_bytes"] > 0
    # A (1, 1) mesh runs no collective.
    assert not any(r["fake"]["collective_bytes"].values())
    assert r["fake_argument"] == r["real_argument"]


def test_probe_extrapolation_equals_the_direct_count(runs):
    p = runs["port"]["probes"]
    d, e = p["direct"], p["extrapolated"]
    assert e["flops"] == pytest.approx(d["flops"], rel=1e-9)
    for op, v in d["collective_bytes"].items():
        assert e["collective_bytes"][op] == pytest.approx(v, rel=1e-9)


def test_device_mesh_first_asked_for_under_fake_mode(runs):
    kind, ranks, names = runs["port"]["device_mesh"]
    assert kind == "Tensor"
    assert ranks == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert names == ["data", "model"]


def test_run_one_names_the_world_it_needs(runs):
    msg = runs["port"]["wrong_world"]
    assert msg is not None and "256-rank world" in msg and \
        "a world of 8" in msg


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_ssm_heads_whole_on_a_split_model_axis(runs, kind):
    """SSM heads that the model axis does not divide stay whole on every
    rank; the sharded steps equal the one-device model."""
    for r in range(2):
        err, scale, ok = runs[f"mamba{r}"][kind]
        assert ok, (r, err, scale)


def _records(runs, name):
    with open(os.path.join(runs["root"], f"{name}.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_dryrun_driver_at_the_production_size(runs):
    """``python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape
    train_4k --no-probes --json``: the reference's lines and keys, the
    step's local blocks as its arguments, 6ND/HLO in the reference's
    band."""
    import types

    from repro_torch import configs
    from repro_torch.launch import roofline_report, steps
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves, specs

    log = open(os.path.join(runs["root"], "dryrun.log")).read()
    assert "\n1 passed, 0 failed" in log
    assert "== qwen3-1.7b × train_4k × 16x16 (rules=tp) ==" in log
    assert "memory_analysis:" in log and "collective_bytes:" in log
    (rec,) = _records(runs, "dry")
    assert set(rec) == {"arch", "shape", "mesh", "rules", "n_devices",
                        "compile_s", "memory", "scan_counted", "flops",
                        "hlo_bytes", "collective_bytes"}
    assert (rec["mesh"], rec["n_devices"]) == ("16x16", 256)
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes"}
    # Parameters (vocab, heads and mlp over 16 model ranks), their two
    # f32 moments, the step counter, the batch's (16, 4,096) int32 block.
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 16, "model": 16})
    table = steps.rule_table(mesh, 256, "tp")
    defs = build_model(configs.get_config("qwen3-1.7b")).param_defs()
    local = f32 = 0
    for d, spec in zip(leaves(defs), leaves(specs(defs, table,
                                                   mesh.shape))):
        n = math.prod(s // (16 if e else 1) for s, e in zip(d.shape, spec))
        local += n * d.dtype.itemsize
        f32 += n * 4
    want = local + 2 * f32 + 4 + 16 * 4096 * 4
    assert rec["memory"]["argument_size_in_bytes"] == want
    md = roofline_report.report(os.path.join(runs["root"], "dry.jsonl"))
    line = [ln for ln in md.splitlines() if "qwen3" in ln][0]
    assert 0.3 < float(line.split("|")[7].strip()) < 1.0


def test_dryrun_multi_pod_names_its_mesh(runs):
    log = open(os.path.join(runs["root"], "multipod.log")).read()
    assert "\n1 passed, 0 failed" in log
    (rec,) = _records(runs, "multipod")
    assert (rec["mesh"], rec["n_devices"]) == ("2x16x16", 512)


def _main(argv: list[str]) -> int:
    try:
        if argv[0] == "--port":
            run_port(argv[1])
        elif argv[0] == "--reference":
            run_reference(argv[1])
        elif argv[0] == "--single":
            run_single(argv[1])
        elif argv[0] == "--mamba":
            run_mamba(int(argv[1]), argv[2], argv[3])
        elif argv[0] == "--module":
            # python -m NAME ARGS..., with this process's time limit.
            sys.argv = [argv[1], *argv[2:]]
            try:
                runpy.run_module(argv[1], run_name="__main__",
                                 alter_sys=True)
            except SystemExit as e:
                return int(e.code or 0)
        else:
            raise SystemExit(f"unknown mode {argv[0]!r}")
    except Exception:                       # noqa: BLE001 — exit code
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
