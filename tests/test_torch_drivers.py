"""The port's drivers (``repro_torch.launch.{encode,serve,obscli}``,
``configs.vgg16_ridge``, ``roofline_report.encoding_roofline``) against
the reference's.

Mirrors ``tests/test_drivers.py`` and the CI lanes that run the drivers
(``.github/workflows/ci.yml``: the obs lane's instrumented ``encode
--store``, the faults lane's fleet drain with a killed worker), with
``--device cpu``.  Where a driver draws its own data the two packages
cannot draw the same numbers (``torch.Generator`` against
``jax.random``), so they are held by format: the reference reads the
port's bundle.  Where a driver reads a store, both packages read one
directory the port's ``RunStore`` wrote, and are held by λ (equal) and W
(within ``tests/test_kernels.py::_tol``, f32).  A replayed trace fixes
the traffic, so its wave and row counts are equal.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import vgg16_ridge as jvgg16
from repro.launch.roofline_report import encoding_roofline as jroofline
from repro.serving_encoders.bundle import EncoderBundle as JBundle
from repro_torch import configs, obs
from repro_torch.configs import vgg16_ridge
from repro_torch.data.store import RunStore
from repro_torch.encoding import BrainEncoder
from repro_torch.launch import obscli
from repro_torch.launch.roofline_report import encoding_roofline
from repro_torch.serving_encoders.bundle import EncoderBundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = os.path.join(REPO, "benchmarks", "traces", "mixed_v1.json")
# As tests/test_kernels.py::_tol, f32.
F32 = dict(rtol=1e-4, atol=2e-4)


def _run(args, timeout=600, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)


def _ok(p):
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def _port(module, *args, **kw):
    return _run([f"repro_torch.launch.{module}", "--device", "cpu", *args],
                **kw)


@pytest.mark.timeout(600)
def test_encode_driver_backbone(tmp_path):
    """One device: RidgeCV (the 4-rank B-MOR run is
    ``test_encode_driver_bmor_four_ranks``).  The saved bundle is the
    reference's format: its ``load_encoder`` predicts as the port's
    ``BrainEncoder.load`` does."""
    bundle = str(tmp_path / "bundle")
    out = _ok(_port("encode", "--backbone", "vgg16", "--n", "400",
                    "--targets", "64", "--save-bundle", bundle))
    assert "RidgeCV fit" in out
    assert os.path.exists(os.path.join(bundle, "bundle.json"))
    assert os.path.exists(os.path.join(bundle, "report.json"))
    assert "significant" in out
    X = np.random.default_rng(0).standard_normal((24, 128)).astype(
        np.float32)
    port = BrainEncoder.load(bundle, device="cpu").predict(X).numpy()
    ref = np.asarray(JBundle.open(bundle).load_encoder().predict(X))
    np.testing.assert_allclose(port, ref, **F32)
    with open(os.path.join(bundle, "report.json")) as f:
        report = json.load(f)
    assert report["solver_label"] == "RidgeCV"
    assert report["best_lambda"][0] in report["lambdas"]


def _write_store(root, n=4096, p=128, t=64, n_runs=4):
    rng = np.random.default_rng(11)
    X = rng.standard_normal((n, p)).astype(np.float32)
    W = (rng.standard_normal((p, t)) / np.sqrt(p)).astype(np.float32)
    Y = (X @ W + rng.standard_normal((n, t))).astype(np.float32)
    store = RunStore.create(root)
    for i in range(n_runs):
        lo, hi = i * n // n_runs, (i + 1) * n // n_runs
        store.write(X[lo:hi], Y[lo:hi], f"run-{i:03d}")


def _bundle_fit(path):
    with open(os.path.join(path, "report.json")) as f:
        lam = json.load(f)["best_lambda"]
    W = EncoderBundle.open(path).load_encoder(device="cpu").weights_
    return lam, W.numpy()


@pytest.mark.timeout(600)
def test_encode_store_matches_reference_and_obs_lane(tmp_path):
    """``encode --store`` in both packages on one store: λ equal, W within
    the f32 tolerance; the port's run is the obs lane's check (strict
    sentinel, trace phases, ≥95% coverage, metrics schema, one chunk
    update signature)."""
    store = str(tmp_path / "store")
    _write_store(store)
    args = ["--store", store, "--budget-mb", "0.5", "--chunk-rows", "1024"]
    strict = {"REPRO_OBS_STRICT": "1", "JAX_PLATFORMS": "cpu"}
    jb, tb = str(tmp_path / "jax_bundle"), str(tmp_path / "torch_bundle")
    trace, metrics = str(tmp_path / "t.jsonl"), str(tmp_path / "m.json")
    jout = _ok(_run(["repro.launch.encode", *args, "--save-bundle", jb],
                    env_extra=strict))
    tout = _ok(_port("encode", *args, "--save-bundle", tb,
                     "--trace-out", trace, "--metrics-out", metrics,
                     env_extra=strict))
    for out in (jout, tout):
        assert "opened store" in out and "method=chunked" in out
        assert "accumulation compiles=1" in out
    jlam, jW = _bundle_fit(jb)
    tlam, tW = _bundle_fit(tb)
    assert tlam == jlam
    np.testing.assert_allclose(tW, jW, **F32)

    events = [json.loads(ln) for ln in open(trace)]
    assert events
    for ev in events:
        for key in ("name", "ts_us", "dur_us", "track", "tid", "depth",
                    "attrs"):
            assert key in ev, (key, ev)
    names = {e["name"] for e in events}
    for phase in ("fit", "fit.stats", "fit.eigh", "fit.solve"):
        assert phase in names, phase
    _ok(_run(["repro_torch.launch.obs_report", trace,
              "--assert-coverage", "0.95"]))
    snap = json.load(open(metrics))
    assert snap["schema"] == "repro.obs/v1"
    assert "rss_bytes" in snap["gauges"]
    assert snap["counters"].get("compiles{tier=foldstats.chunk_update}") \
        == 1.0


@pytest.mark.timeout(600)
def test_encode_driver_mamba_smoke():
    out = _ok(_port("encode", "--backbone", "mamba2-130m", "--smoke",
                    "--n", "256", "--targets", "32"))
    assert "backbone features from mamba2-130m-smoke: X(256, 256)" in out
    assert "dispatch: solver=ridge mesh=1x1" in out


# The B-MOR plans are ported and need a process group: started without
# torch.distributed.run they refuse, naming it (the ids are the cases'
# names from when they named ROADMAP items 9 and 12).  The audio arch is
# ported (item 12): it runs, and its features line is the reference's.
@pytest.mark.parametrize("args,item", [
    pytest.param(["--solver", "bmor"], "torch.distributed.run",
                 id="args0-item 9"),
    pytest.param(["--solver", "bmor_dual"], "torch.distributed.run",
                 id="args1-item 9"),
    pytest.param(["--backbone", "seamless-m4t-medium", "--smoke"], None,
                 id="args2-item 12"),
])
def test_encode_driver_refuses_unported_naming_roadmap_item(args, item):
    p = _port("encode", "--n", "64", "--targets", "8", *args)
    if item is not None:
        assert p.returncode != 0
        assert item in p.stderr, p.stderr
        return
    # The decoder's hidden states of n/16 batches of 8 frames + 8 tokens.
    line = ("backbone features from seamless-m4t-medium-smoke: X(32, 256) "
            "Y(32, 8)")
    assert line in _ok(p)
    assert line in _ok(_run(["repro.launch.encode", "--n", "64",
                             "--targets", "8", *args]))
    assert "dispatch: solver=ridge mesh=1x1" in p.stdout


@pytest.mark.timeout(600)
def test_encode_driver_bmor_four_ranks(tmp_path):
    """``tests/test_drivers.py::test_encode_driver_backbone``'s 4-device
    run, as four gloo ranks under ``torch.distributed.run``: dispatch
    picks B-MOR, the encoding is significant, and rank 0 alone prints and
    writes the bundle and its report."""
    bundle = str(tmp_path / "bundle")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.encode",
         "--device", "cpu", "--backbone", "vgg16", "--n", "400",
         "--targets", "64", "--save-bundle", bundle],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "B-MOR fit" in p.stdout
    assert "significant" in p.stdout
    assert p.stdout.count("B-MOR fit") == 1       # rank 0 alone prints
    assert "dispatch: solver=bmor mesh=" in p.stdout
    assert sorted(os.listdir(bundle)) == ["bundle.json", "report.json",
                                          "step_0"]
    with open(os.path.join(bundle, "report.json")) as f:
        report = json.load(f)
    assert report["decision"]["solver"] == "bmor"
    assert len(report["best_lambda"]) == report["decision"]["target_shards"]
    # The reference reads the 4-rank fit's bundle.
    X = np.random.default_rng(1).standard_normal((8, 128)).astype(
        np.float32)
    np.testing.assert_allclose(
        BrainEncoder.load(bundle, device="cpu").predict(X).numpy(),
        np.asarray(JBundle.open(bundle).load_encoder().predict(X)), **F32)


def test_encode_driver_refuses_more_target_shards_than_devices():
    p = _port("encode", "--n", "64", "--targets", "8", "--target-shards", "2")
    assert p.returncode != 0
    assert "outside the valid range [1, 1]" in p.stderr, p.stderr


@pytest.mark.parametrize("module,args", [
    ("encode", ["--n", "64"]),
    ("serve", ["--encoders", "1"]),
    ("wholebrain", ["--crash-only", "--smoke"]),
])
def test_drivers_without_device_need_cuda(module, args, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    p = _run([f"repro_torch.launch.{module}", *args,
              *(["--workdir", str(tmp_path)] if module == "wholebrain"
                else ["--bundle-dir", str(tmp_path)] if module == "serve"
                else [])])
    assert p.returncode != 0
    assert "pass device='cpu'" in p.stderr, p.stderr
    assert not os.listdir(tmp_path)           # nothing ran on the CPU


@pytest.mark.timeout(600)
def test_serve_driver_encoder_mode(tmp_path):
    """materialise → fit → save → serve loop: bundles land on disk, the
    service reports exactly one predict signature for the single wave
    shape, and a second run reuses the saved bundles."""
    bundles = str(tmp_path / "bundles")
    argv = ["--encoders", "2", "--bundle-dir", bundles, "--n", "192",
            "--targets", "32", "--serve-steps", "3", "--wave-rows", "32",
            "--requests-per-step", "4"]
    out = _ok(_port("serve", *argv))
    assert "saved bundle" in out
    assert "compiled_predicts=1 (1 per wave shape)" in out
    assert sorted(os.listdir(bundles)) == ["sub-01", "sub-02"]
    out2 = _ok(_port("serve", *argv))
    assert "reusing bundle" in out2


def _service_line(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("service: ")][-1]
    return json.loads(line[len("service: "):])


@pytest.mark.timeout(600)
def test_serve_replay_trace_matches_reference(tmp_path):
    """The checked-in trace fixes every request's model, tenant and rows,
    so the waves and rows served are the reference's."""
    jout = _ok(_run(["repro.launch.serve", "--replay-trace", TRACE,
                     "--bundle-dir", str(tmp_path / "jax")],
                    env_extra={"JAX_PLATFORMS": "cpu"}))
    tout = _ok(_port("serve", "--replay-trace", TRACE, "--bundle-dir",
                     str(tmp_path / "torch"),
                     env_extra={"REPRO_OBS_STRICT": "1"}))
    js, ts = _service_line(jout), _service_line(tout)
    for key in ("waves", "rows", "pad_rows", "requests"):
        assert ts[key] == js[key], key
    assert ({k: v["rows"] for k, v in ts["per_tenant"].items()}
            == {k: v["rows"] for k, v in js["per_tenant"].items()})
    assert "0 backpressure rejections, 0 faults" in tout
    assert len(os.listdir(tmp_path / "torch")) == 6


@pytest.mark.timeout(600)
def test_serve_fleet_drain_with_killed_worker(tmp_path):
    out = _ok(_port("serve", "--encoders", "4", "--bundle-dir",
                    str(tmp_path / "fleet"), "--workers", "2",
                    "--kill-worker", "0", "--n", "128", "--targets", "64",
                    "--serve-steps", "3", "--requests-per-step", "4",
                    env_extra={"REPRO_OBS_STRICT": "1"}))
    assert "lease gate: w0 SIGKILLed after 1 flush" in out
    assert "2 workers drained cleanly" in out


@pytest.mark.timeout(600)
def test_serve_driver_llm_mode_names_item_12():
    """The audio arch's ``EncDecLM`` (ROADMAP item 12, whose refusal this
    test held until it was ported) serves in LLM mode: both packages
    print the same three lines (the weights differ, so the times and
    tokens do)."""
    import re

    args = ["--arch", "seamless-m4t-medium", "--smoke"]
    pats = [r"prefill: \d+\.\d\ds  logits \(2, 1, 512\)",
            r"decoded 16 tokens × batch 2 in \d+\.\d\ds "
            r"\(\d+\.\d tok/s\)",
            r"sample tokens: \[(\d+, ){11}\d+\]"]
    for out in (_ok(_port("serve", *args)),
                _ok(_run(["repro.launch.serve", *args]))):
        lines = out.strip().splitlines()
        assert len(lines) == 3, out
        for line, pat in zip(lines, pats):
            assert re.fullmatch(pat, line), line


def test_obs_session_writes_trace_when_body_raises(tmp_path):
    import argparse

    ap = argparse.ArgumentParser()
    obscli.add_obs_args(ap)
    trace, metrics = tmp_path / "t.jsonl", tmp_path / "m.json"
    args = ap.parse_args(["--trace-out", str(trace),
                          "--metrics-out", str(metrics)])
    with pytest.raises(RuntimeError, match="driver failed"):
        with obscli.obs_session(args) as tracer:
            assert tracer is obs.current()
            with obs.span("fit"):
                raise RuntimeError("driver failed")
    assert obs.current() is None
    events = [json.loads(ln) for ln in open(trace)]
    assert [e["name"] for e in events] == ["fit"]
    assert json.load(open(metrics))["schema"] == "repro.obs/v1"
    with obscli.obs_session(ap.parse_args([])) as tracer:
        assert tracer is None and obs.current() is None


def test_vgg16_ridge_resolutions_match_reference():
    assert list(vgg16_ridge.RESOLUTIONS) == list(jvgg16.RESOLUTIONS)
    for res, cfg in vgg16_ridge.RESOLUTIONS.items():
        ref = jvgg16.RESOLUTIONS[res]
        assert cfg.name == ref.name
        for field in ("n", "p", "t", "r", "n_folds"):
            assert getattr(cfg.workload, field) == \
                getattr(ref.workload, field), (res, field)
        assert tuple(cfg.lambdas) == tuple(ref.lambdas)
        assert (cfg.n_folds, cfg.test_frac) == (ref.n_folds, ref.test_frac)
    assert vgg16_ridge.CONFIG.name == jvgg16.CONFIG.name


@pytest.mark.parametrize("kw", [
    dict(n=1024, p=128, t=262_144, n_folds=8),
    dict(n=512, p=128, t=2048, n_folds=8, wall_s=0.5),
    dict(n=69_202, p=16_384, t=444, wall_s=16.0, bytes_staged=4_659_000_000,
         peak_flops=67e12, mem_bw=3.35e12),
])
def test_encoding_roofline_matches_reference(kw):
    got, want = encoding_roofline(**kw), jroofline(**kw)
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert got[key] == pytest.approx(val, rel=1e-12), key


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-130m"])
def test_for_device_turns_the_kernel_tier_on_iff_cuda(arch, device):
    """The one place the backbone's kernel switches follow the device, as
    the fit's ``use_pallas=None`` does; nothing else of the config moves."""
    base = configs.get_config(arch)
    cfg = configs.for_device(base, device)
    on = device == "cuda"
    assert cfg.ssm.use_kernel is on and cfg.flash_kernel is on
    assert dataclasses.replace(cfg, ssm=base.ssm,
                               flash_kernel=base.flash_kernel) == base


def test_for_device_keeps_grouped_ssd_on_the_einsum_chain():
    """The SSD kernel takes one B/C group only."""
    base = configs.get_config("zamba2-2.7b")
    grouped = dataclasses.replace(
        base, ssm=dataclasses.replace(base.ssm, n_groups=2))
    cfg = configs.for_device(grouped, torch.device("cuda"))
    assert not cfg.ssm.use_kernel and cfg.flash_kernel


@pytest.mark.cuda
def test_cuda_ssd_intra_at_the_encode_drivers_chunk_matches_plain():
    """``encode --backbone zamba2-2.7b`` feeds 16-token sequences, so
    ``mamba_apply`` launches ``ssd_intra`` at Q = 16 (one 64-row q tile,
    mostly padding) with zamba2-2.7b's H = 80, P = 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import ref, ssd

    rng = np.random.default_rng(16)
    n, q, h, p = 64, 16, 80, 64
    cb = (rng.standard_normal((n, q, q)) / np.sqrt(q)).astype(np.float32)
    la = np.cumsum(-np.abs(rng.standard_normal((n, q, h))) * 0.05,
                   axis=1).astype(np.float32)
    x = rng.standard_normal((n, q, h, p)).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (cb, la, x)]
    got = ssd.ssd_intra(*args).cpu()
    want = ref.ssd_intra(*[a.cpu() for a in args])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
