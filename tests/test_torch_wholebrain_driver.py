"""The port's whole-brain driver (``repro_torch.launch.wholebrain``) against
the reference's, as the CI lanes run it (``.github/workflows/ci.yml``: the
faults lane's ``--crash-only --smoke`` and the whole-brain lane's
``--smoke`` with per-phase traces), with ``--device cpu``.

Both packages' crash gates run on copies of one crash store the port's
``RunStore`` wrote: both gates pass, the resume accounting is the same, λ
is equal and the weight shards agree within ``tests/test_kernels.py::
_tol`` (f32).  The kernel-tier A/B runs only on a card (``cuda``-marked).
"""
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.data.store import RunStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# As tests/test_kernels.py::_tol, f32.
F32 = dict(rtol=1e-4, atol=2e-4)
# The smoke crash gate's subject (launch/wholebrain.py: run_crash_gate) and
# the smoke fold count.
CRASH = "crash_subject_128x128x512"
SMOKE_FOLDS = 6


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


def _write_crash_store(root, n=128, p=128, t=512, rows_per_run=64):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((n, p)).astype(np.float32)
    W = (rng.standard_normal((p, t)) / np.sqrt(p)).astype(np.float32)
    Y = (X @ W * 2.0 + rng.standard_normal((n, t))).astype(np.float32)
    store = RunStore.create(root, n_folds=SMOKE_FOLDS)
    for lo in range(0, n, rows_per_run):
        store.write(X[lo:lo + rows_per_run], Y[lo:lo + rows_per_run],
                    f"sub-01_rows-{lo:08d}")


def _shards(bundle):
    paths = sorted(glob.glob(os.path.join(bundle, "step_0", "W__*.npy")))
    return {os.path.basename(p): np.load(p) for p in paths}


@pytest.mark.timeout(600)
def test_crash_only_smoke_matches_reference(tmp_path):
    store = str(tmp_path / "store")
    _write_crash_store(store)
    docs = {}
    for pkg in ("repro", "repro_torch"):
        work = tmp_path / pkg
        shutil.copytree(store, work / CRASH)
        args = [f"{pkg}.launch.wholebrain", "--crash-only", "--smoke",
                "--workdir", str(work)]
        if pkg == "repro_torch":
            args += ["--device", "cpu"]
        out = _ok(_run(args, env_extra={"REPRO_OBS_STRICT": "1",
                                        "JAX_PLATFORMS": "cpu"}))
        assert "crash-resume: killed after block 1" in out
        name = ("BENCH_wholebrain_torch_crash.json" if pkg == "repro_torch"
                else "BENCH_wholebrain_crash.json")
        with open(work / name) as f:
            docs[pkg] = json.load(f)["crash_resume"]
    # The faults lane's checks, on the port's artifact.
    gate = docs["repro_torch"]
    assert gate["w_shards_bitwise"] >= 1
    assert gate["resumed"]["resumed"] is True
    assert gate["resumed"]["io_giveups"] == 0
    assert gate["faulty"]["io_retries"] >= 3
    assert gate["faulty"]["io_giveups"] == 0
    ref = docs["repro"]
    for key in ("kill_after_block", "n_blocks", "w_shards_bitwise"):
        assert gate[key] == ref[key], key
    for run in ("ref", "resumed", "faulty"):
        for key in ("blocks_replayed", "blocks_streamed", "resumed",
                    "best_lambda", "gram_compiles", "colblock_compiles"):
            assert gate[run][key] == ref[run][key], (run, key)
    tw, jw = (_shards(tmp_path / pkg / "crash_bundle_ref")
              for pkg in ("repro_torch", "repro"))
    assert tw.keys() == jw.keys() and tw
    for fname in tw:
        np.testing.assert_allclose(tw[fname], jw[fname], **F32)


@pytest.mark.timeout(600)
def test_smoke_run_full_loop_on_cpu(tmp_path):
    """The whole-brain lane: materialise, two fits at t = 262,144 under the
    1,024 MB cap, the crash gate and the column serve; no kernel tier on
    the CPU, so no A/B and the reason instead; then the fit trace's
    coverage gate."""
    work = tmp_path / "wb"
    out = _ok(_run(["repro_torch.launch.wholebrain", "--device", "cpu",
                    "--smoke", "--workdir", str(work),
                    "--trace-out", str(tmp_path / "wb.jsonl"),
                    "--metrics-out", str(tmp_path / "wb.json")],
                   env_extra={"REPRO_OBS_STRICT": "1"}))
    assert "kernel A/B skipped" in out
    with open(work / "BENCH_wholebrain_torch_smoke.json") as f:
        doc = json.load(f)
    assert doc["fused_ab"] is None
    assert "CUDA" in doc["fused_ab_reason"]
    assert doc["t"] == 262_144 and doc["device"] == "cpu"
    fits = doc["fit_vs_t_block"]
    assert [f["t_block"] for f in fits] == [16_384, 20_480]
    assert len({f["best_lambda"] for f in fits}) == 1
    for fit in fits:
        assert fit["peak_rss_mb"] < doc["rss_cap_mb"] \
            < fit["unblocked_stats_mb"]
        assert (fit["gram_compiles"], fit["colblock_compiles"]) == (1, 1)
        assert fit["row_passes_x"] <= 2
        assert fit["device_peak_mb"] is None
        # No CUDA stack to discount on the CPU: the gate holds the peak.
        assert fit["cuda_context_rss_mb"] is None
        assert fit["rss_over_context_mb"] is None
        assert fit["rss_held_mb"] == fit["peak_rss_mb"]
    assert doc["serve"]["shards_paged"] < doc["serve"]["weight_shards"]
    assert doc["crash_resume"]["w_shards_bitwise"] >= 1
    _ok(_run(["repro_torch.launch.obs_report",
              str(tmp_path / "wb.fit16384.jsonl"),
              "--assert-coverage", "0.95"]))
    assert not os.path.exists(os.path.join(REPO,
                                           "BENCH_wholebrain_torch.json"))


def test_ab_phase_refuses_without_cuda(tmp_path):
    p = _run(["repro_torch.launch.wholebrain", "--phase", "ab",
              "--device", "cpu", "--store", str(tmp_path / "ab"),
              "--n", "128", "--t", "512", "--t-block", "128",
              "--n-folds", "6", "--chunk-rows", "64"])
    assert p.returncode != 0
    assert "needs a CUDA device" in p.stderr, p.stderr
    assert not os.path.exists(tmp_path / "ab")


@pytest.mark.cuda
@pytest.mark.timeout(600)
def test_cuda_ab_phase_kernel_tier_matches_plain(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel tier has no CPU mode")
    out = _ok(_run(["repro_torch.launch.wholebrain", "--phase", "ab",
                    "--device", "cuda", "--store", str(tmp_path / "ab"),
                    "--n", "128", "--t", "512", "--t-block", "128",
                    "--n-folds", "6", "--chunk-rows", "64"]))
    line = [ln for ln in out.splitlines()
            if ln.startswith("WHOLEBRAIN_RESULT ")][-1]
    res = json.loads(line.split(" ", 1)[1])
    assert res["kernel_tier"] == "cuda" and res["lambda_match"] is True
    assert res["row_passes_x"] <= 2
