"""The PyTorch port stands alone: no JAX, no ``repro``, no silent CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_has_every_slice_module():
    mods = set(_port_modules())
    for m in ("repro_torch.kernels.ref", "repro_torch.kernels.gram",
              "repro_torch.kernels.ops", "repro_torch.kernels._build",
              "repro_torch.core.complexity", "repro_torch.core.foldstats",
              "repro_torch.core.ridge", "repro_torch.core.scoring",
              "repro_torch.encoding.config", "repro_torch.encoding.dispatch",
              "repro_torch.encoding.estimator",
              "repro_torch.encoding.pipeline", "repro_torch.data.fmri",
              "repro_torch.data.store", "repro_torch.resilience.policy",
              "repro_torch.resilience.cleanup", "repro_torch.convert",
              "repro_torch.kernels.attention", "repro_torch.kernels.ssd",
              "repro_torch.models", "repro_torch.models.config",
              "repro_torch.models.params", "repro_torch.models.layers",
              "repro_torch.models.ssm", "repro_torch.models.hybrid",
              "repro_torch.configs", "repro_torch.configs.zamba2_2_7b",
              "repro_torch.configs.mamba2_130m",
              "repro_torch.data.synthetic", "repro_torch.kernels.ridge_solve",
              "repro_torch.kernels.pearsonr", "repro_torch.wholebrain",
              "repro_torch.wholebrain.stats", "repro_torch.wholebrain.solver",
              "repro_torch.wholebrain.artifact", "repro_torch.checkpoint",
              "repro_torch.checkpoint.io", "repro_torch.serving_encoders",
              "repro_torch.serving_encoders.bundle", "repro_torch.core.mor",
              "repro_torch.core.banded",
              "repro_torch.serving_encoders.registry",
              "repro_torch.serving_encoders.service",
              "repro_torch.serving_encoders.traffic",
              "repro_torch.serving_encoders.fleet", "repro_torch.obs",
              "repro_torch.obs.metrics", "repro_torch.obs.trace",
              "repro_torch.obs.sentinel", "repro_torch.resilience.journal",
              "repro_torch.resilience.faultsim",
              "repro_torch.launch.obs_report",
              "repro_torch.launch.obscli", "repro_torch.launch.encode",
              "repro_torch.launch.wholebrain", "repro_torch.launch.serve",
              "repro_torch.launch.roofline_report",
              "repro_torch.configs.vgg16_ridge", "repro_torch.core.compat",
              "repro_torch.core.bmor", "repro_torch.encoding.sharding",
              "repro_torch.models.moe", "repro_torch.models.transformer",
              "repro_torch.serving", "repro_torch.serving.sampler",
              "repro_torch.serving.engine", "repro_torch.configs.qwen3_1_7b",
              "repro_torch.configs.gemma_7b", "repro_torch.configs.gemma2_2b",
              "repro_torch.configs.gemma3_12b",
              "repro_torch.configs.phi35_moe",
              "repro_torch.configs.grok1_314b",
              "repro_torch.configs.llava_next_34b",
              "repro_torch.configs.seamless_m4t_medium",
              "repro_torch.models.encdec", "repro_torch.models.scanning",
              "repro_torch.models.losses", "repro_torch.optim",
              "repro_torch.optim.adamw", "repro_torch.optim.schedule",
              "repro_torch.launch.steps", "repro_torch.launch.train",
              "repro_torch.launch.mesh", "repro_torch.launch.hlo_analysis",
              "repro_torch.models.spmd"):
        assert m in mods, m
    for src in ("gram.cu", "flash_attention.cu", "ssd.cu", "ridge_solve.cu",
                "pearsonr.cu"):
        assert (PORT / "kernels" / "csrc" / src).exists(), src


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        "import repro_torch\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "repro_torch.BrainEncoder, repro_torch.EncoderConfig\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_port_modules())


def test_training_slice_imports_load_no_jax_and_no_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.models.encdec, "
            "repro_torch.optim, repro_torch.launch.train\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_ast_scan_finds_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, name)


def test_encoder_without_cuda_raises_unless_cpu_requested():
    from repro_torch.encoding import BrainEncoder, pipeline
    from repro_torch.data import fmri

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BrainEncoder()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.run([[0.0]], [[0.0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fmri.generate(fmri.SubjectSpec(n=4, p=2, t=2), torch.Generator())
    assert BrainEncoder(device="cpu").device.type == "cpu"


def test_use_pallas_true_on_cpu_raises():
    from repro_torch.core import ridge
    from repro_torch.encoding import BrainEncoder, EncoderConfig

    with pytest.raises(ValueError, match="CUDA"):
        BrainEncoder(use_pallas=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        EncoderConfig(use_pallas=True).ridge_cv_config(device="cpu")
    X = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ridge.ridge_cv(X, X, ridge.RidgeCVConfig(n_folds=2, use_pallas=True))
    # Auto resolves off on the CPU, on for CUDA.
    assert EncoderConfig().resolve_use_pallas("cpu") is False
    assert EncoderConfig().resolve_use_pallas("cuda") is True


def test_unported_plans_raise_not_implemented_naming_roadmap():
    from repro.encoding import EncoderConfig as JConfig
    from repro.encoding import resolve as jresolve
    from repro_torch.core.banded import BandedConfig
    from repro_torch.encoding import EncoderConfig, dispatch

    # The multi-device plans are ported: on one device they resolve to the
    # reference's decision, and the fit refuses without a process group.
    from repro_torch.encoding import BrainEncoder
    for solver in ("bmor", "bmor_dual"):
        with pytest.raises(RuntimeError, match="no torch.distributed "
                                               "process group"):
            BrainEncoder(solver=solver, device="cpu").fit(
                torch.zeros(20, 4), torch.zeros(20, 3))
    # MOR and banded ridge (item 14) and B-MOR are ported: explicit solvers
    # and an auto config with bands= resolve to the reference's decision.
    for kw in (dict(solver="mor"), dict(solver="banded", bands=(5, 5)),
               dict(bands=(5, 5)), dict(solver="bmor"),
               dict(solver="bmor_dual")):
        got = dispatch.resolve(EncoderConfig(**kw), 100, 10, 5, 1,
                               device="cpu")
        want = jresolve(JConfig(**kw), 100, 10, 5, 1)
        assert (got.solver, got.method, got.data_shards, got.target_shards,
                got.predicted_cost) == \
            (want.solver, want.method, want.data_shards, want.target_shards,
             want.predicted_cost)
        assert got.rationale.split("; kernel tier")[0] == \
            want.rationale.split("; kernel tier")[0]
    # The streamed fit (item 6) is ported: the same budget now resolves.
    d = dispatch.resolve(EncoderConfig(device_memory_budget=10**6),
                         100_000, 64, 8, 1, device="cpu")
    assert (d.solver, d.method, d.data_shards) == ("ridge", "chunked", 1)
    # The whole-brain tier (item 7) is ported: an explicit target_block
    # resolves to the colblocked plan over budget and under it.
    d = dispatch.resolve(EncoderConfig(device_memory_budget=10**6,
                                       target_block=4), 100_000, 64, 8, 1,
                         device="cpu")
    assert (d.solver, d.method, d.target_block) == ("ridge", "colblocked", 4)
    d = dispatch.resolve(EncoderConfig(device_memory_budget=10**9,
                                       target_block=4), 100, 8, 16, 1,
                         device="cpu")
    assert (d.solver, d.method, d.target_block) == ("ridge", "colblocked", 4)
    assert "4 block(s) of t_block=4" in d.rationale
    assert EncoderConfig(bands=(2, 2)).banded_config() == BandedConfig(
        bands=(2, 2), n_candidates=16, log_lambda_range=(-2.0, 4.0),
        n_folds=5, jitter=1e-6)
    with pytest.raises(ValueError, match="bands must be set"):
        EncoderConfig().banded_config()


def test_mesh_slice_imports_load_no_jax_and_no_repro():
    """The mesh, the rule tables, the sharded steps and the collective
    count import neither JAX nor the reference package."""
    code = ("import sys\n"
            "import repro_torch, repro_torch.launch.mesh, "
            "repro_torch.launch.hlo_analysis, repro_torch.launch.steps, "
            "repro_torch.models.spmd, repro_torch.models.params, "
            "repro_torch.convert\n"
            "from repro_torch.models.params import RULES, specs, abstract\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
