"""The port's LM serving path against the JAX package: the sampler,
``ServeEngine``, and the ``serve --arch`` / ``encode --backbone`` drivers
on decoder archs.

JAX's ``categorical`` draws cannot be reproduced in torch, so the sampler
is held on its greedy ids and on the kept set its filters leave (the
logits the reference hands to ``jax.random.categorical``, captured), and
the port's draws are held to be repeatable from a seed and inside that
set.  ``ServeEngine`` is held by its greedy tokens on the same converted
weights, with a padded last wave, an ``eos_id`` and uneven
``max_new_tokens``.  The drivers run as subprocesses on the same flags in
both packages (``--device cpu`` for the port); their random weights
differ, so they are held by their lines' format and shapes.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.serving import engine as jengine
from repro.serving import sampler as jsampler
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import build_model as tbuild
from repro_torch.serving import (SamplerConfig, ServeEngine, ServeRequest,
                                 sample)
from repro_torch.serving.sampler import filter_logits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_ARCHS = ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b"]


def _logits(seed, b=4, v=512):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32) * 3


def _reference_kept(logits, cfg, monkeypatch):
    """The logits the reference's ``sample`` hands to
    ``jax.random.categorical``: its filtered, temperature-scaled logits."""
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jsampler.sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                    jsampler.SamplerConfig(**dataclasses.asdict(cfg)))
    return seen["logits"]


# --------------------------------------------------------------------------
# Sampler
# --------------------------------------------------------------------------

def test_sampler_config_equals_the_reference():
    jf = {f.name: f.default
          for f in dataclasses.fields(jsampler.SamplerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(SamplerConfig)}
    assert jf == tf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_greedy_sample_equals_jax(dtype, temperature):
    lg = _logits(1)
    cfg = SamplerConfig(temperature=temperature, top_k=3)
    want = jsampler.sample(jax.random.PRNGKey(0),
                           jnp.asarray(lg).astype(dtype),
                           jsampler.SamplerConfig(temperature=temperature,
                                                  top_k=3))
    got = sample(torch.Generator().manual_seed(0),
                 torch.from_numpy(lg).to(getattr(torch, dtype)), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


FILTERS = [dict(temperature=1.0, top_k=1), dict(temperature=0.7, top_k=5),
           dict(temperature=1.3, top_p=0.5), dict(temperature=0.5, top_p=0.9),
           dict(temperature=1.0, top_k=20, top_p=0.8),
           dict(temperature=2.0)]


@pytest.mark.parametrize("cfg", FILTERS, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_kept_set_equals_the_reference(cfg, monkeypatch):
    cfg = SamplerConfig(**cfg)
    lg = _logits(2)
    want = _reference_kept(lg, cfg, monkeypatch)
    got = filter_logits(torch.from_numpy(lg), cfg).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6)
    if cfg.top_k is not None and cfg.top_p is None:
        assert (np.isfinite(got).sum(-1) >= cfg.top_k).all()


def test_top_k_keeps_ties_as_the_reference(monkeypatch):
    lg = np.array([[5.0, 1.0, 3.0, 3.0, 3.0, 0.0],
                   [2.0, 2.0, 2.0, 2.0, 1.0, 9.0]], np.float32)
    cfg = SamplerConfig(temperature=1.0, top_k=2)
    want = _reference_kept(lg, cfg, monkeypatch)
    got = filter_logits(torch.from_numpy(lg), cfg).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).sum(-1).tolist() == [4, 5]


@pytest.mark.parametrize("cfg", FILTERS[1:], ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_draws_are_repeatable_and_inside_the_kept_set(cfg):
    cfg = SamplerConfig(**cfg)
    lg = torch.from_numpy(_logits(3))
    kept = torch.isfinite(filter_logits(lg, cfg))

    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([sample(g, lg, cfg) for _ in range(64)])

    a, b = draws(11), draws(11)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert bool(kept.gather(1, a.T.long()).all())
    # The draws vary: some row draws more than one id, and another seed
    # draws other ids.
    assert any(len(set(a[:, i].tolist())) > 1 for i in range(4))
    assert not torch.equal(a, draws(12))


# --------------------------------------------------------------------------
# ServeEngine
# --------------------------------------------------------------------------

def _engine_pair(arch, wave_size=2, prompt_len=8):
    jcfg, tcfg = (dataclasses.replace(mod.smoke(mod.get_config(arch)),
                                      param_dtype=dt)
                  for mod, dt in ((jconfigs, jnp.float32),
                                  (tconfigs, torch.float32)))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    tp = convert.model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    kw = dict(wave_size=wave_size, prompt_len=prompt_len)
    return (jengine.ServeEngine(jm, jp, jcfg, **kw),
            ServeEngine(tbuild(tcfg), tp, tcfg, device="cpu", **kw))


def _requests(vocab, eos=None):
    """Five requests: prompts shorter and longer than the prompt length,
    uneven max_new_tokens, so the third wave is padded."""
    rng = np.random.default_rng(5)
    lens, news = [3, 8, 12, 1, 6], [6, 2, 5, 4, 1]
    return [ServeRequest(prompt=rng.integers(1, vocab, n).tolist(),
                         max_new_tokens=m, eos_id=eos.get(i) if eos else None)
            for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_serve_engine_greedy_tokens_equal_jax(arch):
    je, te = _engine_pair(arch)
    reqs = _requests(512)
    want = [r.tokens for r in je.serve(
        [jengine.ServeRequest(**dataclasses.asdict(r)) for r in reqs])]
    got = [r.tokens for r in te.serve(reqs)]
    assert got == want
    assert [len(t) for t in got] == [r.max_new_tokens for r in reqs]
    # An eos_id ends its request at its first appearance, kept in the
    # output: request 0 stops at its third token, request 2 at its first.
    eos = {0: want[0][2], 2: want[2][0]}
    reqs = _requests(512, eos)
    want = [r.tokens for r in je.serve(
        [jengine.ServeRequest(**dataclasses.asdict(r)) for r in reqs])]
    got = [r.tokens for r in te.serve(reqs)]
    assert got == want
    assert got[0][-1] == eos[0] and len(got[2]) == want[2].index(eos[2]) + 1


def test_serve_engine_sampled_tokens_are_repeatable_from_the_generator():
    _, te = _engine_pair("qwen3-1.7b")
    cfg = SamplerConfig(temperature=1.0, top_k=8)

    def run(seed):
        eng = ServeEngine(te.model, te.params, te.cfg, wave_size=2,
                          prompt_len=8, sampler=cfg, device="cpu",
                          generator=torch.Generator().manual_seed(seed))
        return [r.tokens for r in eng.serve(_requests(512))]

    a = run(3)
    assert a == run(3)
    assert all(0 <= t < 512 for toks in a for t in toks)
    assert a != run(4)


# --------------------------------------------------------------------------
# Drivers
# --------------------------------------------------------------------------

def _popen(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-m", module, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


def _finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out + err
    return out


SERVE_LINES = [r"prefill: \d+\.\d\ds  logits \(2, 1, 512\)",
               r"decoded 16 tokens × batch 2 in \d+\.\d\ds "
               r"\(\d+\.\d tok/s\)",
               r"sample tokens: \[(\d+, ){11}\d+\]"]


@pytest.mark.timeout(600)
def test_serve_driver_llm_mode_prints_the_reference_lines():
    args = ["--arch", "qwen3-1.7b", "--smoke"]
    ref = _popen("repro.launch.serve", *args)
    port = _popen("repro_torch.launch.serve", *args, "--device", "cpu")
    for out in (_finish(ref), _finish(port)):
        lines = out.strip().splitlines()
        assert len(lines) == 3, out
        for line, pat in zip(lines, SERVE_LINES):
            assert re.fullmatch(pat, line), line


def test_serve_driver_llm_mode_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    proc = _popen("repro_torch.launch.serve", "--arch", "qwen3-1.7b",
                  "--smoke")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in err, err


@pytest.mark.timeout(600)
def test_encode_driver_decoder_backbones_as_the_reference():
    """``encode --backbone`` on a dense and the VLM arch: features are the
    final hidden states of every position (the VLM's prefix rows
    included), then the fit, as the reference's driver does."""
    args = ["--smoke", "--n", "256", "--targets", "32"]
    runs = {(arch, pkg): _popen(f"{pkg}.launch.encode", "--backbone", arch,
                                *args, *(["--device", "cpu"]
                                         if pkg == "repro_torch" else []))
            for arch in ("qwen3-1.7b", "llava-next-34b")
            for pkg in ("repro", "repro_torch")}
    outs = {k: _finish(p) for k, p in runs.items()}
    for arch in ("qwen3-1.7b", "llava-next-34b"):
        ref, port = outs[arch, "repro"], outs[arch, "repro_torch"]
        feat = f"backbone features from {arch}-smoke: X(256, 256) Y(256, 32)"
        assert feat in ref and feat in port
        for out in (ref, port):
            assert "dispatch: solver=ridge mesh=1x1" in out
            assert re.search(r"RidgeCV fit: per-batch λ = \[\d+\.\]", out)
            assert "test Pearson r: responsive targets mean=" in out
            assert "null permutation |r|: mean=" in out
