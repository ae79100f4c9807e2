"""The decode half of the port's Mamba2 and hybrid models against the JAX
package: ``mamba_apply(return_cache=True)``, ``mamba_decode``, and
``HybridLM.prefill``/``decode_step``.

``smoke(zamba2-2.7b)`` and ``smoke(mamba2-130m)`` with f32 parameters
(the JAX ``model.init`` tree carried across by
``convert.model_params_from_numpy``).  S = 32 with chunk 8 and
``flash_threshold = flash_block = 16``; ``kernel`` turns on the SSD and
flash kernel switches (JAX's Pallas kernels in interpret mode, the port's
plain versions of its CUDA kernels).  The decode starts from the JAX
prefill's cache carried across by ``convert.cache_from_numpy``, is fed
the JAX argmax tokens, and is held step by step: logits, SSM states, conv
tails and the shared block's KV cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.device import host_view
from repro_torch.models import build_model as tbuild
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm

F32 = dict(rtol=1e-4, atol=2e-4)
BF16_REL = 3e-2
HYBRIDS = ["zamba2-2.7b", "mamba2-130m"]
SEQ, FLASH, STEPS = 32, 16, 4


def _cfgs(arch, kernels=False, dtype="float32", **over):
    out = []
    for mod, dt_mod in ((jconfigs, jnp), (tconfigs, torch)):
        cfg = mod.smoke(mod.get_config(arch))
        kw = dict(param_dtype=getattr(dt_mod, dtype), flash_threshold=FLASH,
                  flash_block=FLASH, flash_kernel=kernels,
                  ssm=dataclasses.replace(cfg.ssm, use_kernel=kernels))
        out.append(dataclasses.replace(cfg, **{**kw, **over}))
    return out


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else host_view(np.array(v)) for k, v in tree.items()}


def _np(x):
    """A float32 numpy copy (the port's decode writes its cache in place)."""
    return np.array(x.float() if isinstance(x, torch.Tensor) else
                    jnp.asarray(x, jnp.float32), np.float32)


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves_np(tree[k])]
    return [_np(tree)]


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_REL * np.abs(want).max())


def _mixer_params(jcfg, seed):
    """Mamba mixer parameters with non-trivial decays and step biases
    (init leaves them 0)."""
    jp = jparams.init(jax.random.PRNGKey(seed), jssm.mamba_defs(jcfg))
    rng = np.random.default_rng(seed)
    return dict(jp, **{k: jnp.asarray(rng.normal(0, 0.5, jp[k].shape),
                                      jnp.float32)
                       for k in ("A_log", "dt_bias")})


@pytest.mark.parametrize("arch", HYBRIDS)
@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "kernel"])
def test_mamba_prefill_cache_and_decode_match_jax(arch, kernels):
    jcfg, tcfg = _cfgs(arch, kernels)
    jp = _mixer_params(jcfg, 3)
    tp = _to_torch(jp)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, SEQ, jcfg.d_model)).astype(np.float32)
    yj, cj = jssm.mamba_apply(jp, jcfg, jnp.asarray(u), return_cache=True)
    yt, ct = tssm.mamba_apply(tp, tcfg, torch.from_numpy(u),
                              return_cache=True)
    _close(yt, yj)
    assert ct["state"].dtype == torch.float32
    assert ct["conv"].shape == (2, jcfg.ssm.conv_kernel - 1,
                                cj["conv"].shape[-1])
    for name in ("state", "conv"):
        _close(ct[name], cj[name])
    # Each step from the JAX cache: one token of fresh input.
    ct = {k: torch.from_numpy(np.array(v)) for k, v in cj.items()}
    for _ in range(STEPS):
        u1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        yj, cj = jssm.mamba_decode(jp, jcfg, jnp.asarray(u1), cj)
        yt, ct = tssm.mamba_decode(tp, tcfg, torch.from_numpy(u1), ct)
        _close(yt, yj)
        for name in ("state", "conv"):
            _close(ct[name], cj[name])


def test_mamba_decode_continues_the_full_sequence():
    """The recurrence picks up where the chunked pass stopped: the prefill
    of the first S positions, then one decode step a position, gives the
    full pass's outputs for the next 8 (the port alone, f32)."""
    jcfg, tcfg = _cfgs("zamba2-2.7b")
    tp = _to_torch(_mixer_params(jcfg, 5))
    u = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, SEQ + 8, tcfg.d_model)).astype(np.float32))
    full = tssm.mamba_apply(tp, tcfg, u)
    _, cache = tssm.mamba_apply(tp, tcfg, u[:, :SEQ], return_cache=True)
    for t in range(SEQ, SEQ + 8):
        y, cache = tssm.mamba_decode(tp, tcfg, u[:, t:t + 1], cache)
        torch.testing.assert_close(y, full[:, t:t + 1], **F32)


@pytest.mark.parametrize("arch", HYBRIDS)
def test_hybrid_cache_defs_match_the_reference(arch):
    def rows(tree, path=""):
        if isinstance(tree, dict):
            return [r for k in sorted(tree)
                    for r in rows(tree[k], f"{path}/{k}")]
        dt = tree.dtype
        name = str(dt).removeprefix("torch.") if isinstance(
            dt, torch.dtype) else np.dtype(dt).name
        return [(path, tuple(tree.shape), tuple(tree.axes), name, tree.init)]

    for smoke in (False, True):
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        if smoke:
            j, t = jconfigs.smoke(j), tconfigs.smoke(t)
        for win in (None, 24):
            jm = jbuild(dataclasses.replace(j, shared_attn_window=win))
            tm = tbuild(dataclasses.replace(t, shared_attn_window=win))
            for b, s in ((2, 32), (8, 256)):
                assert rows(tm.cache_defs(b, s)) == rows(jm.cache_defs(b, s))
    cache = tm.init_cache(2, 16, device="cpu")
    assert all(torch.count_nonzero(a) == 0 for a in tparams.leaves(cache))


_MEMO: dict = {}


def _run(arch, kernels, dtype="float32", **over):
    """Both packages' forward logits, prefill and STEPS decode steps from
    the JAX prefill's cache (memoised)."""
    key = (arch, kernels, dtype, tuple(sorted(over.items())))
    if key in _MEMO:
        return _MEMO[key]
    jcfg, tcfg = _cfgs(arch, kernels, dtype, **over)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(7))
    tp = convert.model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    tok = np.random.default_rng(8).integers(0, jcfg.vocab, (2, SEQ)).astype(
        np.int32)
    r = {}
    r["logits"] = (jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tok)})[0],
                   tm.forward(tp, {"tokens": torch.from_numpy(tok)})[0])
    pj, cj = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tok)})
    pt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(tok)})
    r["prefill"], r["cache"] = (pj, pt), (_leaves_np(cj), _leaves_np(ct))
    decode = jax.jit(jm.decode_step)
    cache = convert.cache_from_numpy(jax.tree_util.tree_map(np.asarray, cj),
                                     tcfg, device="cpu")
    steps = []
    for i in range(STEPS):
        t1 = jnp.argmax(pj[:, -1], -1).astype(jnp.int32)[:, None]
        pj, cj = decode(jp, cj, t1, jnp.int32(SEQ + i))
        lt, cache = tm.decode_step(tp, cache, torch.from_numpy(np.array(t1)),
                                   SEQ + i)
        steps.append((pj, _leaves_np(cj), lt, _leaves_np(cache)))
    r["steps"] = steps
    _MEMO[key] = r
    return r


@pytest.mark.parametrize("arch", HYBRIDS)
@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "kernel"])
def test_hybrid_forward_and_prefill_match_jax(arch, kernels):
    r = _run(arch, kernels)
    _close(r["logits"][1], r["logits"][0])
    pj, pt = r["prefill"]
    assert tuple(pt.shape) == (2, 1, 512) and pt.dtype == torch.float32
    _close(pt, pj)
    cj, ct = r["cache"]
    assert len(ct) == len(cj) == (4 if arch == "zamba2-2.7b" else 2)
    for got, want in zip(ct, cj):
        _close(got, want)


@pytest.mark.parametrize("arch", HYBRIDS)
@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "kernel"])
def test_hybrid_decode_steps_match_jax(arch, kernels):
    for lj, cj, lt, ct in _run(arch, kernels)["steps"]:
        assert tuple(lt.shape) == (2, 1, 512)
        _close(lt, lj)
        for got, want in zip(ct, cj):
            _close(got, want)


def test_hybrid_shared_window_ring_matches_jax():
    """A shared-attention window of 24 < S: the shared block's cache holds
    positions 8–31 rolled by 32 % 24 = 8, and decode wraps over them."""
    r = _run("zamba2-2.7b", True, shared_attn_window=24)
    assert r["cache"][1][-2].shape[2] == 24       # shared k: (R, B, C, N, K)
    for got, want in zip(*reversed(r["cache"])):
        _close(got, want)
    for lj, cj, lt, ct in r["steps"]:
        _close(lt, lj)
        for got, want in zip(ct, cj):
            _close(got, want)


@pytest.mark.parametrize("arch", HYBRIDS)
def test_hybrid_bf16_prefill_and_decode_match_jax(arch):
    r = _run(arch, True, "bfloat16")
    _close(r["prefill"][1], r["prefill"][0], "bfloat16")
    for lj, _, lt, _ in r["steps"]:
        _close(lt, lj, "bfloat16")
