"""The port's decoder LMs (``DecoderLM``: dense, MoE, VLM) against the JAX
package, from the forward through prefill and cached decode.

For each of the seven decoder archs, at ``configs.smoke`` sizes with f32
parameters: the configs and definition trees, then the same numpy tokens
(and, for the VLM, prefix embeddings) and the same parameters (the JAX
``model.init`` tree carried across by ``convert.model_params_from_numpy``)
through both packages' ``hidden_states``/``forward``, ``prefill`` and
three ``decode_step``s.  The decode starts from the JAX prefill's cache
carried across by ``convert.cache_from_numpy`` and feeds both packages
the JAX argmax tokens, so each step is held on its own: logits and every
cache leaf.  S = 32 with ``flash_threshold = flash_block = 16`` runs the
streaming attention path (``einsum``: the plain block loop; ``kernel``:
JAX's Pallas kernel in interpret mode, the port's plain version of its
CUDA kernel); ``dense`` materialises the scores, as ``serve --arch`` does
at the reference's defaults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import synthetic as tsynthetic
from repro_torch.device import host_view
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.transformer import DecoderLM

F32 = dict(rtol=1e-4, atol=2e-4)
# bf16 rounds at other places in the two packages (XLA keeps f32 inside a
# fusion, PyTorch rounds after every op): held to 3e-2 of the largest value.
BF16_REL = 3e-2
DECODERS = ["qwen3-1.7b", "gemma-7b", "gemma2-2b", "gemma3-12b",
            "phi3.5-moe-42b-a6.6b", "grok-1-314b", "llava-next-34b"]
# The forward runs the streaming attention path in both of its forms; the
# prefill runs the kernel form and the materialised scores.
FORWARD_PATHS, DECODE_PATHS = ["einsum", "kernel"], ["dense", "kernel"]
SEQ, FLASH, STEPS = 32, 16, 3


def _dt_name(d):
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return np.dtype(d).name


def _cfgs(arch, path="kernel", dtype="float32", **over):
    """The smoke config in each package on one attention path."""
    out = []
    for mod, dt_mod in ((jconfigs, jnp), (tconfigs, torch)):
        cfg = mod.smoke(mod.get_config(arch))
        kw = dict(param_dtype=getattr(dt_mod, dtype))
        if path != "dense":
            kw.update(flash_threshold=FLASH, flash_block=FLASH,
                      flash_kernel=path == "kernel")
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


def _batch(cfg, seed, b=2, s=SEQ):
    """numpy inputs of one batch: tokens, and for the VLM the stub's
    prefix embeddings over the first half of the sequence."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        half = s // 2
        return {"prefix_embeds": rng.standard_normal(
                    (b, half, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (b, s - half)).astype(
                    np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


_MEMO: dict = {}


def _setup(arch, path, dtype, seq, **over):
    jcfg, tcfg = _cfgs(arch, path, dtype, **over)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = convert.model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    nb = _batch(jcfg, 2, s=seq)
    return (jcfg, tcfg, jm, tm, jp, tp,
            {k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _forward(arch, path, dtype="float32"):
    """Both packages' hidden states, logits and MoE aux (memoised)."""
    key = ("forward", arch, path, dtype)
    if key not in _MEMO:
        jcfg, tcfg, jm, tm, jp, tp, jb, tb = _setup(arch, path, dtype, SEQ)
        (lj, aj), (lt, at) = jax.jit(jm.forward)(jp, jb), tm.forward(tp, tb)
        _MEMO[key] = dict(tcfg=tcfg, logits=(lj, lt), aux=(aj, at),
                          hidden=(jax.jit(jm.hidden_states)(jp, jb),
                                  tm.hidden_states(tp, tb)))
    return _MEMO[key]


def _decode(arch, path, dtype="float32", seq=SEQ):
    """Both packages' prefill, then STEPS decode steps from the JAX
    prefill's cache fed the JAX argmax tokens (memoised)."""
    key = ("decode", arch, path, dtype, seq)
    if key in _MEMO:
        return _MEMO[key]
    jcfg, tcfg, jm, tm, jp, tp, jb, tb = _setup(arch, path, dtype, seq)
    pj, cj = jax.jit(jm.prefill)(jp, jb)
    pt, ct = tm.prefill(tp, tb)
    r = dict(prefill=(pj, pt), cache=(cj, ct))
    decode = jax.jit(jm.decode_step)
    cache = convert.cache_from_numpy(jax.tree_util.tree_map(np.asarray, cj),
                                     tcfg, device="cpu")
    steps = []
    for i in range(STEPS):
        tok = jnp.argmax(pj[:, -1], -1).astype(jnp.int32)[:, None]
        pj, cj = decode(jp, cj, tok, jnp.int32(seq + i))
        lt, cache = tm.decode_step(tp, cache, torch.from_numpy(np.array(tok)),
                                   seq + i)
        steps.append((pj, _leaves_np(cj), lt, _leaves_np(cache)))
    r["steps"] = steps
    _MEMO[key] = r
    return r


# --------------------------------------------------------------------------
# Configs, definition trees, batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("smoke", [False, True])
def test_decoder_configs_equal_the_reference(arch, smoke):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if smoke:
        j, t = jconfigs.smoke(j), tconfigs.smoke(t)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert _dt_name(jd.pop("param_dtype")) == _dt_name(td.pop("param_dtype"))
    assert jd == td
    assert (t.resolved_head_dim, t.n_repeats) == (j.resolved_head_dim,
                                                  j.n_repeats)
    assert isinstance(tbuild(t), DecoderLM)


def _def_rows(tree):
    """(path, shape, axes, dtype, init, scale, fan_in) of every leaf."""
    rows = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        else:
            rows.append((path, tuple(t.shape), tuple(t.axes),
                         _dt_name(t.dtype), t.init, t.scale, t.fan_in))

    walk(tree, "")
    return rows


@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_param_and_cache_defs_match_the_reference(arch):
    for smoke in (False, True):
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        if smoke:
            j, t = jconfigs.smoke(j), tconfigs.smoke(t)
        jm, tm = jbuild(j), tbuild(t)
        assert _def_rows(tm.param_defs()) == _def_rows(jm.param_defs())
        assert tparams.count_params(tm.param_defs()) == \
            jparams.count_params(jm.param_defs())
        for b, s in ((2, 48), (3, 8192)):
            assert _def_rows(tm.cache_defs(b, s)) == \
                _def_rows(jm.cache_defs(b, s))
    cache = tm.init_cache(2, 40, device="cpu")
    assert all(torch.count_nonzero(a) == 0 for a in tparams.leaves(cache))
    assert [a.dtype for a in tparams.leaves(cache)] == \
        [d.dtype for d in tparams.leaves(tm.cache_defs(2, 40))]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_vlm_batches_follow_the_reference_spec(kind):
    jcfg, tcfg = _cfgs("llava-next-34b")
    js = jsynthetic.batch_spec(jcfg, 3, 20, kind)
    ts = tsynthetic.batch_spec(tcfg, 3, 20, kind)
    assert list(js) == list(ts)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in js.items()} == \
        {k: (shape, _dt_name(dt)) for k, (shape, dt) in ts.items()}
    b = tsynthetic.make_batch(torch.Generator().manual_seed(0), tcfg, 3, 20,
                              kind, device="cpu")
    again = tsynthetic.make_batch(torch.Generator().manual_seed(0), tcfg, 3,
                                  20, kind, device="cpu")
    for k, (shape, dt) in ts.items():
        assert tuple(b[k].shape) == shape and b[k].dtype == dt
        assert torch.equal(b[k], again[k])
    if kind != "decode":
        pe = b["prefix_embeds"].float()
        assert abs(pe.mean().item()) < 0.1 and abs(pe.std().item() - 1) < 0.1


# --------------------------------------------------------------------------
# Layers of the decode path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("var", [dict(), dict(window=5), dict(softcap=7.0)],
                         ids=lambda v: str(v) or "global")
@pytest.mark.parametrize("pos,as_tensor", [(5, False), (29, False),
                                           (29, True)],
                         ids=["pos5", "pos29", "pos29-tensor"])
def test_attention_decode_matches_jax(var, pos, as_tensor):
    """A ring cache of C = 12 slots: before the first wrap (pos 5: slots
    past pos are invalid) and after it (29), with a window and a softcap;
    pos as a Python int and as a 0-d tensor."""
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    jp = jparams.init(jax.random.PRNGKey(3), jlayers.attention_defs(jcfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    shape = (2, 12, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    cache = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    want, want_cache = jlayers.attention_decode(
        jp, jcfg, jlayers.AttnVariant(**var), jnp.asarray(x), jnp.int32(pos),
        {n: jnp.asarray(a) for n, a in cache.items()})
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got, got_cache = tlayers.attention_decode(
        _to_torch(jp), tcfg, tlayers.AttnVariant(**var), torch.from_numpy(x),
        torch.tensor(pos) if as_tensor else pos, tcache)
    _close(got, want)
    for n in ("k", "v"):
        assert got_cache[n] is tcache[n]          # written in place
        _close(got_cache[n], want_cache[n])


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("cap", [None, 3.0], ids=["nocap", "softcap"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_matches_jax(tied, cap, dtype):
    jcfg, tcfg = _cfgs("qwen3-1.7b", dtype=dtype, tie_embeddings=tied,
                       final_logit_softcap=cap)
    jp = jparams.init(jax.random.PRNGKey(5), jlayers.embed_defs(jcfg))
    x = np.random.default_rng(6).standard_normal(
        (2, 3, jcfg.d_model)).astype(np.float32)
    want = jlayers.unembed(jp, jcfg, jnp.asarray(x).astype(jcfg.param_dtype))
    got = tlayers.unembed(_to_torch(jp), tcfg,
                          torch.from_numpy(x).to(tcfg.param_dtype))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "grok-1-314b"])
@pytest.mark.parametrize("cf", [0.5, 1.25], ids=["drops", "default"])
def test_moe_apply_matches_jax(arch, cf):
    """Two groups of 64 tokens; at capacity factor 0.5 each expert takes
    16 of the ~32 slots routed to it and drops the rest."""
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf)) for c in _cfgs(arch))
    jp = jparams.init(jax.random.PRNGKey(7), jmoe.moe_defs(jcfg))
    x = np.random.default_rng(8).standard_normal(
        (4, 32, jcfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got, got_aux = tmoe.moe_apply(_to_torch(jp), tcfg, torch.from_numpy(x))
    _close(got, want)
    _close(got_aux, want_aux)
    # A token whose every routed slot was dropped comes out zero.
    n_zero = int((np.abs(_np(got)).max(-1) == 0).sum())
    assert (n_zero > 0) == (cf < 1.0), n_zero
    with pytest.raises(ValueError, match="MoE groups"):
        tmoe.moe_apply(_to_torch(jp), tcfg, torch.zeros(3, 50, jcfg.d_model))


# --------------------------------------------------------------------------
# The model: forward, prefill, cached decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", FORWARD_PATHS)
@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_forward_matches_jax(arch, path):
    r = _forward(arch, path)
    hj, ht = r["hidden"]
    assert tuple(ht.shape) == (2, SEQ, 256) and ht.is_inference()
    _close(ht, hj)
    lj, lt = r["logits"]
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, SEQ, 512)
    _close(lt, lj)
    aj, at = r["aux"]
    _close(at, aj)
    assert (float(at) > 0) == (r["tcfg"].moe is not None)


@pytest.mark.parametrize("path", DECODE_PATHS)
@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_prefill_matches_jax(arch, path):
    r = _decode(arch, path)
    pj, pt = r["prefill"]
    assert tuple(pt.shape) == (2, 1, 512)
    _close(pt, pj)
    cj, ct = r["cache"]
    assert _leaves_np(ct).__len__() == len(jax.tree_util.tree_leaves(cj))
    for got, want in zip(_leaves_np(ct), _leaves_np(cj)):
        _close(got, want)


@pytest.mark.parametrize("path", DECODE_PATHS)
@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_decode_steps_match_jax(arch, path):
    for lj, cj, lt, ct in _decode(arch, path)["steps"]:
        assert tuple(lt.shape) == (2, 1, 512)
        _close(lt, lj)
        assert len(ct) == len(cj)
        for got, want in zip(ct, cj):
            _close(got, want)


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-12b"])
def test_decoder_decode_past_the_ring_wrap_matches_jax(arch):
    """S = 48 against a local window of 32: the local layers' prefill
    cache holds positions 16–47 rolled by 48 % 32 = 16, and the decode
    steps write slots 16–18 over the oldest keys (pos ≥ C)."""
    r = _decode(arch, "kernel", seq=48)
    _, ct = r["cache"]
    assert ct["b0"]["k"].shape[2] == 32 and ct["b1"]["k"].shape[2] == 48
    for got, want in zip(_leaves_np(ct), _leaves_np(r["cache"][0])):
        _close(got, want)
    for lj, cj, lt, c in r["steps"]:
        _close(lt, lj)
        for got, want in zip(c, cj):
            _close(got, want)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b",
                                  "phi3.5-moe-42b-a6.6b", "llava-next-34b"])
def test_decoder_bf16_matches_jax(arch):
    r = _decode(arch, "kernel", "bfloat16")
    _close(r["prefill"][1], r["prefill"][0], "bfloat16")
    for lj, _, lt, _ in r["steps"]:
        _close(lt, lj, "bfloat16")


def test_cache_from_numpy_checks_keys_and_shapes():
    jcfg, tcfg = _cfgs("gemma2-2b")
    jcache = jbuild(jcfg).init_cache(3, 40)
    tree = jax.tree_util.tree_map(np.asarray, jcache)
    got = convert.cache_from_numpy(tree, tcfg, device="cpu")
    assert [tuple(a.shape) for a in tparams.leaves(got)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jcache)]
    assert all(a.dtype == torch.float32 for a in tparams.leaves(got))
    bad = {"b0": tree["b0"],
           "b1": dict(tree["b1"], k=np.zeros((1, 3, 40, 2, 7), np.float32))}
    with pytest.raises(ValueError, match="b1/k"):
        convert.cache_from_numpy(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.cache_from_numpy({"b0": tree["b0"]}, tcfg, device="cpu")
