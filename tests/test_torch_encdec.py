"""The port's encoder-decoder LM (``EncDecLM``, the audio family) against
the JAX package.

``smoke(seamless-m4t-medium)`` (d_model 256, 2 encoder layers) with a
second decoder layer (smoke keeps one), so that every stacked decoder
tree is indexed by layer, and f32 parameters: the configs and definition trees, then the same numpy source
frames and tokens and the same parameters (the JAX ``model.init`` tree
carried across by ``convert.model_params_from_numpy``) through both
packages' ``encode``, ``hidden_states`` and ``forward``; ``prefill`` and
``decode_step`` past the self cache's ring wrap; ``ServeEngine``'s audio
branch; and the audio ``batch_spec``.  S = 32 source frames and tokens
with ``flash_threshold = flash_block = 16`` runs the streaming attention
path in all three of its uses (encoder, causal decoder self-attention,
cross-attention with S ≠ T in the decode tests): ``einsum`` is the plain
block loop, ``kernel`` JAX's Pallas kernel in interpret mode and the
port's plain version of its CUDA kernel; ``dense`` materialises the
scores.
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
from repro.models import encdec as jencdec
from repro.models import params as jparams
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import synthetic as tsynthetic
from repro_torch.models import build_model as tbuild
from repro_torch.models import encdec as tencdec
from repro_torch.models import params as tparams
from repro_torch.serving import ServeEngine, ServeRequest

F32 = dict(rtol=1e-4, atol=2e-4)
# bf16 rounds at other places in the two packages (XLA keeps f32 inside a
# fusion, PyTorch rounds after every op): held to 3e-2 of the largest
# value, as tests/test_torch_decoder.py holds the decoders.
BF16_REL = 3e-2
ARCH = "seamless-m4t-medium"
PATHS = ["dense", "einsum", "kernel"]
SEQ, FLASH = 32, 16
# The prefill sizes the self cache to DECODE_LEN positions; STEPS decode
# steps from position 1 write slots 1..STEPS mod DECODE_LEN, past the wrap.
DECODE_LEN, STEPS = 8, 12


def _dt_name(d):
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return np.dtype(d).name


def _cfgs(path="kernel", dtype="float32", **over):
    """The smoke config with 2 + 2 layers in each package on one attention
    path."""
    out = []
    for mod, dt_mod in ((jconfigs, jnp), (tconfigs, torch)):
        cfg = mod.smoke(mod.get_config(ARCH))
        kw = dict(param_dtype=getattr(dt_mod, dtype), n_layers=2)
        if path != "dense":
            kw.update(flash_threshold=FLASH, flash_block=FLASH,
                      flash_kernel=path == "kernel")
        out.append(dataclasses.replace(cfg, **{**kw, **over}))
    return out


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


def _batch(d_model, vocab, seed, b=2, src=SEQ, tgt=SEQ):
    rng = np.random.default_rng(seed)
    return {"src_embeds": rng.standard_normal((b, src, d_model)).astype(
                np.float32),
            "tokens": rng.integers(0, vocab, (b, tgt)).astype(np.int32)}


_MEMO: dict = {}


def _setup(path, dtype="float32", **over):
    key = ("setup", path, dtype, tuple(sorted(over.items())))
    if key not in _MEMO:
        jcfg, tcfg = _cfgs(path, dtype, **over)
        jm, tm = jbuild(jcfg), tbuild(tcfg)
        jp = jm.init(jax.random.PRNGKey(1))
        tp = convert.model_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
        _MEMO[key] = (jcfg, tcfg, jm, tm, jp, tp)
    return _MEMO[key]


def _both(nb):
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


# --------------------------------------------------------------------------
# Config, definition trees, batches
# --------------------------------------------------------------------------

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


@pytest.mark.parametrize("smoke", [False, True])
def test_encdec_param_and_cache_defs_match_the_reference(smoke):
    j, t = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    if smoke:
        j, t = jconfigs.smoke(j), tconfigs.smoke(t)
    jm, tm = jbuild(j), tbuild(t)
    assert isinstance(tm, tencdec.EncDecLM)
    assert tm.remat == jm.remat is True
    assert _def_rows(tm.param_defs()) == _def_rows(jm.param_defs())
    assert tparams.count_params(tm.param_defs()) == \
        jparams.count_params(jm.param_defs())
    assert tparams.param_bytes(tm.param_defs()) == \
        jparams.param_bytes(jm.param_defs())
    assert tencdec.CROSS_LEN == jencdec.CROSS_LEN == 4096
    for args in ((2, 48), (3, 8192), (1, 16, 24)):
        assert _def_rows(tm.cache_defs(*args)) == \
            _def_rows(jm.cache_defs(*args))
    cache = tm.init_cache(2, 8, 24, device="cpu")
    assert [tuple(a.shape) for a in tparams.leaves(cache)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jm.init_cache(2, 8, 24))]
    assert all(torch.count_nonzero(a) == 0 for a in tparams.leaves(cache))


def test_full_size_is_the_published_width():
    m = tbuild(tconfigs.get_config(ARCH))
    n = tparams.count_params(m.param_defs())
    # 12 + 12 layers at d 1,024 and the tied 256,206-row embedding.
    assert n == jparams.count_params(jbuild(jconfigs.get_config(ARCH))
                                     .param_defs())
    # ~0.61 B parameters, ~1.23 GB in bf16 (the norm scales are f32).
    assert 0.6e9 < n < 0.62e9
    assert 1.2e9 < tparams.param_bytes(m.param_defs()) < 1.25e9


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_audio_batches_follow_the_reference_spec(kind):
    jcfg, tcfg = _cfgs()
    js = jsynthetic.batch_spec(jcfg, 3, 20, kind)
    ts = tsynthetic.batch_spec(tcfg, 3, 20, kind)
    assert list(js) == list(ts)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in js.items()} == \
        {k: (shape, _dt_name(dt)) for k, (shape, dt) in ts.items()}
    b = tsynthetic.make_batch(torch.Generator().manual_seed(0), tcfg, 3, 20,
                              kind, device="cpu")
    for k, (shape, dt) in ts.items():
        assert tuple(b[k].shape) == shape and b[k].dtype == dt
    if kind != "decode":
        se = b["src_embeds"].float()
        assert abs(se.mean().item()) < 0.1 and abs(se.std().item() - 1) < 0.1


# --------------------------------------------------------------------------
# Encoder, teacher-forced decoder, logits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_encode_matches_jax(path):
    jcfg, tcfg, jm, tm, jp, tp = _setup(path)
    jb, tb = _both(_batch(jcfg.d_model, jcfg.vocab, 3))
    want = jax.jit(jm.encode)(jp, jb["src_embeds"])
    with torch.inference_mode():
        got = tm.encode(tp, tb["src_embeds"])
    assert tuple(got.shape) == (2, SEQ, 256)
    _close(got, want)


@pytest.mark.parametrize("path", PATHS)
def test_encdec_hidden_states_and_forward_match_jax(path):
    jcfg, tcfg, jm, tm, jp, tp = _setup(path)
    jb, tb = _both(_batch(jcfg.d_model, jcfg.vocab, 4))
    hj, ht = jax.jit(jm.hidden_states)(jp, jb), tm.hidden_states(tp, tb)
    assert tuple(ht.shape) == (2, SEQ, 256) and ht.is_inference()
    _close(ht, hj)
    (lj, aj), (lt, at) = jax.jit(jm.forward)(jp, jb), tm.forward(tp, tb)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, SEQ, 512)
    _close(lt, lj)
    assert float(at) == float(aj) == 0.0


@pytest.mark.parametrize("path", ["einsum", "kernel"])
def test_cross_attention_with_fewer_tokens_than_frames_matches_jax(path):
    """16 target tokens against 48 frames: every streaming attention of
    the decoder has its own S and T."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(path)
    jb, tb = _both(_batch(jcfg.d_model, jcfg.vocab, 5, src=48, tgt=16))
    _close(tm.hidden_states(tp, tb), jax.jit(jm.hidden_states)(jp, jb))


def test_encdec_bf16_forward_matches_jax():
    jcfg, tcfg, jm, tm, jp, tp = _setup("kernel", "bfloat16")
    jb, tb = _both(_batch(jcfg.d_model, jcfg.vocab, 6))
    _close(tm.forward(tp, tb)[0], jax.jit(jm.forward)(jp, jb)[0],
           "bfloat16")


# --------------------------------------------------------------------------
# Prefill and cached decode
# --------------------------------------------------------------------------

def _decode(path):
    """Both packages' prefill (DECODE_LEN self slots), then STEPS decode
    steps from the JAX prefill's cache fed the JAX argmax tokens; and the
    port's own greedy run from its own prefill (memoised)."""
    key = ("decode", path)
    if key in _MEMO:
        return _MEMO[key]
    jcfg, tcfg, jm, tm, jp, tp = _setup(path)
    nb = _batch(jcfg.d_model, jcfg.vocab, 7, tgt=1)
    jb, tb = _both(nb)
    jb["decode_len"] = tb["decode_len"] = DECODE_LEN
    # Eager: decode_len sizes the cache, so it cannot be traced.
    pj, cj = jm.prefill(jp, jb)
    pt, ct = tm.prefill(tp, tb)
    r = dict(prefill=(pj, pt), cache=(cj, _leaves_np(ct)))
    decode = jax.jit(jm.decode_step)
    cache = convert.cache_from_numpy(jax.tree_util.tree_map(np.asarray, cj),
                                     tcfg, device="cpu")
    steps, want_toks, got_toks = [], [], []
    lj, lt = pj, pt
    for i in range(STEPS):
        tok = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)[:, None]
        want_toks.append(np.asarray(tok)[:, 0])
        own = torch.argmax(lt[:, -1], -1).to(torch.int32)[:, None]
        got_toks.append(own[:, 0].numpy().copy())
        lj, cj = decode(jp, cj, tok, jnp.int32(1 + i))
        step_t, cache = tm.decode_step(tp, cache,
                                       torch.from_numpy(np.array(tok)), 1 + i)
        steps.append((lj, _leaves_np(cj), step_t, _leaves_np(cache)))
        lt, ct = tm.decode_step(tp, ct, own, 1 + i)
    r.update(steps=steps, greedy=(np.stack(want_toks, 1),
                                  np.stack(got_toks, 1)))
    _MEMO[key] = r
    return r


@pytest.mark.parametrize("path", ["dense", "kernel"])
def test_encdec_prefill_matches_jax(path):
    r = _decode(path)
    pj, pt = r["prefill"]
    assert tuple(pt.shape) == (2, 1, 512)
    _close(pt, pj)
    cj, ct = r["cache"]
    want = _leaves_np(cj)
    assert len(ct) == len(want) == 4       # cross k, cross v, self k, v
    for got, w in zip(ct, want):
        _close(got, w)
    # cross_k/v (L, B, frames, kv, hd); the self cache DECODE_LEN slots.
    assert ct[0].shape == (2, 2, SEQ, 4, 64)
    assert ct[2].shape == (2, 2, DECODE_LEN, 4, 64)


@pytest.mark.parametrize("path", ["dense", "kernel"])
def test_encdec_decode_past_the_ring_wrap_matches_jax(path):
    """Positions 1 … 12 of an 8-slot self cache: steps 8 … 12 overwrite
    the oldest slots; every step's logits and cache leaves are held, and
    the port's own greedy run equals the reference's tokens."""
    r = _decode(path)
    for lj, cj, lt, ct in r["steps"]:
        assert tuple(lt.shape) == (2, 1, 512)
        _close(lt, lj)
        for got, want in zip(ct, cj):
            _close(got, want)
    want, got = r["greedy"]
    np.testing.assert_array_equal(got, want)


def test_prefill_without_decode_len_keeps_one_self_slot_as_the_reference():
    """With no ``decode_len`` the self cache has as many slots as the
    batch has tokens (one, in ``serve``): each decoded token then attends
    to itself alone, in both packages."""
    jcfg, tcfg, jm, tm, jp, tp = _setup("dense")
    jb, tb = _both(_batch(jcfg.d_model, jcfg.vocab, 8, tgt=1))
    pj, cj = jm.prefill(jp, jb)
    pt, ct = tm.prefill(tp, tb)
    assert ct["self"]["k"].shape[2] == cj["self"]["k"].shape[2] == 1
    _close(pt, pj)
    tok = torch.argmax(pt[:, -1], -1).to(torch.int32)[:, None]
    lj, _ = jm.decode_step(jp, cj, jnp.asarray(tok.numpy()), jnp.int32(1))
    lt, _ = tm.decode_step(tp, ct, tok, 1)
    _close(lt, lj)


def test_cache_from_numpy_takes_the_encdec_cache():
    jcfg, tcfg = _cfgs()
    jcache = jbuild(jcfg).init_cache(3, 40, 24)
    tree = jax.tree_util.tree_map(np.asarray, jcache)
    got = convert.cache_from_numpy(tree, tcfg, device="cpu")
    assert [tuple(a.shape) for a in tparams.leaves(got)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jcache)]
    with pytest.raises(ValueError, match="cross_k"):
        convert.cache_from_numpy(dict(tree, cross_k=tree["cross_k"][0]),
                                 tcfg, device="cpu")


# --------------------------------------------------------------------------
# ServeEngine's audio branch
# --------------------------------------------------------------------------

def test_serve_engine_audio_greedy_tokens_equal_jax():
    """Zero source frames of (wave, prompt_len, d), decode from position
    1, a padded last wave, uneven ``max_new_tokens``, then an ``eos_id``
    that ends a request at its second token."""
    jcfg, tcfg, jm, tm, jp, tp = _setup("dense")
    rng = np.random.default_rng(9)
    spec = [(3, 6), (8, 2), (12, 5), (1, 4), (6, 1)]
    prompts = [rng.integers(1, 512, n).tolist() for n, _ in spec]
    je = jengine.ServeEngine(jm, jp, jcfg, wave_size=2, prompt_len=8)
    te = ServeEngine(tm, tp, tcfg, wave_size=2, prompt_len=8, device="cpu")

    def serve(eos):
        reqs = [ServeRequest(prompt=p, max_new_tokens=m, eos_id=eos.get(i))
                for i, (p, (_, m)) in enumerate(zip(prompts, spec))]
        want = [r.tokens for r in je.serve(
            [jengine.ServeRequest(**dataclasses.asdict(r)) for r in reqs])]
        got = [r.tokens for r in te.serve(reqs)]
        assert got == want
        return got

    got = serve({})
    assert [len(t) for t in got] == [m for _, m in spec]
    eos = got[2][1]
    got = serve({2: eos})
    assert got[2][-1] == eos and len(got[2]) <= 2
