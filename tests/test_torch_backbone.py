"""The port's backbone-features slice against the JAX package.

Tokens → ``HybridLM.hidden_states`` → features ``X`` → ``pipeline.run``,
for ``smoke(zamba2-2.7b)`` and ``smoke(mamba2-130m)``.  Both packages get
the same numpy tokens and the same parameters (the JAX ``model.init`` tree,
carried across by ``convert.model_params_from_numpy``); the port runs on
the CPU (plain versions of its kernels), the reference on the JAX CPU
backend with its Pallas kernels in interpret mode where a switch asks for
them.  S = 32 with ``flash_threshold = flash_block = 16``, so the streaming
attention path runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.encoding import EncoderConfig as JConfig
from repro.encoding import pipeline as jpipeline
from repro.models import build_model as jbuild
from repro.models import config as jmconfig
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import scoring as tscoring
from repro_torch.data import synthetic as tsynthetic
from repro_torch.device import host_view
from repro_torch.encoding import EncoderConfig as TConfig
from repro_torch.encoding import pipeline as tpipeline
from repro_torch.models import build_model as tbuild
from repro_torch.models import config as tmconfig
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm

F32 = dict(rtol=1e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
ARCHS = ["zamba2-2.7b", "mamba2-130m"]
SEQ, FLASH = 32, 16


def _dt_name(d):
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return np.dtype(d).name


def _cfgs(arch, dtype="float32", kernels=False, **over):
    """The smoke config in each package with the slice's switches."""
    out = []
    for mod, dt_mod in ((jconfigs, jnp), (tconfigs, torch)):
        cfg = mod.smoke(mod.get_config(arch))
        kw = dict(param_dtype=getattr(dt_mod, dtype), flash_threshold=FLASH,
                  flash_block=FLASH, flash_kernel=kernels,
                  ssm=dataclasses.replace(cfg.ssm, use_kernel=kernels))
        cfg = dataclasses.replace(cfg, **{**kw, **over})
        out.append(cfg)
    return out


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else host_view(np.array(v)) for k, v in tree.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _tokens(seed, vocab, b=2, s=SEQ):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# --------------------------------------------------------------------------
# Configs, parameter trees, batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ModelConfig", "SSMConfig", "MoEConfig",
                                  "InputShape"])
def test_config_classes_keep_every_reference_field_and_default(name):
    jf = {f.name: f.default for f in
          dataclasses.fields(getattr(jmconfig, name))}
    tf = {f.name: f.default for f in
          dataclasses.fields(getattr(tmconfig, name))}
    assert set(jf) == set(tf)
    for k in jf:
        if k == "param_dtype":
            assert _dt_name(jf[k]) == "bfloat16" and tf[k] == torch.bfloat16
        else:
            assert jf[k] == tf[k], k
    assert tmconfig.INPUT_SHAPES == {
        k: tmconfig.InputShape(**dataclasses.asdict(v))
        for k, v in jmconfig.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS + ["seamless-m4t-medium"])
@pytest.mark.parametrize("smoke", [False, True])
def test_ported_configs_equal_the_reference(arch, smoke):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if smoke:
        j, t = jconfigs.smoke(j), tconfigs.smoke(t)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert _dt_name(jd.pop("param_dtype")) == _dt_name(td.pop("param_dtype"))
    assert jd == td
    assert (t.resolved_head_dim, t.n_repeats) == (j.resolved_head_dim,
                                                  j.n_repeats)


# Every arch is ported: the decoder archs are held against the reference
# in tests/test_torch_decoder.py, the audio arch in
# tests/test_torch_encdec.py.  (The test keeps its name from when the audio
# arch still refused, naming ROADMAP item 12.)
def test_unported_archs_and_families_raise_naming_the_roadmap():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_config(arch)
        assert type(tbuild(cfg)).__name__ == \
            type(jbuild(jconfigs.get_config(arch))).__name__
    # The audio family's batches have the reference's shapes and dtypes.
    jcfg = jconfigs.get_config("seamless-m4t-medium")
    tcfg = tconfigs.get_config("seamless-m4t-medium")
    assert tcfg.family == "audio"
    for kind in ("train", "prefill", "decode"):
        js = jsynthetic.batch_spec(jcfg, 2, 8, kind)
        ts = tsynthetic.batch_spec(tcfg, 2, 8, kind)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in js.items()} \
            == {k: (shape, _dt_name(dt)) for k, (shape, dt) in ts.items()}
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


def _def_tree(tree):
    return jax.tree_util.tree_map(
        lambda d: (d.shape, d.axes, _dt_name(d.dtype), d.init, d.scale,
                   d.fan_in), tree, is_leaf=jparams.is_def)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_the_reference_at_full_size(arch):
    j = jbuild(jconfigs.get_config(arch)).param_defs()
    t = tbuild(tconfigs.get_config(arch)).param_defs()
    assert tparams.tree_map(lambda d: (d.shape, d.axes, _dt_name(d.dtype),
                                       d.init, d.scale, d.fan_in), t) \
        == _def_tree(j)
    assert tparams.count_params(t) == jparams.count_params(j)
    assert tparams.param_bytes(t) == jparams.param_bytes(j)
    if arch == "zamba2-2.7b":
        assert tparams.count_params(t) == 2_340_750_240
        assert tparams.param_bytes(t) == 4_682_371_200


def test_init_follows_the_reference_rules_and_the_seed():
    _, cfg = _cfgs("zamba2-2.7b")
    model = tbuild(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    again = model.init(torch.Generator().manual_seed(0), device="cpu")
    other = model.init(torch.Generator().manual_seed(1), device="cpu")
    defs = model.param_defs()
    for d, a, b, c in zip(tparams.leaves(defs), tparams.leaves(p),
                          tparams.leaves(again), tparams.leaves(other)):
        assert tuple(a.shape) == d.shape and a.dtype == d.dtype
        assert torch.equal(a, b)
        if d.init == "zeros":
            assert not a.any()
        elif d.init == "ones":
            assert bool((a == 1).all())
        else:
            assert not torch.equal(a, c)
            want = tparams._std(d)
            assert abs(a.float().std().item() / want - 1) < 0.1, d
    # The stacked leaves keep no explicit fan_in, as in the reference.
    wz = defs["blocks"]["b0"]["mixer"]["wz"]
    assert wz.fan_in is None
    assert tparams._std(wz) == pytest.approx(
        1 / np.sqrt(cfg.d_model * wz.shape[2]))
    bf = tparams.init(defs, torch.Generator().manual_seed(0),
                      torch.bfloat16, device="cpu")
    assert all(a.dtype == torch.bfloat16 for a in tparams.leaves(bf))


def test_backbone_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    _, cfg = _cfgs("mamba2-130m")
    g = torch.Generator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild(cfg).init(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsynthetic.make_batch(g, cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.model_params_from_numpy({}, cfg)
    assert tsynthetic.make_batch(g, cfg, 1, 8, device="cpu")[
        "tokens"].device.type == "cpu"


def test_model_params_from_numpy_carries_the_jax_tree():
    jcfg, tcfg = _cfgs("zamba2-2.7b", "bfloat16")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    got = convert.model_params_from_numpy(tree, tcfg, device="cpu")
    as_u16 = convert.model_params_from_numpy(
        jax.tree_util.tree_map(
            lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
            tree), tcfg, device="cpu")
    for a, b, c in zip(jax.tree_util.tree_leaves(jp), tparams.leaves(got),
                       tparams.leaves(as_u16)):
        assert b.dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16
                           else torch.float32)
        np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32))
        assert torch.equal(b, c)
    bad = dict(tree, final_norm={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        convert.model_params_from_numpy(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.model_params_from_numpy({"embed": tree["embed"]}, tcfg,
                                        device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_synthetic_batches_follow_the_reference_spec(arch, kind):
    jcfg, tcfg = _cfgs(arch)
    js = jsynthetic.batch_spec(jcfg, 3, 20, kind)
    ts = tsynthetic.batch_spec(tcfg, 3, 20, kind)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in js.items()} == \
        {k: (shape, _dt_name(dt)) for k, (shape, dt) in ts.items()}
    b = tsynthetic.make_batch(torch.Generator().manual_seed(0), tcfg, 3, 20,
                              kind, device="cpu")
    again = tsynthetic.make_batch(torch.Generator().manual_seed(0), tcfg, 3,
                                  20, kind, device="cpu")
    tok = b["tokens"]
    assert tok.dtype == torch.int32 and tuple(tok.shape) == ts["tokens"][0]
    assert 0 <= int(tok.min()) and int(tok.max()) < tcfg.vocab
    assert torch.equal(tok, again["tokens"])


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

VARIANTS = [dict(), dict(window=8), dict(softcap=30.0),
            dict(causal=False), dict(window=12, softcap=20.0)]


@pytest.mark.parametrize("var", VARIANTS, ids=lambda v: str(v) or "causal")
@pytest.mark.parametrize("path", ["kernel", "blockwise", "dense"])
def test_attention_matches_jax(var, path):
    over = {} if path != "dense" else dict(flash_threshold=None)
    jcfg, tcfg = _cfgs("zamba2-2.7b", kernels=path == "kernel", **over)
    jp = jparams.init(jax.random.PRNGKey(2), jlayers.attention_defs(jcfg))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, SEQ, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (2, SEQ))
    want = jlayers.attention(jp, jcfg, jlayers.AttnVariant(**var),
                             jnp.asarray(x), jnp.asarray(pos))
    got = tlayers.attention(_to_torch(jp), tcfg, tlayers.AttnVariant(**var),
                            torch.from_numpy(x), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_cross_attention_and_gqa_dense_path_match_jax():
    jcfg, tcfg = _cfgs("zamba2-2.7b", n_kv_heads=2, flash_threshold=None)
    jp = jparams.init(jax.random.PRNGKey(4), jlayers.attention_defs(jcfg))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    var = dict(causal=False, use_rope=False)
    want = jlayers.attention(jp, jcfg, jlayers.AttnVariant(**var),
                             jnp.asarray(x), jnp.asarray(pos),
                             kv_x=jnp.asarray(kv))
    got = tlayers.attention(_to_torch(jp), tcfg, tlayers.AttnVariant(**var),
                            torch.from_numpy(x), torch.from_numpy(pos),
                            kv_x=torch.from_numpy(kv))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu"])
def test_mlp_and_norm_match_jax(act):
    jcfg, tcfg = _cfgs("zamba2-2.7b", mlp_act=act)
    jp = jparams.init(jax.random.PRNGKey(5), jlayers.mlp_defs(jcfg))
    x = np.random.default_rng(9).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlayers.mlp(_to_torch(jp), tcfg, torch.from_numpy(x))),
        _np(jlayers.mlp(jp, jcfg, jnp.asarray(x))), **F32)
    scale = {"scale": np.linspace(0.5, 2, jcfg.d_model, dtype=np.float32)}
    np.testing.assert_allclose(
        _np(tlayers.rmsnorm(_to_torch(scale), torch.from_numpy(x), 1e-6)),
        _np(jlayers.rmsnorm(scale, jnp.asarray(x), 1e-6)), **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "kernel"])
def test_mamba_apply_matches_jax(arch, kernels):
    jcfg, tcfg = _cfgs(arch, kernels=kernels)
    jp = jparams.init(jax.random.PRNGKey(6), jssm.mamba_defs(jcfg))
    # Non-trivial decays and skip weights (init leaves them 0 and 1).
    rng = np.random.default_rng(10)
    jp = dict(jp, A_log=jnp.asarray(rng.normal(0, 0.5, jp["A_log"].shape),
                                    jnp.float32),
              dt_bias=jnp.asarray(rng.normal(0, 0.5, jp["dt_bias"].shape),
                                  jnp.float32))
    u = rng.standard_normal((2, SEQ, jcfg.d_model)).astype(np.float32)
    want = jssm.mamba_apply(jp, jcfg, jnp.asarray(u))
    got = tssm.mamba_apply(_to_torch(jp), tcfg, torch.from_numpy(u))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # The prefill's decode cache: the last chunk's state and the conv tail.
    want, want_cache = jssm.mamba_apply(jp, jcfg, jnp.asarray(u),
                                        return_cache=True)
    got, got_cache = tssm.mamba_apply(_to_torch(jp), tcfg,
                                      torch.from_numpy(u), return_cache=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert set(got_cache) == set(want_cache) == {"state", "conv"}
    for name in want_cache:
        assert tuple(got_cache[name].shape) == want_cache[name].shape
        np.testing.assert_allclose(_np(got_cache[name]),
                                   _np(want_cache[name]), **F32)


# --------------------------------------------------------------------------
# The whole forward and the slice
# --------------------------------------------------------------------------

def _hidden(arch, dtype, kernels, seed=1, b=2, s=SEQ):
    jcfg, tcfg = _cfgs(arch, dtype, kernels)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    tp = convert.model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    tok = _tokens(seed, jcfg.vocab, b, s)
    hj = jbuild(jcfg).hidden_states(jp, {"tokens": jnp.asarray(tok)})
    ht = tbuild(tcfg).hidden_states(tp, {"tokens": torch.from_numpy(tok)})
    return _np(hj), _np(ht), ht


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_hidden_states_match_jax(arch, kernels):
    hj, ht, raw = _hidden(arch, "float32", kernels)
    assert raw.shape == (2, SEQ, 256) and raw.dtype == torch.float32
    assert not raw.requires_grad and raw.is_inference()
    np.testing.assert_allclose(ht, hj, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_bf16_match_jax(arch):
    """bf16 rounds at other places in the two packages (XLA keeps f32
    inside a fusion, PyTorch rounds after every op), so a value near zero
    can carry the rounding of the large values beside it: the bf16 case is
    held to 3e-2 of the largest hidden state."""
    hj, ht, raw = _hidden(arch, "bfloat16", True)
    assert raw.dtype == torch.bfloat16
    np.testing.assert_allclose(ht, hj, rtol=0,
                               atol=BF16["atol"] * np.abs(hj).max())


def test_backbone_features_to_pipeline_run_match_jax():
    """encode.py's steps: tokens → hidden states → standardized X → planted
    Y → pipeline.run.  The port splits rows with its own generator, so the
    reference fits the port's training rows (standardize → fit)."""
    b, s, t = 40, SEQ, 20
    hj, ht, _ = _hidden("zamba2-2.7b", "float32", True, seed=11, b=b, s=s)
    rng = np.random.default_rng(12)
    d = hj.shape[-1]
    w_true = (rng.standard_normal((d, t)) / np.sqrt(d)).astype(np.float32)
    w_true[:, t // 2:] = 0.0
    noise = rng.standard_normal((b * s, t)).astype(np.float32)

    def features(h):
        X = h.reshape(-1, d)
        X = (X - X.mean(0)) / (X.std(0) + 1e-6)
        return X.astype(np.float32), (2.0 * X @ w_true + noise).astype(
            np.float32)

    Xj, Yj = features(hj)
    Xt = torch.from_numpy(ht).reshape(-1, d)
    Xt = (Xt - Xt.mean(0)) / (Xt.std(0, correction=0) + 1e-6)
    Yt = 2.0 * Xt @ torch.from_numpy(w_true) + torch.from_numpy(noise)
    np.testing.assert_allclose(Xt.numpy(), Xj, **F32)

    st = tpipeline.run(Xt, Yt, TConfig(), device="cpu",
                       detrend_targets=False, n_perms=3)
    tr, _ = tscoring.train_test_split_indices(
        torch.Generator().manual_seed(0), b * s, 0.1)
    tr = tr.numpy()
    jst = jpipeline.run_stages(jnp.asarray(Xj[tr]), jnp.asarray(Yj[tr]), [
        jpipeline.standardize(), jpipeline.fit(JConfig())])
    assert st.report.decision.solver == "ridge"
    np.testing.assert_array_equal(st.report.best_lambda,
                                  np.asarray(jst.report.best_lambda))
    np.testing.assert_allclose(st.report.weights.numpy(),
                               np.asarray(jst.report.weights), **F32)
    np.testing.assert_allclose(st.report.cv_scores,
                               np.asarray(jst.report.cv_scores), **F32)
    assert st.evaluation.significant


@pytest.mark.cuda
def test_cuda_hidden_states_kernels_match_plain_path():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import attention, ssd

    _, cfg = _cfgs("zamba2-2.7b", kernels=True)
    plain = dataclasses.replace(cfg, flash_kernel=False,
                                ssm=dataclasses.replace(cfg.ssm,
                                                        use_kernel=False))
    model = tbuild(cfg)
    p = model.init(torch.Generator("cuda").manual_seed(0))
    tok = {"tokens": torch.from_numpy(_tokens(0, cfg.vocab)).cuda()}
    attention.reset_launches()
    ssd.reset_launches()
    got = model.hidden_states(p, tok)
    assert attention.LAUNCHES["flash_attention"] == 1
    assert ssd.LAUNCHES["ssd_intra"] == 1
    want = tbuild(plain).hidden_states(p, tok)
    torch.testing.assert_close(got, want, **F32)
