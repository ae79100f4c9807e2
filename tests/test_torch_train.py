"""The port's training path against the JAX package: the losses of every
model family, their gradients, the chunked cross-entropy, per-layer
remat, AdamW and the cosine schedule, the train step (with microbatch
accumulation), the token stream, the train-state checkpoint and the
``train`` driver.

Models run at ``configs.smoke`` sizes with f32 parameters; both packages
get the same numpy batches and the same parameters (the JAX
``model.init`` tree through ``convert.model_params_from_numpy``).  JAX's
``jax.random`` draws cannot be reproduced in torch, so the port's
``TokenStream`` is held to its own contract (determinism, disjoint
shards, the reference's batch spec), and the step parity tests feed
numpy batches.  Gradients are held per leaf to 1e-4 of the leaf's
largest |g|.  The kernels have no backward: training runs with the
kernel switches off, and a kernel that autograd would need raises.
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

from repro import checkpoint as jcheckpoint
from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import synthetic as jsynthetic
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro.models.config import InputShape as JShape
from repro.optim import adamw as jadamw
from repro_torch import checkpoint as tcheckpoint
from repro_torch import configs as tconfigs
from repro_torch import convert, optim as toptim
from repro_torch.data import synthetic as tsynthetic
from repro_torch.device import host_view
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model as tbuild
from repro_torch.models import losses as tlosses
from repro_torch.models import params as tparams
from repro_torch.models.config import InputShape as TShape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=2e-4)
GRAD_REL = 1e-4
# One arch of each family; gemma2 brings the softcaps and a local window.
LOSS_ARCHS = ["qwen3-1.7b", "gemma2-2b", "phi3.5-moe-42b-a6.6b",
              "llava-next-34b", "zamba2-2.7b", "seamless-m4t-medium"]
SEQ = 16


@pytest.fixture(scope="module", autouse=True)
def _world_of_one():
    """The port's train step runs over a mesh: a (1, 1) mesh in a world of
    this one process, left at the end of the module."""
    from repro_torch.core import compat
    compat.init_world_of_one("cpu")
    yield
    compat.shutdown()


def _mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(model=1, device="cpu")


def _cfgs(arch, dtype="float32", **over):
    out = []
    for mod, dt_mod in ((jconfigs, jnp), (tconfigs, torch)):
        cfg = mod.smoke(mod.get_config(arch))
        out.append(dataclasses.replace(
            cfg, **{"param_dtype": getattr(dt_mod, dtype), **over}))
    return out


def _batch(cfg, seed, b=2, s=SEQ):
    """numpy training batch of ``cfg``'s family (the reference's
    ``batch_spec(kind="train")`` layout, f32 embeddings)."""
    rng = np.random.default_rng(seed)
    half = s // 2
    out = {}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.standard_normal(
            (b, half, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["src_embeds"] = rng.standard_normal(
            (b, half, cfg.d_model)).astype(np.float32)
    n_tok = s - half if cfg.family in ("vlm", "audio") else s
    out["tokens"] = rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)
    return out


def _both(nb):
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _np(x):
    return np.array(x.detach().float() if isinstance(x, torch.Tensor)
                    else jnp.asarray(x, jnp.float32), np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    return [tree]


_MEMO: dict = {}


def _setup(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _MEMO:
        jcfg, tcfg = _cfgs(arch, **over)
        jm, tm = jbuild(jcfg), tbuild(tcfg)
        jp = jm.init(jax.random.PRNGKey(1))
        tp = convert.model_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
        _MEMO[key] = (jcfg, tcfg, jm, tm, jp, tp)
    return _MEMO[key]


def _backward(model, params, batch):
    """(loss, grads) of the port's ``model.loss`` by ``loss.backward()``
    on fresh leaves sharing ``params``' storage."""
    live = tparams.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    loss = model.loss(live, batch)
    loss.backward()
    return loss.detach(), tparams.tree_map(lambda p: p.grad, live)


def _hold_grads(got, want):
    got, want = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max() + 1e-12)


# --------------------------------------------------------------------------
# Losses and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,path", [(a, "dense") for a in LOSS_ARCHS] +
                         [("gemma2-2b", "einsum"),
                          ("seamless-m4t-medium", "einsum")])
def test_loss_and_grads_match_jax(arch, path):
    """``model.loss`` and its gradient per parameter leaf; ``einsum``
    runs the streaming attention (the plain block loop, at S = 32 with
    ``flash_threshold = flash_block = 16``), as a training config with
    the flash path on and the kernel off does."""
    over = {} if path == "dense" else dict(flash_threshold=16,
                                           flash_block=16)
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, **over)
    jb, tb = _both(_batch(jcfg, 1, s=2 * SEQ if over else SEQ))
    lj, gj = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    lt, gt = _backward(tm, tp, tb)
    assert lt.dtype == torch.float32 and lt.shape == ()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    _hold_grads(gt, gj)
    if tcfg.moe is not None:
        # The loss carries router_aux_weight × the mean MoE aux.
        h, aux, _ = tm._layers(tp, tb, keep_cache=False)
        assert float(aux) > 0 and tcfg.moe.router_aux_weight > 0


def test_next_token_nll_equals_log_softmax_of_the_labels():
    """The label logit from the embedding rows equals the naive f64
    log-softmax gathered at the label, tied and untied, with a softcap."""
    rng = np.random.default_rng(2)
    for tied, cap in ((True, None), (False, 5.0)):
        _, cfg = _cfgs("qwen3-1.7b", tie_embeddings=tied,
                       final_logit_softcap=cap)
        p = tparams.init(tbuild(cfg).param_defs()["embed"],
                         torch.Generator().manual_seed(3), device="cpu")
        h = torch.from_numpy(rng.standard_normal((2, 9, 256)).astype(
            np.float32))
        tok = torch.from_numpy(rng.integers(0, 512, (2, 9)))
        w = (p["tok"].T if tied else p["out"]).double()
        logits = h[:, :-1].double() @ w
        if cap is not None:
            logits = torch.tanh(logits / cap) * cap
        naive = -torch.log_softmax(logits, -1).gather(
            -1, tok[:, 1:, None]).mean()
        got = tlosses.next_token_nll(p, cfg, h, tok)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(naive), rtol=1e-6)


@pytest.mark.parametrize("arch,chunks", [("qwen3-1.7b", 8),
                                         ("gemma2-2b", 4),
                                         ("phi3.5-moe-42b-a6.6b", 4)],
                         ids=["tied", "softcap", "untied"])
def test_chunked_ce_equals_single_pass_and_jax(arch, chunks):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, ce_vocab_chunks=chunks)
    tm1 = tbuild(dataclasses.replace(tcfg, ce_vocab_chunks=1))
    jb, tb = _both(_batch(jcfg, 4))
    lc, gc = _backward(tm, tp, tb)
    l1, g1 = _backward(tm1, tp, tb)
    np.testing.assert_allclose(float(lc), float(l1), rtol=1e-6)
    for a, b in zip(_leaves(gc), _leaves(g1)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=GRAD_REL * float(b.abs().max())
                                   + 1e-12)
    lj, gj = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    np.testing.assert_allclose(float(lc), float(lj), rtol=1e-5)
    _hold_grads(gc, gj)
    with pytest.raises(ValueError, match="chunks"):
        tlosses._chunked_lse(tp["embed"], dataclasses.replace(
            tcfg, ce_vocab_chunks=3), torch.zeros(1, 2, 256))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-2.7b", "seamless-m4t-medium"])
def test_remat_on_and_off_are_bitwise_equal(arch):
    _, tcfg, _, tm, _, tp = _setup(arch)
    tb = _both(_batch(tcfg, 5))[1]
    off = tbuild(tcfg)
    off.remat = False
    assert tm.remat
    (lr, gr), (lo, go) = _backward(tm, tp, tb), _backward(off, tp, tb)
    assert torch.equal(lr, lo)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(gr), _leaves(go)))
    # And through the train step's switch.
    shape = TShape("t", SEQ, 2, "train")
    on, no = (tsteps.build_train_step(tcfg, _mesh(), shape, remat=r).fn(
        *_placed(tcfg, tp), tb) for r in (True, False))
    assert torch.equal(on[2]["loss"], no[2]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(_loc(on[0])),
                                                 _leaves(_loc(no[0]))))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_remat_keeps_fewer_bytes_for_the_backward(arch):
    """What autograd keeps for the backward, counted by saved-tensor
    hooks around the loss: with remat the layer bodies keep only their
    inputs (their insides are recomputed), without it every
    intermediate."""
    tcfg = _cfgs(arch, n_layers=4 * len(
        tconfigs.smoke(tconfigs.get_config(arch)).pattern))[1]
    tp = tbuild(tcfg).init(torch.Generator().manual_seed(6), device="cpu")
    tb = _both(_batch(tcfg, 6))[1]

    def kept(remat):
        m = tbuild(tcfg)
        m.remat = remat
        live = tparams.tree_map(lambda p: p.detach().requires_grad_(True),
                                tp)
        n = [0]

        def pack(t):
            n[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            m.loss(live, tb)
        return n[0]

    assert kept(True) < 0.6 * kept(False)


# --------------------------------------------------------------------------
# AdamW and the schedule
# --------------------------------------------------------------------------

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "nested": {"b": rng.standard_normal(5).astype(np.float32),
                         "c": rng.standard_normal((2, 2)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 3).astype(np.float32),
        params) for _ in range(3)]
    return params, grads


def _t(tree):
    """Torch copies of a numpy tree (the optimizer updates them in place)."""
    return tparams.tree_map(lambda x: torch.from_numpy(x.copy()), tree)


def _placed(cfg, tree):
    """``tree`` placed on the (1, 1) mesh, as the train step takes its
    parameters, and AdamW's state of it.  The placed leaves are copies:
    the step updates them in place, the memoised parameters stay as
    they were."""
    params = convert.shard_params(tree, cfg, _mesh())
    return params, toptim.adamw_init(params)


def _loc(tree):
    """The local shards of a placed tree (on one rank, the whole
    tensors)."""
    return tparams.tree_map(tsteps.local, tree)


@pytest.mark.parametrize("clip", [1.0, None, 1e3],
                         ids=["clipped", "no-clip", "clip-inactive"])
def test_adamw_update_three_steps_matches_jax(clip):
    params, grads = _opt_trees(7)
    jcfg = joptim.AdamWConfig(lr=1e-2, grad_clip_norm=clip)
    tcfg = toptim.AdamWConfig(lr=1e-2, grad_clip_norm=clip)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp, js = params, joptim.adamw_init(params)
    tp, ts = _t(params), toptim.adamw_init(_t(params))
    for i, g in enumerate(grads):
        scale = joptim.cosine_schedule(i, warmup_steps=1, total_steps=4)
        jp, js, jmet = joptim.adamw_update(jcfg, jp, g, js, lr_scale=scale)
        tp, ts, tmet = toptim.adamw_update(
            tcfg, tp, _t(g), ts, lr_scale=toptim.cosine_schedule(
                i, warmup_steps=1, total_steps=4))
        for got, want in zip(_leaves(tp) + _leaves(ts["mu"])
                             + _leaves(ts["nu"]),
                             jax.tree_util.tree_leaves((jp, js["mu"],
                                                        js["nu"]))):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-7)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert tmet[k].dtype == torch.float32
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)


def test_adamw_bf16_parameters_within_one_ulp_of_jax():
    """f32 moments and arithmetic, then the cast back to the parameter's
    dtype: bf16 parameters land within one bf16 ulp of the reference's."""
    params, grads = _opt_trees(8)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                params)
    tp = tparams.tree_map(lambda x: torch.from_numpy(x).bfloat16(), params)
    js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
    cfg = dict(lr=1e-2)
    for g in grads:
        jp, js, _ = joptim.adamw_update(joptim.AdamWConfig(**cfg), jp, g, js)
        tp, ts, _ = toptim.adamw_update(toptim.AdamWConfig(**cfg), tp, _t(g),
                                        ts)
    assert all(a.dtype == torch.float32 for a in _leaves(ts["mu"]))
    for got, want in zip(_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert got.dtype == torch.bfloat16
        w = _np(want)
        np.testing.assert_allclose(_np(got), w, rtol=2 ** -8, atol=0)


def test_adamw_clips_before_the_moments_and_reports_the_raw_norm():
    p = {"w": torch.zeros(4)}
    _, state, met = toptim.adamw_update(
        toptim.AdamWConfig(lr=1e-3, grad_clip_norm=1.0), p,
        {"w": torch.full((4,), 1e6)}, toptim.adamw_init(p))
    assert float(met["grad_norm"]) > 1e5
    assert float(toptim.global_norm(state["mu"])) < 1.0


def test_global_norm_sums_the_leaves_in_reference_order():
    params, _ = _opt_trees(9)
    np.testing.assert_allclose(float(toptim.global_norm(_t(params))),
                               float(jadamw.global_norm(params)), rtol=1e-7)


def test_cosine_schedule_matches_jax():
    kw = dict(warmup_steps=10, total_steps=100, min_ratio=0.1)
    steps = list(range(0, 130, 3)) + [10, 100]
    got = [float(toptim.cosine_schedule(s, **kw)) for s in steps]
    want = [float(joptim.cosine_schedule(s, **kw)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0
    t = toptim.cosine_schedule(torch.tensor(55), **kw)
    assert t.dtype == torch.float32 and t.shape == ()


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "seamless-m4t-medium"])
def test_train_step_matches_the_reference_step(arch, micro):
    """One step of ``build_train_step`` against the reference's on a
    one-device host mesh: loss, gradient norm, the new parameters and
    the moments."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch)
    opt = dict(lr=1e-3)
    jshape, tshape = JShape("t", SEQ, 4, "train"), TShape("t", SEQ, 4,
                                                         "train")
    mesh = jmesh.make_host_mesh(model=1)
    jbundle = jsteps.build_train_step(jcfg, mesh, jshape,
                                      opt=joptim.AdamWConfig(**opt),
                                      microbatch=micro)
    tbundle = tsteps.build_train_step(tcfg, _mesh(), tshape,
                                      opt=toptim.AdamWConfig(**opt),
                                      microbatch=micro)
    jb, tb = _both(_batch(jcfg, 10, b=4))
    with mesh:
        jnew, jopt, jmet = jax.jit(jbundle.fn)(jp, joptim.adamw_init(jp), jb)
    tin, topt = _placed(tcfg, tp)
    tnew, topt, tmet = tbundle.fn(tin, topt, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    for got, want in zip(_leaves(_loc(tnew)),
                         jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    for name in ("mu", "nu"):
        _hold_grads(_loc(topt[name]), jopt[name])
    assert int(topt["step"]) == 1
    # The step updates its inputs in place (the reference donates them):
    # it returns the tensors it was given, each changed.
    assert all(a is b for a, b in zip(_leaves(tnew), _leaves(tin)))
    assert all(not torch.equal(a, b) for a, b in
               zip(_leaves(_loc(tnew)), _leaves(tp)) if a.numel() > 4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_train_step_inputs_match_the_reference_abstract_inputs(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    mesh = jmesh.make_host_mesh(model=1)
    jab = jsteps.build_train_step(jcfg, mesh, JShape("t", 32, 4, "train")
                                  ).abstract_inputs
    tab = tsteps.build_train_step(tcfg, _mesh(), TShape("t", 32, 4, "train")
                                  ).abstract_inputs

    def rows(tree):
        return [(tuple(d.shape), str(d.dtype).removeprefix("torch."))
                for d in _leaves(tree)]

    def jrows(tree):
        return [(tuple(s.shape), str(s.dtype))
                for s in jax.tree_util.tree_leaves(tree)]

    assert rows(tab[0]) == jrows(jab[0])
    assert rows(tab[1]) == jrows(jab[1])
    assert {k: (shape, str(dt).removeprefix("torch."))
            for k, (shape, dt) in tab[2].items()} == \
        {k: (tuple(s.shape), str(s.dtype)) for k, s in jab[2].items()}


def test_microbatch_falls_back_to_one_when_the_batch_does_not_split():
    _, tcfg, _, tm, _, tp = _setup("qwen3-1.7b")
    tb = _both(_batch(tcfg, 11, b=3))[1]
    one = tsteps.build_train_step(tcfg, _mesh(), TShape("t", SEQ, 3,
                                                              "train"))
    three_by_two = tsteps.build_train_step(tcfg, _mesh(),
                                           TShape("t", SEQ, 3, "train"),
                                           microbatch=2)
    a = one.fn(*_placed(tcfg, tp), tb)
    b = three_by_two.fn(*_placed(tcfg, tp), tb)
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(_loc(a[0])),
                                                 _leaves(_loc(b[0]))))


# --------------------------------------------------------------------------
# No silent loss of a gradient
# --------------------------------------------------------------------------

def test_model_kernels_raise_under_autograd():
    g = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(1, 16, 2, 8, generator=g) for _ in range(3))
    cb, la = torch.randn(2, 8, 8, generator=g), -torch.rand(2, 8, 3,
                                                            generator=g)
    x = torch.randn(2, 8, 3, 4, generator=g)
    for leaf in (q, k, v):
        leaf.requires_grad_(True)
        with pytest.raises(RuntimeError, match="mha_flash has no backward"):
            ops.mha_flash(q, k, v, 2)
        with torch.no_grad():
            ops.mha_flash(q, k, v, 2)          # no backward needed
        leaf.requires_grad_(False)
    ops.mha_flash(q, k, v, 2)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="ssd_intra has no backward"):
        ops.ssd_intra(cb, la, x)
    with torch.inference_mode():
        ops.ssd_intra(cb, la, x.detach())


@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_train_step_with_the_kernels_on_raises(arch):
    """A config with the kernel switches on (``configs.for_device`` on a
    card) cannot train: the step raises instead of dropping gradients;
    the same config's forward runs."""
    cfg = tconfigs.smoke(tconfigs.get_config(arch))
    over = dict(flash_threshold=16, flash_block=16, flash_kernel=True,
                param_dtype=torch.float32)
    if cfg.ssm is not None:
        over["ssm"] = dataclasses.replace(cfg.ssm, use_kernel=True)
    cfg = dataclasses.replace(cfg, **over)
    params = tbuild(cfg).init(torch.Generator().manual_seed(13),
                              device="cpu")
    batch = tsynthetic.make_batch(torch.Generator().manual_seed(14), cfg, 2,
                                  32, device="cpu")
    tbuild(cfg).hidden_states(params, batch)
    step = tsteps.build_train_step(cfg, _mesh(), TShape("t", 32, 2, "train"))
    with pytest.raises(RuntimeError, match="has no backward"):
        step.fn(*_placed(cfg, params), batch)


# --------------------------------------------------------------------------
# Token stream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_token_stream_determinism_and_disjoint_shards(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")

    def stream(**kw):
        return tsynthetic.TokenStream(tcfg, 2, 8, device="cpu", **kw)

    s0, s0b = stream(seed=0, shard=0, n_shards=2), stream(seed=0, shard=0,
                                                          n_shards=2)
    s1 = stream(seed=0, shard=1, n_shards=2)
    a, b, c = s0.batch_at(5), s0b.batch_at(5), s1.batch_at(5)
    spec = tsynthetic.batch_spec(tcfg, 2, 8, "train")
    assert list(a) == list(spec) == list(
        jsynthetic.batch_spec(jcfg, 2, 8, "train"))
    for name, (shape, dt) in spec.items():
        assert tuple(a[name].shape) == shape and a[name].dtype == dt
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])
    assert not torch.equal(a["tokens"], s0.batch_at(6)["tokens"])
    # The draw depends on (seed, step·n_shards + shard) alone.
    assert torch.equal(stream(seed=0).batch_at(11)["tokens"],
                       s1.batch_at(5)["tokens"])
    assert not torch.equal(stream(seed=1).batch_at(11)["tokens"],
                           s1.batch_at(5)["tokens"])
    assert torch.equal(next(iter(s0))["tokens"], s0.batch_at(0)["tokens"])


# --------------------------------------------------------------------------
# The train state on disk
# --------------------------------------------------------------------------

def _train_state():
    """A bf16 seamless-smoke train state after one port step."""
    _, tcfg = _cfgs("seamless-m4t-medium", dtype="bfloat16")
    params = tbuild(tcfg).init(torch.Generator().manual_seed(15),
                               device="cpu")
    step = tsteps.build_train_step(tcfg, _mesh(), TShape("t", SEQ, 2,
                                                               "train"))
    batch = tsynthetic.make_batch(torch.Generator().manual_seed(16), tcfg,
                                  2, SEQ, device="cpu")
    params, opt, _ = step.fn(*_placed(tcfg, params), batch)
    return _loc({"params": params, "opt": opt})


def test_checkpoint_save_reads_in_the_reference_and_restores(tmp_path):
    state = _train_state()
    d = str(tmp_path / "ck")
    tcheckpoint.save(d, 3, state)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
        else:
            flat[path] = t

    walk(state, "")
    got = jcheckpoint.load(d, 3)
    assert sorted(got) == sorted(flat)
    for key, t in flat.items():
        a = np.asarray(got[key])
        assert a.shape == tuple(t.shape) and str(a.dtype) == \
            str(t.dtype).removeprefix("torch."), key
        np.testing.assert_array_equal(a.astype(np.float32)
                                      if t.is_floating_point() else a,
                                      _np(t) if t.is_floating_point()
                                      else t.numpy())
    assert "opt/step" in got and got["opt/step"].dtype == np.int32
    # The port's restore: the same tensors, dtypes kept.
    back = tcheckpoint.restore(d, 3, state, device="cpu")
    for a, b in zip(_leaves(back), _leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tcheckpoint.latest_step(d) == 3


def test_restore_reads_the_references_checkpoint_and_checks_shapes(tmp_path):
    tree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "nested": {"b": jnp.ones((4,), jnp.bfloat16) * 1.5,
                       "step": jnp.int32(7)}}
    d = str(tmp_path / "ck")
    jcheckpoint.save(d, 2, tree)
    like = {"a": torch.zeros(2, 3),
            "nested": {"b": torch.zeros(4, dtype=torch.bfloat16),
                       "step": torch.zeros((), dtype=torch.int32)}}
    got = tcheckpoint.restore(d, 2, like, device="cpu")
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3))
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["b"].float(), torch.full((4,), 1.5))
    assert int(got["nested"]["step"]) == 7
    with pytest.raises(tcheckpoint.CheckpointError, match="shape"):
        tcheckpoint.restore(d, 2, dict(like, a=torch.zeros(3, 2)),
                            device="cpu")
    with pytest.raises(tcheckpoint.CheckpointError, match="missing"):
        tcheckpoint.restore(d, 2, dict(like, extra=torch.zeros(1)),
                            device="cpu")
    host = host_view(np.asarray(jcheckpoint.load(d, 2)["nested/b"]))
    assert torch.equal(host, got["nested"]["b"])


# --------------------------------------------------------------------------
# The train driver
# --------------------------------------------------------------------------

def _port_train(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)


@pytest.mark.timeout(600)
def test_train_driver_smoke_with_checkpoint(tmp_path):
    """``tests/test_drivers.py::test_train_driver_smoke_with_checkpoint``
    on the port: the same flags plus ``--device cpu``."""
    ckpt = str(tmp_path / "ck")
    p = _port_train("--arch", "gemma2-2b", "--smoke", "--steps", "6",
                    "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
                    "--ckpt-every", "3", "--device", "cpu")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "done" in p.stdout
    steps = sorted(os.listdir(ckpt))
    assert "step_3" in steps and "step_6" in steps
    lines = [ln for ln in p.stdout.splitlines() if "loss=" in ln]
    assert len(lines) == 6
    for ln in lines:
        assert re.fullmatch(r"step +\d+ loss=\d+\.\d{4} gnorm=\d+\.\d{3} "
                            r"\(\d+\.\ds\)", ln), ln
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    assert losses[-1] < losses[0], losses
    # The checkpoint restores into the driver's state on this device.
    cfg = tconfigs.smoke(tconfigs.get_config("gemma2-2b"))
    params = tbuild(cfg).init(torch.Generator().manual_seed(0),
                              device="cpu")
    state = tcheckpoint.restore(ckpt, 6, {
        "params": params, "opt": toptim.adamw_init(params)}, device="cpu")
    assert int(state["opt"]["step"]) == 6
    assert not torch.equal(state["params"]["embed"]["tok"],
                           params["embed"]["tok"])


def test_train_driver_refuses_the_mesh_flags_and_unknown_rules():
    """The mesh flags build the production meshes, which a world of one
    process cannot hold: the mesh's own error names the ranks they need.
    An unknown rule table is a usage error."""
    p = _port_train("--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                    "--production-mesh", timeout=300)
    assert p.returncode != 0 and "needs a world of exactly 256 ranks" in \
        p.stderr, p.stderr
    p = _port_train("--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                    "--multi-pod", timeout=300)
    assert p.returncode != 0 and "needs a world of exactly 512 ranks" in \
        p.stderr, p.stderr
    p = _port_train("--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                    "--rules", "no-such-table", timeout=300)
    assert p.returncode == 2 and "tp_fsdp" in p.stderr, p.stderr


@pytest.mark.timeout(600)
@pytest.mark.parametrize("rules", ["tp", "tp_fsdp"])
def test_train_driver_four_ranks_matches_one(rules):
    """``train`` under ``torch.distributed.run`` in a 4-rank gloo world
    trains on a (2, 2) mesh: rank 0 prints the losses of the one-rank run
    (bf16 smoke parameters: held to the bf16 tolerance, 2e-2)."""
    args = ("--arch", "gemma2-2b", "--smoke", "--steps", "4", "--batch",
            "4", "--seq", "16", "--device", "cpu", "--rules", rules)
    one = _port_train(*args, timeout=300)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    four = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert one.returncode == 0 and four.returncode == 0, four.stderr
    assert four.stdout.count("done") == 1          # rank 0 alone prints

    def losses(out):
        return [float(x) for x in re.findall(r"loss=(\S+)", out)]

    got, want = losses(four.stdout), losses(one.stdout)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
