"""The port's attention and SSD kernels against the JAX package's.

On the CPU the port's entry points (``repro_torch.kernels.ops``) run the
plain versions (``repro_torch.kernels.ref``); they are held against the
Pallas kernels in interpret mode and against ``repro.kernels.ref`` on the
same numpy inputs, over the reference tests' own cases.  The CUDA kernels
are held against the plain versions on a card (``cuda``-marked tests).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.kernels import ssd as jssd
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _qkv(bh, s, t, kd, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((bh, s, kd)) * kd ** -0.5).astype(np.float32)
    k = rng.standard_normal((bh, t, kd)).astype(np.float32)
    v = rng.standard_normal((bh, t, kd)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    """The same values in each package, rounded to ``dtype`` in each."""
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# The cases of tests/test_flash_kernel.py: (s, t, kd, causal, window, softcap)
FLASH_CASES = [
    (128, 128, 32, True, None, None),
    (128, 128, 32, True, 48, None),       # window smaller than block
    (128, 128, 32, True, None, 30.0),     # softcap
    (96, 96, 64, True, 40, 50.0),         # ragged + window + cap
    (64, 64, 32, False, None, None),      # non-causal (encoder)
    (256, 256, 128, True, 128, None),     # multi-block window
]


@pytest.mark.parametrize("s,t,kd,causal,window,softcap", FLASH_CASES)
def test_plain_flash_matches_pallas_kernel_and_ref(s, t, kd, causal, window,
                                                   softcap):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, s, t, kd), "float32")
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                               softcap=softcap)
    assert got.shape == (3, s, kd) and got.dtype == torch.float32
    jk_ = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                              softcap=softcap, block_q=32, block_k=32,
                              interpret=True)
    want = jref.flash_attention(jq, jk, jv, causal=causal, window=window,
                                softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(jk_), **F32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_plain_flash_bf16_matches_pallas_kernel():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 128, 128, 64), "bfloat16")
    got = tops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jk_ = jfa.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                              interpret=True)
    np.testing.assert_allclose(_np(got), _np(jk_), **BF16)
    np.testing.assert_allclose(_np(got), _np(jref.flash_attention(jq, jk,
                                                                  jv)),
                               **BF16)


def test_plain_flash_ragged_causal_padding():
    """S not a multiple of the reference's block: its causal masking
    neutralises the padding, and the port needs none."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 100, 100, 32, seed=5),
                                       "float32")
    got = tops.flash_attention(tq, tk, tv)
    jk_ = jfa.flash_attention(jq, jk, jv, block_q=32, block_k=32,
                              interpret=True)
    np.testing.assert_allclose(_np(got), _np(jk_), **F32)


@pytest.mark.parametrize("h,n_kv", [(8, 2), (4, 4), (6, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_mha_flash_gqa_matches_pallas_wrapper(h, n_kv, causal):
    b, s, kd = 2, 64, 32
    rng = np.random.default_rng(h + n_kv)
    q = (rng.standard_normal((b, s, h, kd)) * kd ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, s, n_kv, kd)).astype(np.float32)
    v = rng.standard_normal((b, s, n_kv, kd)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float32")
    got = tops.mha_flash(tq, tk, tv, n_kv, causal=causal)
    assert got.shape == (b, s, h, kd)
    want = jfa.mha_flash(jq, jk, jv, n_kv, causal=causal, interpret=True,
                         block_q=32, block_k=32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def _ssd_inputs(n, q, h, p, seed=0):
    rng = np.random.default_rng(seed)
    cb = (rng.standard_normal((n, q, q)) / np.sqrt(q)).astype(np.float32)
    # realistic decays: la is a non-increasing cumsum of negative increments
    la = np.cumsum(-np.abs(rng.standard_normal((n, q, h))) * 0.05,
                   axis=1).astype(np.float32)
    x = rng.standard_normal((n, q, h, p)).astype(np.float32)
    return cb, la, x


# The shapes of tests/test_ssd_kernel.py, plus the smoke configs' chunk.
@pytest.mark.parametrize("n,q,h,p", [(2, 16, 8, 16), (3, 32, 16, 32),
                                     (1, 64, 8, 64), (8, 8, 16, 32)])
def test_plain_ssd_intra_matches_pallas_kernel_and_ref(n, q, h, p):
    (jcb, jla, jx), (tcb, tla, tx) = _both(_ssd_inputs(n, q, h, p, seed=n),
                                           "float32")
    got = tops.ssd_intra(tcb, tla, tx)
    assert got.shape == (n, q, h, p) and got.dtype == torch.float32
    jk = jssd.ssd_intra(jcb, jla, jx, head_block=8, interpret=True)
    np.testing.assert_allclose(_np(got), _np(jk), **F32)
    np.testing.assert_allclose(_np(got), _np(jref.ssd_intra(jcb, jla, jx)),
                               **F32)


def test_plain_ssd_intra_is_the_model_chain():
    """The plain kernel equals the port's own einsum chain for G = 1."""
    from repro_torch.models.ssm import _y_intra_plain

    B_, nc, Q, H, P, N = 2, 3, 8, 16, 32, 16
    rng = np.random.default_rng(3)
    Cc = torch.from_numpy(rng.standard_normal((B_, nc, Q, 1, N))
                          .astype(np.float32)) / N ** 0.5
    Bc = torch.from_numpy(rng.standard_normal((B_, nc, Q, 1, N))
                          .astype(np.float32)) / N ** 0.5
    xc = torch.from_numpy(rng.standard_normal((B_, nc, Q, H, P))
                          .astype(np.float32))
    La = torch.cumsum(-torch.from_numpy(np.abs(rng.standard_normal(
        (B_, nc, Q, H))).astype(np.float32)) * 0.1, dim=2)
    want = _y_intra_plain(Cc, Bc, La, xc)
    cb = torch.einsum("bcqgn,bckgn->bcqk", Cc, Bc).reshape(B_ * nc, Q, Q)
    got = tops.ssd_intra(cb, La.reshape(B_ * nc, Q, H),
                         xc.reshape(B_ * nc, Q, H, P))
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want.numpy(),
                               **F32)


def test_ops_route_cpu_tensors_to_plain_versions_without_launching():
    tattn.reset_launches()
    tssd.reset_launches()
    q = torch.randn(2, 16, 8)
    tops.flash_attention(q, q, q)
    tops.mha_flash(q[:, :, None], q[:, :, None], q[:, :, None], 1)
    cb, la, x = (torch.from_numpy(a) for a in _ssd_inputs(1, 8, 2, 4))
    tops.ssd_intra(cb, la, x)
    assert tattn.LAUNCHES == {"flash_attention": 0}
    assert tssd.LAUNCHES == {"ssd_intra": 0}


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_operands():
    q = torch.zeros(2, 16, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.mha_flash(q, q, q, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q[:, :, 0], q[:, :, 0], q[:, :, 0])
    with pytest.raises(ValueError, match="3-D"):
        tattn.flash_attention(q, q, q)
    cb, la, x = (torch.from_numpy(a) for a in _ssd_inputs(1, 8, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_intra(cb, la, x)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _check_operand_errors_on_card():
    q = torch.zeros(2, 16, 4, 80, device="cuda")
    for bad in (dict(n_kv=3), dict(window=0), dict(softcap=-1.0)):
        kw = dict(n_kv=4)
        kw.update(bad)
        with pytest.raises(ValueError):
            tattn.mha_flash(q, q, q, kw.pop("n_kv"), **kw)
    big = torch.zeros(1, 8, 1, 257, device="cuda")
    with pytest.raises(ValueError, match="head dimension"):
        tattn.mha_flash(big, big, big, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kd", [16, 64, 80, 128])
def test_cuda_flash_matches_plain_version(dtype, kd):
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(kd)
    tattn.reset_launches()
    for s, t, causal, window, softcap in [(200, 200, True, None, None),
                                          (96, 96, True, 40, 50.0),
                                          (128, 128, False, None, None),
                                          (64, 100, False, 30, None)]:
        q = (torch.randn(3, s, kd, device="cuda", generator=g)
             * kd ** -0.5).to(dt)
        k = torch.randn(3, t, kd, device="cuda", generator=g).to(dt)
        v = torch.randn(3, t, kd, device="cuda", generator=g).to(dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = tattn.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(got.float(),
                                   tref.flash_attention(q, k, v, **kw).float(),
                                   **(F32 if dtype == "float32" else BF16))
    assert tattn.LAUNCHES == {"flash_attention": 4}
    _check_operand_errors_on_card()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_intra_matches_plain_version(dtype):
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    tssd.reset_launches()
    for n, q, h, p in [(3, 100, 5, 70), (2, 256, 8, 64), (4, 8, 16, 32)]:
        cb, la, x = (torch.from_numpy(a).cuda().to(dt)
                     for a in _ssd_inputs(n, q, h, p, seed=q))
        torch.testing.assert_close(tssd.ssd_intra(cb, la, x),
                                   tref.ssd_intra(cb, la, x),
                                   **(F32 if dtype == "float32" else BF16))
    assert tssd.LAUNCHES == {"ssd_intra": 3}
