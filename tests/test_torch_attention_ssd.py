"""The port's attention and SSD kernels against the JAX package's.

On the CPU the port's entry points (``repro_torch.kernels.ops``) run the
plain versions (``repro_torch.kernels.ref``); they are held against the
Pallas kernels in interpret mode and against ``repro.kernels.ref`` on the
same numpy inputs, over the reference tests' own cases.  The CUDA kernels
are held against the plain versions on a card (``cuda``-marked tests).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


# Finite f32 values in [0, 1], and ones with exponents down to 2⁻¹¹⁰: the
# range of the flash kernel's probabilities exp(s − m).
_PROBS = st.lists(st.one_of(st.just(0.0), st.just(1.0),
                            st.floats(2.0 ** -110, 1.0, width=32),
                            st.floats(0.0, 1.0, width=32)),
                  min_size=1, max_size=64)


@settings(max_examples=200, deadline=None)
@given(_PROBS, st.integers(0, 2**32 - 1))
def test_bf16_split3_is_exact(ps, seed):
    """p₁ + p₂ + p₃ == p bitwise for p = 0 and p ≥ 2⁻¹¹⁰, and then
    (p₁ + p₂ + p₃)·v == p·v for bf16 v: each pᵢ·v is exact in f32, so
    three bf16 products give the f32 one.  Below 2⁻¹¹⁰ only p₃ can lose
    bits, less than bf16's smallest subnormal, 2⁻¹³³."""
    p = torch.tensor(ps, dtype=torch.float32)
    p1, p2, p3 = tref.bf16_split3(p)
    assert p1.dtype == p2.dtype == p3.dtype == torch.bfloat16
    total = (p1.float() + p2.float()) + p3.float()
    exact = (p == 0) | (p >= 2.0 ** -110)
    assert torch.equal(total[exact], p[exact])
    assert bool(((total.double() - p.double()).abs() < 2.0 ** -133).all())
    v = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        len(ps)).astype(np.float32)).to(torch.bfloat16).float()
    for term in (p1, p2, p3):
        assert torch.equal((term.float() * v).double(),
                           term.double() * v.double())
    prod = sum((t.float() * v).double() for t in (p1, p2, p3))
    assert torch.equal(prod[exact], (p.double() * v.double())[exact])


def _split_pv_attention(q, k, v, *, causal, window, softcap):
    """The bf16 kernel's arithmetic, plainly: f32 scores from bf16 q·k,
    softcap, NEG mask, p = exp(s − max), P·V as Σᵢ bf16_split3(p)ᵢ·v in
    f32, then / max(l, 1e-30).  f32 out."""
    q, k, v = q.float(), k.float(), v.float()
    S, T = q.shape[1], k.shape[1]
    dist = torch.arange(S)[:, None] - torch.arange(T)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= dist >= 0
    if window is not None:
        mask &= dist < window
    s = torch.einsum("hsk,htk->hst", q, k)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[None], s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = sum(torch.einsum("hst,htk->hsk", t.float(), v)
              for t in tref.bf16_split3(p))
    return out / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)


@pytest.mark.parametrize("s,t,kd,causal,window,softcap", FLASH_CASES)
def test_split_pv_emulation_matches_reference(s, t, kd, causal, window,
                                              softcap):
    """On bf16 inputs the split P·V gives the reference's f32 attention
    within the f32 tolerance, before any card runs it."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, s, t, kd, seed=kd),
                                       "bfloat16")
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _split_pv_attention(tq, tk, tv, **kw)
    want = jref.flash_attention(*(a.astype(jnp.float32)
                                  for a in (jq, jk, jv)), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(
        _np(got), _np(tref.flash_attention(tq.float(), tk.float(),
                                           tv.float(), **kw)), **F32)


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


def _tol(dtype):
    # As tests/test_kernels.py::_tol: blocked f32 reduction order differs;
    # bf16 operands are rounded first.
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,q,h,p", [(2, 16, 8, 16), (3, 32, 16, 32),
                                     (1, 64, 8, 64), (8, 8, 16, 32)])
def test_ssd_split_model_matches_pallas_kernel_and_ref(n, q, h, p, dtype):
    """The tensor-core kernel's arithmetic (L and x cut into exact bf16
    terms, the kept term products summed in f32) against the Pallas
    kernel in interpret mode and the reference's oracle."""
    (jcb, jla, jx), (tcb, tla, tx) = _both(
        _ssd_inputs(n, q, h, p, seed=n + q), dtype)
    got = tref.ssd_intra_split(tcb, tla, tx)
    assert got.shape == (n, q, h, p) and got.dtype == torch.float32
    jk = jssd.ssd_intra(jcb, jla, jx, head_block=8, interpret=True)
    np.testing.assert_allclose(_np(got), _np(jk), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(jref.ssd_intra(jcb, jla, jx)),
                               **_tol(dtype))
    # The same bf16-rounded operands through the port's plain version: the
    # split's only departure is the three dropped term products.
    np.testing.assert_allclose(_np(got), _np(tref.ssd_intra(tcb, tla, tx)),
                               **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_split_model_follows_the_nonfinite_rule(dtype):
    """NaN where the plain version is NaN, non-finite where it is ±Inf: the
    masked 0·cb and 0·x of the reference propagate through the split."""
    cb, la, x = (torch.from_numpy(a) for a in _ssd_inputs(2, 32, 3, 8,
                                                           seed=4))
    x[0, 20, 1, 5] = float("inf")       # NaN for q < 20 (0·Inf) too
    x[1, 3, 2, 0] = float("nan")
    cb[0, 4, 30] = float("nan")         # above the diagonal: row 4 NaN
    cb[1, 9, 2] = float("inf")          # below it
    dt = getattr(torch, dtype)
    cb, la, x = cb.to(dt), la.to(dt), x.to(dt)
    want = tref.ssd_intra(cb, la, x)
    got = tref.ssd_intra_split(cb, la, x)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert torch.isnan(got[torch.isnan(want)]).all()
    assert not torch.isfinite(got[torch.isinf(want)]).any()
    fin = torch.isfinite(want)
    assert torch.isfinite(got[fin]).all()
    torch.testing.assert_close(got[fin], want[fin], **F32)


def test_ssd_chunk_limit_is_the_kernels_shared_memory():
    """The wrapper's Q limit (``ssd.MAX_CHUNK``) is the longest chunk whose
    block layout (csrc/ssd.cu: layout) fits a block's shared memory, for
    f32 x (three term planes, the larger layout)."""
    import re
    src = (Path(tssd.__file__).parent / "csrc" / "ssd.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    smem = int(re.search(r"constexpr int kSmemMax = (\d+) \* 1024;",
                         src).group(1)) * 1024

    def layout(q):
        w = -(-q // const["kRows"]) * const["kRows"]
        ring = 2 * 3 * const["kStage"] * const["kCols"] * 2
        return ring + 4 * const["kRows"] * w + 4 * const["kHeads"] * w \
            + 4 * const["kRows"]

    assert layout(tssd.MAX_CHUNK) <= smem < layout(tssd.MAX_CHUNK + 1)
    assert layout(256) <= smem // 2 - 1024     # two blocks an SM at Q = 256


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
@pytest.mark.parametrize("kd", [16, 40, 64, 80, 100, 128])
def test_cuda_flash_matches_plain_version(dtype, kd):
    """K not a multiple of 16 (40, 100; 100 is not even a multiple of 8,
    so the bf16 kernel copies element by element), S and T off the tiles,
    window and softcap, then GQA on strided views through mha_flash."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16
    g = torch.Generator("cuda").manual_seed(kd)
    tattn.reset_launches()
    for s, t, causal, window, softcap in [(200, 200, True, None, None),
                                          (96, 96, True, 40, 50.0),
                                          (128, 128, False, None, None),
                                          (64, 100, False, 30, None),
                                          (130, 130, True, None, 30.0),
                                          (257, 193, False, None, 20.0),
                                          (300, 300, True, 70, None)]:
        q = (torch.randn(3, s, kd, device="cuda", generator=g)
             * kd ** -0.5).to(dt)
        k = torch.randn(3, t, kd, device="cuda", generator=g).to(dt)
        v = torch.randn(3, t, kd, device="cuda", generator=g).to(dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = tattn.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(got.float(),
                                   tref.flash_attention(q, k, v, **kw).float(),
                                   **tol)
    for b, s, h, n_kv, window, softcap in [(2, 150, 8, 2, None, None),
                                           (1, 200, 6, 3, 50, 30.0)]:
        # q, k, v: strided views of one (B, S, 3, H, K) projection.
        qkv = torch.randn(b, s, 3, h, kd, device="cuda", generator=g)
        q, k, v = (qkv * torch.tensor([kd ** -0.5, 1.0, 1.0], device="cuda")
                   [:, None, None]).to(dt).unbind(2)
        k, v = k[:, :, :n_kv], v[:, :, :n_kv]
        kw = dict(window=window, softcap=softcap)
        got = tattn.mha_flash(q, k, v, n_kv, **kw)
        torch.testing.assert_close(
            got.float(), tref.mha_flash(q, k, v, n_kv, **kw).float(), **tol)
    assert tattn.LAUNCHES == {"flash_attention": 9}
    _check_operand_errors_on_card()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_intra_matches_split_model_and_nonfinite_rule(dtype):
    """The tensor-core kernel against the model of its own arithmetic
    (only the f32 summation order differs), repeated launches bitwise
    equal, and NaN or ±Inf inputs past a tile's diagonal."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    for n, q, h, p in [(2, 256, 9, 64), (1, 300, 3, 130), (3, 100, 5, 70)]:
        cb, la, x = (torch.from_numpy(a).cuda().to(dt)
                     for a in _ssd_inputs(n, q, h, p, seed=h))
        got = tssd.ssd_intra(cb, la, x)
        torch.testing.assert_close(got, tref.ssd_intra_split(cb, la, x),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(got, tssd.ssd_intra(cb, la, x))
    cb, la, x = (torch.from_numpy(a).cuda() for a in _ssd_inputs(2, 256, 9,
                                                                 64, seed=2))
    x[0, 200, 3, 5] = float("inf")
    x[1, 70, 8, 63] = float("nan")
    cb[0, 30, 150] = float("nan")
    cb[1, 100, 50] = float("inf")
    cb, la, x = cb.to(dt), la.to(dt), x.to(dt)
    got, want = tssd.ssd_intra(cb, la, x), tref.ssd_intra(cb, la, x)
    assert torch.isnan(got[torch.isnan(want)]).all()
    assert not torch.isfinite(got[torch.isinf(want)]).any()
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], **F32)


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
