"""The port's per-target Pearson r against the JAX package's.

Both packages get the same numpy inputs.  On the CPU ``ops.pearson_r``
runs the plain version (``kernels.ref``): the kernel's own raw-sums
formula, held against the Pallas kernel in interpret mode (the same five
f32 sums of the same values, so only the summation order differs: rtol and
atol 1e-5) and against the reference's centred oracle at the reference
test's tolerance (tests/test_kernels.py:171-173: f32 1e-3, bf16 5e-2).
The CUDA kernel is held against the plain version on a card (``-m cuda``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pearsonr as jpearson
from repro.kernels import ref as jref
from repro_torch.core import scoring as tscoring
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pearsonr as tpearson
from repro_torch.kernels import ref as tref

# tests/test_kernels.py::SHAPES_PEARSON: (n, t).
SHAPES_PEARSON = [(50, 17), (1000, 128), (333, 257)]
DTYPES = ["float32", "bfloat16"]
SAME_SUMS = dict(rtol=1e-5, atol=1e-5)


def _oracle_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-3, atol=1e-3)


def _pair(n, t, seed, dtype="float32"):
    """(y_true, y_pred = ½·y_true + ½·noise) for both packages."""
    rng = np.random.default_rng(seed)
    yt = rng.standard_normal((n, t)).astype(np.float32)
    yp = (0.5 * yt + 0.5 * rng.standard_normal((n, t))).astype(np.float32)
    tdt = getattr(torch, dtype)
    return (jnp.asarray(yt, dtype), jnp.asarray(yp, dtype),
            torch.from_numpy(yt).to(tdt), torch.from_numpy(yp).to(tdt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,t", SHAPES_PEARSON)
def test_plain_pearson_matches_jax_kernel_and_oracle(n, t, dtype):
    jt, jp, tt, tp = _pair(n, t, n * t, dtype)
    got = tops.pearson_r(tt, tp)
    assert got.dtype == torch.float32 and got.shape == (t,)
    jk = jpearson.pearson_r(jt, jp, block_n=128, block_t=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), **SAME_SUMS)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.pearson_r(jt, jp)),
                               **_oracle_tol(dtype))
    assert bool((got.abs() <= 1.0 + 1e-4).all())


def test_pearson_perfect_anti_and_constant_columns():
    _, _, y, _ = _pair(200, 64, 0)
    np.testing.assert_allclose(tops.pearson_r(y, 2.0 * y + 1.0).numpy(), 1.0,
                               atol=1e-4)
    np.testing.assert_allclose(tops.pearson_r(y, -y).numpy(), -1.0,
                               atol=1e-4)
    # A constant column has zero variance: r = 0 (denominator floored at
    # 1e-12), as the Pallas kernel gives.  The constant is a power of two,
    # so Σcy = c·Σy holds exactly in f32 and the numerator is exactly 0;
    # for other constants the raw-sums formula (the Pallas kernel's too)
    # returns f32 rounding noise over 1e-12.
    yc = y.clone()
    yc[:, 3] = 2.0
    got = tops.pearson_r(y, yc)
    jk = jpearson.pearson_r(jnp.asarray(y.numpy()), jnp.asarray(yc.numpy()),
                            interpret=True)
    assert float(got[3]) == 0.0 == float(jk[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), **SAME_SUMS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pearson_sums_match_jax(dtype):
    jt, jp, tt, tp = _pair(333, 40, 5, dtype)
    got = tops.pearson_sums(tt, tp)
    assert got.dtype == torch.float32 and got.shape == (5, 40)
    want = np.asarray(jpearson.pearson_sums(jt, jp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_pearson_r_from_sums_is_dtype_generic_like_jax():
    _, _, tt, tp = _pair(500, 30, 9)
    sums64 = tpearson.pearson_sums(tt, tp).numpy().astype(np.float64)
    # numpy float64 in → numpy float64 out, equal to the reference's.
    got = tops.pearson_r_from_sums(sums64, 500)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    want = jpearson.pearson_r_from_sums(sums64, 500)
    assert isinstance(want, np.ndarray) and want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # torch in → torch out (f32), equal to the reference's jnp path.
    sums32 = tpearson.pearson_sums(tt, tp)
    got = tops.pearson_r_from_sums(sums32, 500)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = jpearson.pearson_r_from_sums(jnp.asarray(sums32.numpy()), 500)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME_SUMS)
    # And the finalised sums are the plain version's r.
    np.testing.assert_array_equal(got.numpy(),
                                  tref.pearson_r(tt, tp).numpy())


def test_raw_sums_r_agrees_with_the_ports_centred_scoring():
    """On standardized data the raw-sums formula agrees with the centred
    one that ``core.scoring`` (and the estimator) uses."""
    _, _, tt, tp = _pair(1000, 64, 3)
    tt = (tt - tt.mean(0)) / tt.std(0)
    np.testing.assert_allclose(tops.pearson_r(tt, tp).numpy(),
                               tscoring.pearson_r(tt, tp).numpy(),
                               **_oracle_tol("float32"))


def test_pearson_wrapper_refuses_cpu_tensors_and_ops_route_cpu_to_plain():
    _, _, tt, tp = _pair(20, 6, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tpearson.pearson_r(tt, tp)
    tpearson.reset_launches()
    tops.pearson_r(tt, tp)
    assert tpearson.LAUNCHES == {"pearson_r": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_pearson_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tpearson.reset_launches()
    launched = 0
    for n, t in SHAPES_PEARSON + [(1, 5), (7689, 444), (3, 300)]:
        _, _, tt, tp = _pair(n, t, n + t, dtype)
        tt, tp = tt.cuda(), tp.cuda()
        tp[:, 0] = 2.0                      # constant column → 0
        if t > 2:
            tp[:, 1] = -tt[:, 1]            # perfect anti-correlation
        got = tpearson.pearson_r(tt, tp)
        again = tpearson.pearson_r(tt, tp)
        launched += 2
        torch.testing.assert_close(got, again, rtol=0, atol=0)
        want = tref.pearson_r(tt, tp)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert float(got[0]) == 0.0
        if t > 2 and n > 1:
            assert abs(float(got[1]) + 1.0) <= 1e-4
    assert tpearson.LAUNCHES["pearson_r"] == launched
