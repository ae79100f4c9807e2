"""The port's RunStore, prefetcher and resilience copies against JAX's.

Stores written by either package open in the other: same manifest, same
``.npy`` shard bytes, bf16 kept as its uint16 bit patterns.  Chunks are
read-only numpy arrays in both; the prefetcher yields the synchronous
iterator's chunks bit for bit.
"""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.store import RunStore as JStore
from repro.resilience import cleanup as jcleanup
from repro.resilience import policy as jpolicy
from repro_torch.data import fmri as tfmri
from repro_torch.data.store import ChunkPrefetcher, RunStore, StoreError
from repro_torch.device import as_tensor, host_view
from repro_torch.resilience import cleanup as tcleanup
from repro_torch.resilience import policy as tpolicy

DTYPES = ["float32", "bfloat16"]


def _problem(seed, n, p, t, dtype="float32"):
    """f32 numpy data; for bf16, ml_dtypes bf16 arrays as JAX writes them."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    Y = (X @ rng.normal(size=(p, t)).astype(np.float32)
         + rng.normal(size=(n, t))).astype(np.float32)
    if dtype == "bfloat16":
        X, Y = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (X, Y))
    return X, Y


def _f32(a):
    """A chunk (f32, uint16 bf16 bits or ml_dtypes bf16) as f32 numpy."""
    return host_view(np.ascontiguousarray(a)).float().numpy()


def _run(r):
    return (r.run_id, r.row_offset, r.n_rows)


def _port_write(root, X, Y, dtype, n_runs=3, n_folds=5, as_tensors=False):
    store = RunStore.create(str(root), n_folds=n_folds, dtype=dtype)
    n = X.shape[0]
    for i in range(n_runs):
        lo, hi = i * n // n_runs, (i + 1) * n // n_runs
        x, y = X[lo:hi], Y[lo:hi]
        if as_tensors:
            x, y = host_view(np.ascontiguousarray(x)), host_view(
                np.ascontiguousarray(y))
        store.write(x, y, f"run-{i:03d}")
    return RunStore.open(str(root))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_written_store_reads_in_the_port(make_run_store, dtype):
    X, Y = _problem(5, 57, 6, 4, dtype)
    jstore = make_run_store(X, Y, n_runs=3)
    store = RunStore.open(jstore.root)
    assert store.shape == jstore.shape == (57, 6, 4)
    assert store.n_folds == jstore.n_folds
    assert store.dtype_x == store.dtype_y == getattr(torch, dtype)
    assert store.nbytes_resident() == jstore.nbytes_resident()
    assert [_run(r) for r in store.runs] == [_run(r) for r in jstore.runs]
    Xl, Yl = store.load()
    np.testing.assert_array_equal(_f32(Xl), _f32(X))
    np.testing.assert_array_equal(_f32(Yl), _f32(Y))
    for chunk in (1, 10, 57, 100):                # incl. run-straddling
        ours = list(store.iter_chunks(chunk))
        theirs = list(jstore.iter_chunks(chunk))
        assert [c.shape for c, _ in ours] == [c.shape for c, _ in theirs]
        np.testing.assert_array_equal(
            _f32(np.concatenate([c for c, _ in ours])), _f32(X))
        np.testing.assert_array_equal(
            _f32(np.concatenate([c for _, c in ours])), _f32(Y))
    xs = [c for c, _ in store.iter_chunks(8, row_range=(13, 41))]
    np.testing.assert_array_equal(_f32(np.concatenate(xs)), _f32(X[13:41]))
    ys = [c for _, c in store.iter_chunks(8, col_range=(1, 3))]
    np.testing.assert_array_equal(_f32(np.concatenate(ys)), _f32(Y[:, 1:3]))


@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["numpy", "tensors"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_written_store_is_byte_identical_and_reads_in_jax(
        tmp_path, make_run_store, dtype, as_tensors):
    X, Y = _problem(6, 50, 5, 3, dtype)
    if as_tensors or dtype == "float32":
        src = (X, Y)
    else:                                         # f32 in, rounded by store
        src = (_f32(X), _f32(Y))
    store = _port_write(tmp_path / "port", *src, dtype, as_tensors=as_tensors)
    jstore = make_run_store(X, Y, n_runs=3)
    names = sorted(os.listdir(jstore.root))
    assert sorted(os.listdir(store.root)) == names
    for name in names:                            # manifest and shards alike
        with open(os.path.join(store.root, name), "rb") as a, \
                open(os.path.join(jstore.root, name), "rb") as b:
            assert a.read() == b.read(), name
    back = JStore.open(store.root)
    Xj, Yj = back.load()
    assert Xj.dtype.name == dtype
    np.testing.assert_array_equal(np.asarray(Xj, np.float32), _f32(X))
    np.testing.assert_array_equal(np.asarray(Yj, np.float32), _f32(Y))


def test_store_read_only_semantics(make_run_store):
    X, Y = _problem(7, 30, 4, 3)
    store = RunStore.open(make_run_store(X, Y).root)
    X_c, _ = next(store.iter_chunks(10))
    with pytest.raises(ValueError):               # read-only memmap view
        X_c[0, 0] = 1.0
    with pytest.raises(StoreError, match="read-only"):
        store.write(X, Y, "new-run")
    # A CPU tensor of a read-only chunk is a copy, a host view shares it.
    t = as_tensor(X_c, torch.device("cpu"))
    t[0, 0] = 123.0
    assert X_c[0, 0] != 123.0
    assert host_view(X_c).data_ptr() == X_c.ctypes.data


def test_host_view_reads_bf16_bit_patterns_without_a_copy():
    x = np.asarray(jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32)
                               .reshape(3, 4), jnp.bfloat16))
    bits = x.view(np.uint16)
    for a in (x, bits):
        t = host_view(a)
        assert t.dtype == torch.bfloat16
        assert t.data_ptr() == a.ctypes.data
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(x, np.float32))
    t = as_tensor(bits, torch.device("cpu"))
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4)


def test_iter_chunks_aligned_dtype_returns_memmap_view(make_run_store):
    X, Y = _problem(28, 40, 4, 3)
    store = RunStore.open(make_run_store(X, Y, n_runs=2).root)

    def is_memmap_view(a):
        while a is not None:
            if isinstance(a, np.memmap):
                return True
            a = getattr(a, "base", None)
        return False

    for kwargs in ({}, {"dtype": torch.float32}, {"dtype": "float32"}):
        X_c, Y_c = next(store.iter_chunks(10, **kwargs))
        assert is_memmap_view(X_c) and not X_c.flags.owndata, kwargs
        assert is_memmap_view(Y_c) and not Y_c.flags.owndata, kwargs
    # A real cast converts into fresh memory.
    X_c, _ = next(store.iter_chunks(10, dtype=torch.float64))
    assert X_c.dtype == np.float64 and not is_memmap_view(X_c)
    np.testing.assert_array_equal(X_c, X[:10].astype(np.float64))


def test_iter_chunks_casts_like_jax(make_run_store):
    """bf16 store read as f32 (and f32 store read as bf16) matches the
    reference's cast chunk for chunk."""
    Xb, Yb = _problem(8, 33, 4, 3, "bfloat16")
    jb = make_run_store(Xb, Yb, n_runs=2)
    X, Y = _problem(9, 33, 4, 3)
    jf = make_run_store(X, Y, n_runs=2)
    for jstore, dt in ((jb, "float32"), (jf, "bfloat16")):
        store = RunStore.open(jstore.root)
        for (x, y), (jx, jy) in zip(store.iter_chunks(7, dtype=dt),
                                    jstore.iter_chunks(7, dtype=dt)):
            np.testing.assert_array_equal(_f32(x), _f32(jx))
            np.testing.assert_array_equal(_f32(y), _f32(jy))
        Xl, _ = store.load(dtype=dt)
        Xj, _ = jstore.load(dtype=dt)
        np.testing.assert_array_equal(_f32(Xl), _f32(Xj))


def test_store_write_validation(tmp_path):
    X, Y = _problem(10, 20, 4, 3)
    store = RunStore.create(str(tmp_path / "s"))
    store.write(X, Y, "r1")
    with pytest.raises(StoreError, match="already written"):
        store.write(X, Y, "r1")
    with pytest.raises(StoreError, match="columns"):
        store.write(X[:, :2], Y, "r2")
    with pytest.raises(StoreError, match="matching 2-D"):
        store.write(X[:10], Y, "r3")
    with pytest.raises(StoreError, match="already exists"):
        RunStore.create(str(tmp_path / "s"))
    with pytest.raises(StoreError, match="no manifest"):
        RunStore.open(str(tmp_path / "nowhere"))
    with pytest.raises(StoreError, match="unsupported dtype"):
        RunStore.create(str(tmp_path / "u"), dtype="complex_thing")


def _tamper_overlap(m, root):
    m["runs"][1].update(row_offset=5)


def _tamper_rows(m, root):
    m["runs"][0].update(n_rows=7, row_offset=0)
    m["runs"][1].update(row_offset=7)


def _tamper_dtype(m, root):
    m.update(dtype_x="float64")


def _tamper_missing(m, root):
    os.remove(os.path.join(root, "run-000.X.npy"))


def _tamper_version(m, root):
    m.update(version=99)


@pytest.mark.parametrize("mutate,match", [
    (_tamper_overlap, "overlaps or gaps"), (_tamper_rows, "shape"),
    (_tamper_dtype, "dtype"), (_tamper_missing, "missing X shard"),
    (_tamper_version, "version")],
    ids=["overlap", "rows", "dtype", "missing", "version"])
def test_store_manifest_validation_matches_jax(make_run_store, mutate,
                                               match):
    X, Y = _problem(11, 30, 4, 3)
    root = make_run_store(X, Y, n_runs=2).root
    path = os.path.join(root, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    mutate(m, root)
    with open(path, "w") as f:
        json.dump(m, f)
    with pytest.raises(StoreError, match=match):
        RunStore.open(root)
    with pytest.raises(ValueError, match=match):  # the reference agrees
        JStore.open(root)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefetch_stream_bit_identical(make_run_store, dtype):
    X, Y = _problem(22, 87, 6, 4, dtype)
    store = RunStore.open(make_run_store(X, Y, n_runs=3).root)
    for chunk, rr in ((13, None), (29, (11, 70)), (87, None)):
        sync = list(store.iter_chunks(chunk, row_range=rr))
        pf = store.iter_chunks(chunk, row_range=rr, prefetch=True)
        assert isinstance(pf, ChunkPrefetcher)
        got = [(x.copy(), y.copy()) for x, y in pf]
        assert len(got) == len(sync)
        for (xs, ys), (xp, yp) in zip(sync, got):
            assert xs.dtype == xp.dtype
            np.testing.assert_array_equal(xs, xp)
            np.testing.assert_array_equal(ys, yp)
        assert pf.stats.chunks == len(sync)
        assert pf.stats.bytes_staged == sum(x.nbytes + y.nbytes
                                            for x, y in sync)
        d = pf.stats.to_dict()
        assert d["schema"] == "repro.obs/v1" and d["kind"] == "prefetch"


def test_prefetch_reader_exception_propagates(make_run_store, monkeypatch):
    X, Y = _problem(25, 60, 6, 4)
    store = RunStore.open(make_run_store(X, Y, n_runs=3).root)
    real_mmap = store._mmap

    def broken(r):
        if r.row_offset > 0:
            raise OSError("disk pulled mid-stream")
        return real_mmap(r)

    monkeypatch.setattr(store, "_mmap", broken)
    pf = store.iter_chunks(10, prefetch=True)
    with pytest.raises(OSError, match="disk pulled"):
        for _ in pf:
            pass
    assert pf._thread is None                     # joined by close()


def test_prefetch_close_on_early_abort(make_run_store):
    X, Y = _problem(26, 80, 6, 4)
    store = RunStore.open(make_run_store(X, Y, n_runs=2).root)
    pf = store.iter_chunks(7, prefetch=True)
    next(pf)                                      # reader is now running
    thread = pf._thread
    assert thread is not None and thread.is_alive()
    pf.close()
    assert not thread.is_alive() and pf._thread is None
    assert pf._bufs is None and pf._host is None
    pf.close()                                    # idempotent
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_yields_read_only_views(make_run_store):
    X, Y = _problem(27, 30, 4, 3)
    store = RunStore.open(make_run_store(X, Y).root)
    pf = store.iter_chunks(10, prefetch=True)
    X_c, Y_c = next(pf)
    with pytest.raises(ValueError):
        X_c[0, 0] = 1.0
    with pytest.raises(ValueError):
        Y_c[0, 0] = 1.0
    pf.close()
    with pytest.raises(ValueError, match="depth"):
        store.iter_chunks(10, prefetch=True, prefetch_depth=0)
    with pytest.raises(ValueError, match="chunk_rows"):
        store.iter_chunks(0)
    with pytest.raises(ValueError, match="row_range"):
        store.iter_chunks(5, row_range=(10, 99))


def test_prefetch_retries_transient_faults_bit_identically(make_run_store,
                                                           monkeypatch):
    """A store opened with a FaultPolicy retries a transient shard read
    (virtual time, no sleeping) and restarts at the unconsumed chunk."""
    X, Y = _problem(29, 90, 5, 3)
    root = make_run_store(X, Y, n_runs=3).root
    policy = tpolicy.FaultPolicy(max_attempts=3).with_virtual_time()
    store = RunStore.open(root, fault_policy=policy)
    real = store._mmap_raw
    fails = {"left": 2}
    lock = threading.Lock()

    def flaky(r):
        with lock:
            if r.row_offset > 0 and fails["left"]:
                fails["left"] -= 1
                raise tpolicy.TransientFault("transient read error")
        return real(r)

    monkeypatch.setattr(store, "_mmap_raw", flaky)
    got = [x.copy() for x, _ in store.iter_chunks(11, prefetch=True)]
    np.testing.assert_array_equal(np.concatenate(got), X)
    assert fails["left"] == 0
    # Exhausted attempts re-raise the original exception type.
    fails["left"] = 10
    with pytest.raises(tpolicy.TransientFault):
        list(store.iter_chunks(11, prefetch=True))


def test_materialize_synthetic_on_cpu_reads_in_jax(tmp_path):
    spec = tfmri.SubjectSpec(n=100, p=8, t=6)
    store = RunStore.create(str(tmp_path / "syn"))
    store.materialize_synthetic(spec, rows_per_run=32, device="cpu")
    store = RunStore.open(str(tmp_path / "syn"))
    assert store.shape == (100, 8, 6)
    assert [r.n_rows for r in store.runs] == [32, 32, 32, 4]
    again = RunStore.create(str(tmp_path / "syn2"))
    again.materialize_synthetic(spec, rows_per_run=32, device="cpu")
    np.testing.assert_array_equal(store.load()[1], again.load()[1])
    Xj, Yj = JStore.open(str(tmp_path / "syn")).load()
    np.testing.assert_array_equal(Xj, store.load()[0])
    # Each run is normalised on its own rows, as in the reference.
    Y0 = Yj[:32]
    np.testing.assert_allclose(Y0.mean(0), 0.0, atol=1e-5)


@pytest.mark.parametrize("attempt", [1, 2, 5])
def test_fault_policy_delays_and_classes_match_reference(attempt):
    kw = dict(max_attempts=4, base_delay_s=0.1, jitter=0.3, seed=7)
    assert (tpolicy.FaultPolicy(**kw).delay_for("store.mmap", attempt)
            == jpolicy.FaultPolicy(**kw).delay_for("store.mmap", attempt))
    import errno
    for exc in (tpolicy.TransientFault("x"), TimeoutError(),
                OSError(errno.EIO, "io"), OSError(errno.ENOENT, "gone"),
                ValueError("v")):
        assert (tpolicy.classify_default(exc)
                == jpolicy.classify_default(exc)), exc


def test_retry_call_retries_transient_and_raises_permanent():
    policy = tpolicy.FaultPolicy(max_attempts=3).with_virtual_time()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise tpolicy.TransientFault("again")
        return "ok"

    assert tpolicy.retry_call(flaky, policy, "op") == "ok"
    assert len(calls) == 3
    with pytest.raises(ValueError):
        tpolicy.retry_call(lambda: (_ for _ in ()).throw(ValueError("p")),
                           policy, "op")
    calls.clear()
    with pytest.raises(tpolicy.TransientFault):
        tpolicy.retry_call(lambda: calls.append(1) or (_ for _ in ()).throw(
            tpolicy.TransientFault("t")), policy, "op")
    assert len(calls) == 3


def test_reap_stale_staging_matches_reference(tmp_path):
    for name in ("a.X.npy.tmp-12", "manifest.json.tmp", "keep.npy",
                 ".tmpbundle_x"):
        (tmp_path / name).write_text("x")
    now = os.path.getmtime(tmp_path / "keep.npy") + 7200
    assert tcleanup.reap_stale_staging(str(tmp_path), now=now - 7000) == []
    assert tcleanup.STAGING_PATTERNS == jcleanup.STAGING_PATTERNS
    reaped = tcleanup.reap_stale_staging(str(tmp_path), now=now)
    assert reaped == [".tmpbundle_x", "a.X.npy.tmp-12", "manifest.json.tmp"]
    assert sorted(os.listdir(tmp_path)) == ["keep.npy"]
    assert tcleanup.reap_stale_staging(str(tmp_path / "none")) == []
