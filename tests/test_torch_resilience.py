"""The port's crash-safe tier (``repro_torch.resilience``) against JAX's.

Mirrors ``tests/test_resilience.py`` case by case where the case exists in
the port — retry policy, fault injection, the ``FitJournal`` ledger and
crash-resume, the streaming tier under injected faults, registry retry,
the staging reaper and fleet liveness — all on the seeded deterministic
harness (``resilience.faultsim``), with no real sleeps.  Then it holds the
port against the reference on the same store directories:

* the same ``FaultInjector`` plan yields the same ``io_retries{op}``;
* a fit the port interrupts and resumes is bitwise equal to the port's
  uninterrupted fit, in both λ modes, and a child process killed by
  ``KillAfterBlock`` (exit 42) resumes the same way;
* a journal the reference's interrupted fit wrote attaches in the port and
  resumes: λ equal, W within the f32 tolerance of
  ``tests/test_kernels.py::_tol`` (the replayed statistics come from XLA's
  arithmetic, so not bitwise);
* the port's journal has the reference's files and ledger keys.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import obs as jobs
from repro.encoding import EncoderConfig as JConfig
from repro.resilience import FaultPolicy as JPolicy
from repro.resilience import FitJournal as JJournal
from repro.resilience.faultsim import FaultInjector as JInjector
from repro.resilience.faultsim import wrap_store as jwrap_store
from repro.wholebrain import fit_wholebrain as jfit_wholebrain
from repro.wholebrain.solver import journal_signature as jjournal_signature
from repro_torch import obs
from repro_torch.data.store import RunStore
from repro_torch.encoding import EncoderConfig
from repro_torch.resilience import (
    NO_RETRY, FaultPolicy, FitJournal, JournalError, TransientFault,
    classify_default, reap_stale_staging, retry_call,
)
from repro_torch.resilience.faultsim import (
    FaultInjector, InjectedFault, InjectedPermanentFault, flaky_bundle,
    truncate_file, wrap_store,
)
from repro_torch.serving_encoders.fleet import (
    FleetError, FleetFrontend, ResidencyMap, WorkerLost, replay,
)
from repro_torch.serving_encoders.service import PredictRequest, ServiceError
from repro_torch.wholebrain import fit_wholebrain
from repro_torch.wholebrain.solver import journal_signature

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=2e-4)
CFG = dict(n_folds=3, chunk_rows=32, use_pallas=False)


def _counters(prefix: str, mod=obs) -> float:
    return sum(v for k, v in mod.snapshot()["counters"].items()
               if k.startswith(prefix))


def _problem(seed=0, n=96, p=8, t=40):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = rng.normal(size=(p, t)).astype(np.float32) / np.sqrt(p)
    Y = (X @ W + 0.05 * rng.normal(size=(n, t))).astype(np.float32)
    return X, Y


def _stores(make_run_store, seed=0, k=3):
    """One store directory, opened by the reference and by the port."""
    X, Y = _problem(seed)
    jstore = make_run_store(X, Y, n_folds=k)
    return jstore, RunStore.open(jstore.root)


def _make_store(make_run_store, seed=0, k=3):
    return _stores(make_run_store, seed, k)[1]


def _fit(store, **kw):
    return fit_wholebrain(store, EncoderConfig(**CFG), t_block=12,
                          device="cpu", **kw)


def _assert_bitwise(res, ref):
    np.testing.assert_array_equal(res.best_lambda, ref.best_lambda)
    np.testing.assert_array_equal(res.cv_scores, ref.cv_scores)
    np.testing.assert_array_equal(res.weights, ref.weights)
    np.testing.assert_array_equal(res.lambda_by_target,
                                  ref.lambda_by_target)


# ---------------------------------------------------------------------------
# FaultPolicy / retry_call
# ---------------------------------------------------------------------------

def test_delay_deterministic_and_bounded():
    a = FaultPolicy(seed=7)
    b = FaultPolicy(seed=7)
    assert [a.delay_for("op", i) for i in range(1, 6)] \
        == [b.delay_for("op", i) for i in range(1, 6)]
    assert a.delay_for("op", 1) != FaultPolicy(seed=8).delay_for("op", 1)
    assert a.delay_for("op", 1) != a.delay_for("other", 1)
    for i in range(1, 12):
        assert 0.0 <= a.delay_for("op", i) \
            <= a.max_delay_s * (1 + a.jitter)
        # The reference backs off by the same delays.
        assert a.delay_for("op", i) == JPolicy(seed=7).delay_for("op", i)


def test_classify_default():
    import errno
    assert classify_default(TransientFault("x"))
    assert classify_default(TimeoutError())
    assert classify_default(OSError(errno.EIO, "io"))
    assert classify_default(OSError(errno.EAGAIN, "again"))
    assert not classify_default(OSError(errno.ENOENT, "gone"))
    assert not classify_default(ValueError("nope"))
    assert not classify_default(InjectedPermanentFault("planned"))
    assert classify_default(InjectedFault("planned"))


def test_retry_call_retries_then_succeeds():
    policy = FaultPolicy(max_attempts=3, seed=3).with_virtual_time()
    calls = []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise TransientFault("flake")
        return "ok"

    r0, g0 = _counters("io_retries{op=t.fn"), _counters("io_giveups{op=t.fn")
    tracer = obs.install()
    try:
        assert retry_call(fn, policy, "t.fn") == "ok"
    finally:
        obs.uninstall()
    assert len(calls) == 3
    assert _counters("io_retries{op=t.fn") - r0 == 2
    assert _counters("io_giveups{op=t.fn") - g0 == 0
    expect = policy.delay_for("t.fn", 1) + policy.delay_for("t.fn", 2)
    assert policy.clock() == pytest.approx(expect)
    backoffs = [e for e in tracer.events() if e["name"] == "retry.backoff"]
    assert [e["attrs"]["attempt"] for e in backoffs] == [1, 2]
    assert backoffs[0]["attrs"]["op"] == "t.fn"


def test_retry_call_permanent_raises_first():
    policy = FaultPolicy(max_attempts=5).with_virtual_time()
    calls = []

    def fn():
        calls.append(1)
        raise ValueError("permanent")

    with pytest.raises(ValueError):
        retry_call(fn, policy, "t.perm")
    assert len(calls) == 1
    assert policy.clock() == 0.0


def test_retry_call_give_up_reraises_original():
    policy = FaultPolicy(max_attempts=2, seed=1).with_virtual_time()
    boom = InjectedFault("always")
    g0 = _counters("io_giveups{op=t.give")
    tracer = obs.install()
    try:
        with pytest.raises(InjectedFault) as err:
            retry_call(lambda: (_ for _ in ()).throw(boom), policy, "t.give")
    finally:
        obs.uninstall()
    assert err.value is boom
    assert _counters("io_giveups{op=t.give") - g0 == 1
    (giveup,) = [e for e in tracer.events() if e["name"] == "retry.giveup"]
    assert giveup["instant"] and giveup["attrs"] == {"op": "t.give",
                                                     "attempt": 2}


def test_retry_call_deadline_beats_attempts():
    policy = FaultPolicy(max_attempts=100, base_delay_s=1.0, jitter=0.0,
                         deadline_s=2.5).with_virtual_time()
    calls = []

    def fn():
        calls.append(1)
        raise TransientFault("slow storage")

    with pytest.raises(TransientFault):
        retry_call(fn, policy, "t.deadline")
    assert len(calls) == 3


def test_no_retry_policy():
    calls = []

    def fn():
        calls.append(1)
        raise TransientFault("x")

    with pytest.raises(TransientFault):
        retry_call(fn, None, "t.noretry")
    assert len(calls) == 1
    assert NO_RETRY.max_attempts == 1


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------

def test_injector_plans_exact_invocations():
    inj = FaultInjector(seed=5)
    inj.plan("op", 2)
    inj.plan("op", 4, times=2)
    seen = []
    for i in range(1, 7):
        try:
            inj.check("op")
            seen.append(i)
        except InjectedFault:
            pass
    assert seen == [1, 3, 6]
    assert inj.count("op") == 6
    assert inj.fired("op") == 3
    with pytest.raises(ValueError):
        inj.plan("op", 0)


def test_injector_custom_exception():
    inj = FaultInjector()
    inj.plan("op", 1, exc=lambda: InjectedPermanentFault("dead disk"))
    with pytest.raises(InjectedPermanentFault):
        inj.check("op")


# ---------------------------------------------------------------------------
# FitJournal
# ---------------------------------------------------------------------------

def test_journal_round_trip(tmp_path):
    sig = {"n": 8, "k": 3}
    j = FitJournal.attach(str(tmp_path / "j"), sig)
    assert not j.has_xstats and j.completed_blocks() == set()
    G = np.arange(24, dtype=np.float32).reshape(3, 8)
    j.put_xstats(G, G[:, 0], np.array([2.0, 3.0, 3.0], np.float32))
    j.put_block(0, scores=np.ones((3, 4)), ahat=np.zeros((2, 5), np.float32))
    j.put_block(2, lam=1.5, curve=np.ones(4), W=np.ones((2, 3)))

    j2 = FitJournal.attach(str(tmp_path / "j"), sig)
    assert j2.has_xstats
    np.testing.assert_array_equal(j2.load_xstats()[0], G)
    assert j2.completed_blocks() == {0, 2}
    assert j2.has_block(0) and not j2.has_block(1)
    rec = j2.load_block(2)
    assert rec["lam"] == 1.5
    np.testing.assert_array_equal(rec["W"], np.ones((2, 3)))
    with pytest.raises(JournalError):
        j2.load_block(1)
    # The reference reads the port's journal (and the reverse below).
    j3 = JJournal.attach(str(tmp_path / "j"), sig)
    assert j3.completed_blocks() == {0, 2}
    np.testing.assert_array_equal(j3.load_block(0)["ahat"],
                                  np.zeros((2, 5), np.float32))
    j2.finish()
    assert not os.path.isdir(str(tmp_path / "j"))


def test_journal_signature_mismatch(tmp_path):
    FitJournal.attach(str(tmp_path / "j"), {"n": 8})
    with pytest.raises(JournalError):
        FitJournal.attach(str(tmp_path / "j"), {"n": 9})


def test_journal_corrupt_ledger(tmp_path):
    j = FitJournal.attach(str(tmp_path / "j"), {"n": 8})
    path = os.path.join(j.root, "ledger.json")
    truncate_file(path, os.path.getsize(path) // 2)
    with pytest.raises(JournalError):
        FitJournal.attach(str(tmp_path / "j"), {"n": 8})


def test_journal_reaps_torn_payloads(tmp_path):
    sig = {"n": 8}
    j = FitJournal.attach(str(tmp_path / "j"), sig)
    j.put_block(0, scores=np.ones(3))
    orphan = os.path.join(j.root, "block_00001.scores.npy.tmp-999")
    with open(orphan, "wb") as f:
        f.write(b"torn")
    c0 = _counters("staging_reaped")
    j2 = FitJournal.attach(str(tmp_path / "j"), sig)
    assert not os.path.exists(orphan)
    assert j2.completed_blocks() == {0}
    assert _counters("staging_reaped") - c0 == 1


# ---------------------------------------------------------------------------
# Crash-resume bit-identity
# ---------------------------------------------------------------------------

class _Interrupted(BaseException):
    """In-process stand-in for the kill: raised right after block N's
    ledger commit, so the journal state is exactly a crashed fit's."""


class _InterruptAfterBlock:
    def __init__(self, journal, after: int):
        self._journal = journal
        self._after = after

    def put_block(self, bi: int, **kwargs) -> None:
        self._journal.put_block(bi, **kwargs)
        if bi == self._after:
            raise _Interrupted()

    def __getattr__(self, name):
        return getattr(self._journal, name)


@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
def test_crash_resume_bit_identical(make_run_store, tmp_path, lambda_mode):
    store = _make_store(make_run_store)
    ref = _fit(store, lambda_mode=lambda_mode)
    assert ref.telemetry["n_blocks"] == 4

    jdir = str(tmp_path / "journal")
    sig = journal_signature(store, EncoderConfig(**CFG), t_block=12,
                            lambda_mode=lambda_mode, device="cpu")
    wrapped = _InterruptAfterBlock(FitJournal.attach(jdir, sig), after=1)
    with pytest.raises(_Interrupted):
        _fit(store, lambda_mode=lambda_mode, journal=wrapped)
    ledger = json.load(open(os.path.join(jdir, "ledger.json")))
    assert ledger["xstats"] and set(ledger["blocks"]) == {"0", "1"}

    tracer = obs.install()
    try:
        res = _fit(store, lambda_mode=lambda_mode, journal=jdir)
    finally:
        obs.uninstall()
    tel = res.telemetry
    assert tel["resumed"]
    assert tel["blocks_replayed"] == 2 and tel["blocks_streamed"] == 2
    assert tel["row_passes_x"] <= ref.telemetry["row_passes_x"]
    _assert_bitwise(res, ref)
    assert not os.path.isdir(jdir)
    names = [e["name"] for e in tracer.events()]
    assert "journal.resume" in names and "journal.finish" in names
    replayed = [e["attrs"]["block"] for e in tracer.events()
                if e["name"] == "wholebrain.block"
                and e["attrs"].get("replayed")]
    assert replayed == [0, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
def test_cuda_crash_resume_bit_identical(tmp_path, lambda_mode):
    """On the card, with the kernel tier: a fit interrupted after block 1
    resumes bitwise equal to the uninterrupted fit.  (The store is the
    port's: the card's host cannot open the reference's.)"""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel tier has no CPU mode")
    X, Y = _problem(3, n=1500, p=96, t=200)
    writer = RunStore.create(str(tmp_path / "store"), n_folds=3)
    writer.write(X[:700], Y[:700], "run-0")
    writer.write(X[700:], Y[700:], "run-1")
    store = RunStore.open(str(tmp_path / "store"))
    cfg = EncoderConfig(n_folds=3, chunk_rows=512)
    kw = dict(t_block=64, lambda_mode=lambda_mode, device="cuda")
    ref = fit_wholebrain(store, cfg, **kw)
    assert ref.telemetry["use_pallas"] and ref.telemetry["n_blocks"] == 4
    jdir = str(tmp_path / "journal")
    sig = journal_signature(store, cfg, t_block=64, lambda_mode=lambda_mode,
                            device="cuda")
    wrapped = _InterruptAfterBlock(FitJournal.attach(jdir, sig), after=1)
    with pytest.raises(_Interrupted):
        fit_wholebrain(store, cfg, journal=wrapped, **kw)
    res = fit_wholebrain(store, cfg, journal=jdir, **kw)
    assert res.telemetry["blocks_replayed"] == 2
    _assert_bitwise(res, ref)
    assert not os.path.isdir(jdir)


def test_journal_rejects_other_fit_shape(make_run_store, tmp_path):
    store = _make_store(make_run_store)
    cfg = EncoderConfig(**CFG)
    jdir = str(tmp_path / "journal")
    sig = journal_signature(store, cfg, t_block=12, device="cpu")
    wrapped = _InterruptAfterBlock(FitJournal.attach(jdir, sig), after=0)
    with pytest.raises(_Interrupted):
        _fit(store, journal=wrapped)
    with pytest.raises(JournalError):          # different blocking
        fit_wholebrain(store, cfg, t_block=20, journal=jdir, device="cpu")
    # An attached journal with another signature is refused too.
    other = FitJournal.attach(str(tmp_path / "other"), dict(sig, t_block=20))
    with pytest.raises(JournalError, match="does not match"):
        _fit(store, journal=other)


def test_killed_child_resumes_bit_identical(make_run_store, tmp_path):
    """A child process hard-killed by ``KillAfterBlock`` right after block 1
    commits (``os._exit(42)``) leaves a journal the parent resumes."""
    store = _make_store(make_run_store)
    ref = _fit(store)
    jdir = str(tmp_path / "journal")
    code = (
        "import sys\n"
        "from repro_torch.data.store import RunStore\n"
        "from repro_torch.encoding import EncoderConfig\n"
        "from repro_torch.resilience import FitJournal\n"
        "from repro_torch.resilience.faultsim import KillAfterBlock\n"
        "from repro_torch.wholebrain import fit_wholebrain\n"
        "from repro_torch.wholebrain.solver import journal_signature\n"
        "store = RunStore.open(sys.argv[1])\n"
        f"cfg = EncoderConfig(**{CFG!r})\n"
        "sig = journal_signature(store, cfg, t_block=12, device='cpu')\n"
        "j = KillAfterBlock(FitJournal.attach(sys.argv[2], sig), 1)\n"
        "fit_wholebrain(store, cfg, t_block=12, journal=j, device='cpu')\n"
        "sys.exit(0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code, store.root, jdir],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 42, out.stderr
    ledger = json.load(open(os.path.join(jdir, "ledger.json")))
    assert set(ledger["blocks"]) == {"0", "1"}
    res = _fit(store, journal=jdir)
    assert res.telemetry["blocks_replayed"] == 2
    _assert_bitwise(res, ref)
    assert not os.path.isdir(jdir)


@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
def test_reference_journal_resumes_in_port(make_run_store, tmp_path,
                                           lambda_mode):
    """A journal the reference's interrupted CPU fit wrote attaches in the
    port (the signatures are equal) and resumes to the reference's λ and,
    within the f32 tolerance, its W."""
    jstore, store = _stores(make_run_store)
    jcfg = JConfig(**CFG)
    jref = jfit_wholebrain(jstore, jcfg, t_block=12, lambda_mode=lambda_mode)
    jdir = str(tmp_path / "journal")
    jsig = jjournal_signature(jstore, jcfg, t_block=12,
                              lambda_mode=lambda_mode)
    tsig = journal_signature(store, EncoderConfig(**CFG), t_block=12,
                             lambda_mode=lambda_mode, device="cpu")
    assert jsig == tsig
    wrapped = _InterruptAfterBlock(JJournal.attach(jdir, jsig), after=1)
    with pytest.raises(_Interrupted):
        jfit_wholebrain(jstore, jcfg, t_block=12, lambda_mode=lambda_mode,
                        journal=wrapped)
    res = _fit(store, lambda_mode=lambda_mode, journal=jdir)
    assert res.telemetry["resumed"] and res.telemetry["blocks_replayed"] == 2
    np.testing.assert_array_equal(res.best_lambda, jref.best_lambda)
    np.testing.assert_array_equal(res.lambda_by_target,
                                  jref.lambda_by_target)
    np.testing.assert_allclose(res.weights, np.asarray(jref.weights), **F32)
    np.testing.assert_allclose(res.cv_scores, jref.cv_scores, **F32)
    assert not os.path.isdir(jdir)


@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
def test_journal_layout_matches_reference(make_run_store, tmp_path,
                                          lambda_mode):
    """Interrupted after block 1, both packages leave the same files, the
    same ledger (keys, block records, signature) and arrays of the same
    shapes and dtypes."""
    jstore, store = _stores(make_run_store)
    jcfg = JConfig(**CFG)
    jsig = jjournal_signature(jstore, jcfg, t_block=12,
                              lambda_mode=lambda_mode)
    jw = _InterruptAfterBlock(JJournal.attach(str(tmp_path / "j"), jsig), 1)
    with pytest.raises(_Interrupted):
        jfit_wholebrain(jstore, jcfg, t_block=12, lambda_mode=lambda_mode,
                        journal=jw)
    tsig = journal_signature(store, EncoderConfig(**CFG), t_block=12,
                             lambda_mode=lambda_mode, device="cpu")
    tw = _InterruptAfterBlock(FitJournal.attach(str(tmp_path / "t"), tsig), 1)
    with pytest.raises(_Interrupted):
        _fit(store, lambda_mode=lambda_mode, journal=tw)
    jfiles = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == jfiles
    jl = json.load(open(tmp_path / "j" / "ledger.json"))
    tl = json.load(open(tmp_path / "t" / "ledger.json"))
    assert set(tl) == set(jl) and tl["signature"] == jl["signature"]
    assert tl["blocks"].keys() == jl["blocks"].keys()
    for b in jl["blocks"]:
        assert set(tl["blocks"][b]) == set(jl["blocks"][b])
        if "lam" in jl["blocks"][b]:
            assert tl["blocks"][b]["lam"] == jl["blocks"][b]["lam"]
    for f in jfiles:
        if f.endswith(".npy"):
            a = np.load(tmp_path / "j" / f)
            b = np.load(tmp_path / "t" / f)
            assert (a.shape, a.dtype) == (b.shape, b.dtype), f


# ---------------------------------------------------------------------------
# Streamed fit under injected faults
# ---------------------------------------------------------------------------

def _plan(inj):
    inj.plan("store.mmap", 1)
    inj.plan("store.chunk", 2)
    inj.plan("store.chunk", 7)
    return inj


def test_fit_unchanged_by_injected_transient_faults(make_run_store):
    jstore, store = _stores(make_run_store)
    ref = _fit(store)

    store.fault_policy = FaultPolicy(max_attempts=3,
                                     seed=13).with_virtual_time()
    inj = _plan(FaultInjector(seed=13))
    r0 = {op: _counters(f"io_retries{{op={op}")
          for op in ("store.mmap", "prefetch.read")}
    g0 = _counters("io_giveups")
    res = _fit(wrap_store(store, inj))
    assert inj.fired("store.chunk") == 2 and inj.fired("store.mmap") == 1
    retries = {op: _counters(f"io_retries{{op={op}") - r0[op] for op in r0}
    assert sum(retries.values()) >= 3
    assert _counters("io_giveups") - g0 == 0
    _assert_bitwise(res, ref)
    assert res.telemetry["colblock_compile_delta"] == 0
    assert res.telemetry["gram_compile_delta"] == 0

    # The reference under the same plan retries the same ops as often.
    jstore.fault_policy = JPolicy(max_attempts=3, seed=13).with_virtual_time()
    jinj = _plan(JInjector(seed=13))
    jr0 = {op: _counters(f"io_retries{{op={op}", jobs) for op in r0}
    jfit_wholebrain(jwrap_store(jstore, jinj), JConfig(**CFG), t_block=12)
    assert {op: _counters(f"io_retries{{op={op}", jobs) - jr0[op]
            for op in r0} == retries


# ---------------------------------------------------------------------------
# ChunkPrefetcher retry paths
# ---------------------------------------------------------------------------

def _prefetcher(store, chunk_rows=32):
    return store.iter_chunks(chunk_rows, prefetch=True)


def test_prefetch_retry_success_bit_identical(make_run_store):
    store = _make_store(make_run_store)
    sync = [(x.copy(), y.copy()) for x, y in store.iter_chunks(32)]

    store.fault_policy = FaultPolicy(max_attempts=3,
                                     seed=2).with_virtual_time()
    inj = FaultInjector(seed=2)
    inj.plan("store.chunk", 2)
    faulty = wrap_store(store, inj)
    r0 = _counters("io_retries{op=prefetch.read")
    pf = _prefetcher(faulty)
    got = [(x.copy(), y.copy()) for x, y in pf]
    assert len(got) == len(sync)
    for (gx, gy), (sx, sy) in zip(got, sync):
        np.testing.assert_array_equal(gx, sx)
        np.testing.assert_array_equal(gy, sy)
    assert pf._bufs is None and pf._thread is None
    assert _counters("io_retries{op=prefetch.read") - r0 == 1


def test_prefetch_give_up_frees_pool(make_run_store):
    store = _make_store(make_run_store)
    store.fault_policy = FaultPolicy(max_attempts=3,
                                     seed=2).with_virtual_time()
    inj = FaultInjector(seed=2)
    inj.plan("store.chunk", 2, times=5)
    faulty = wrap_store(store, inj)
    pf = _prefetcher(faulty)
    g0 = _counters("io_giveups{op=prefetch.read")
    with pytest.raises(InjectedFault):
        list(pf)
    assert _counters("io_giveups{op=prefetch.read") - g0 == 1
    assert pf._bufs is None and pf._thread is None
    again = [(x.copy(), y.copy()) for x, y in _prefetcher(faulty)]
    assert len(again) == len(list(store.iter_chunks(32)))


def test_prefetch_permanent_after_successful_retry(make_run_store):
    store = _make_store(make_run_store)
    store.fault_policy = FaultPolicy(max_attempts=3,
                                     seed=4).with_virtual_time()
    inj = FaultInjector(seed=4)
    inj.plan("store.chunk", 1)
    inj.plan("store.chunk", 3, exc=lambda: InjectedPermanentFault("dead"))
    faulty = wrap_store(store, inj)
    pf = _prefetcher(faulty)
    got = []
    with pytest.raises(InjectedPermanentFault):
        for chunk in pf:
            got.append(chunk)
    assert len(got) >= 1
    assert pf._bufs is None and pf._thread is None


# ---------------------------------------------------------------------------
# Store-level mmap retry
# ---------------------------------------------------------------------------

def test_store_mmap_retry(make_run_store):
    store = _make_store(make_run_store)
    store.fault_policy = FaultPolicy(max_attempts=3,
                                     seed=6).with_virtual_time()
    inj = FaultInjector(seed=6)
    inj.plan("store.mmap", 1)
    faulty = wrap_store(store, inj)
    r0 = _counters("io_retries{op=store.mmap")
    chunks = list(faulty.iter_chunks(32))
    assert sum(x.shape[0] for x, _ in chunks) == store.shape[0]
    assert _counters("io_retries{op=store.mmap") - r0 == 1


def test_store_mmap_no_policy_raises(make_run_store):
    store = _make_store(make_run_store)
    assert store.fault_policy is None
    inj = FaultInjector()
    inj.plan("store.mmap", 1)
    with pytest.raises(InjectedFault):
        list(wrap_store(store, inj).iter_chunks(32))


# ---------------------------------------------------------------------------
# Registry retry + typed give-up
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_fleet(tmp_path_factory):
    from repro_torch.serving_encoders.traffic import build_synthetic_fleet
    root = tmp_path_factory.mktemp("fleet")
    return build_synthetic_fleet(str(root), 1, n=64, p=16, t=24,
                                 device="cpu")


def test_registry_load_retries(tiny_fleet):
    from repro_torch.serving_encoders.registry import EncoderRegistry
    inj = FaultInjector(seed=8)
    inj.plan("bundle.load_encoder", 1)
    reg = EncoderRegistry(
        wave_rows=8, device="cpu",
        fault_policy=FaultPolicy(max_attempts=3, seed=8).with_virtual_time())
    name, path = tiny_fleet[0]
    reg.add(name, path)
    reg._bundles[name] = flaky_bundle(reg._bundles[name], inj)
    r0 = _counters("io_retries{op=registry.load_encoder")
    l0 = _counters("registry_loads")
    entry = reg.get(name)
    assert entry.encoder is not None
    assert _counters("io_retries{op=registry.load_encoder") - r0 == 1
    assert _counters("registry_loads") - l0 == 1


def test_registry_give_up_is_typed(tiny_fleet):
    from repro_torch.serving_encoders.bundle import BundleError
    from repro_torch.serving_encoders.registry import EncoderRegistry
    inj = FaultInjector(seed=9)
    inj.plan("bundle.load_encoder", 1, times=10)
    reg = EncoderRegistry(
        wave_rows=8, device="cpu",
        fault_policy=FaultPolicy(max_attempts=3, seed=9).with_virtual_time())
    name, path = tiny_fleet[0]
    reg.add(name, path)
    reg._bundles[name] = flaky_bundle(reg._bundles[name], inj)
    g0 = _counters("io_giveups{op=registry.load_encoder")
    with pytest.raises(BundleError):
        reg.get(name)
    assert _counters("io_giveups{op=registry.load_encoder") - g0 == 1
    assert reg.stats()["loaded"] == 0


# ---------------------------------------------------------------------------
# Orphan-staging reaper
# ---------------------------------------------------------------------------

def test_reap_is_age_gated(tmp_path):
    root = str(tmp_path)
    old = tmp_path / ".tmpbundle_dead"
    old.mkdir()
    (old / "leaf.npy").write_bytes(b"x")
    fresh = tmp_path / ".tmpbundle_live"
    fresh.mkdir()
    torn = tmp_path / "shard.npy.tmp-123"
    torn.write_bytes(b"y")
    keeper = tmp_path / "manifest.json"
    keeper.write_text("{}")
    past = os.stat(root).st_mtime - 7200
    os.utime(old, (past, past))
    os.utime(torn, (past, past))

    c0 = _counters("staging_reaped")
    tracer = obs.install()
    try:
        reaped = reap_stale_staging(root, max_age_s=3600.0)
    finally:
        obs.uninstall()
    assert reaped == [".tmpbundle_dead", "shard.npy.tmp-123"]
    assert not old.exists() and not torn.exists()
    assert fresh.exists() and keeper.exists()
    assert _counters("staging_reaped") - c0 == 2
    assert [e["attrs"]["path"] for e in tracer.events()
            if e["name"] == "cleanup.reap"] == reaped
    assert reap_stale_staging(str(tmp_path / "missing")) == []


def test_bundle_writer_reaps_stale_staging(tmp_path):
    from repro_torch.wholebrain.artifact import BundleWriter
    stale = tmp_path / ".tmpbundle_crashed"
    stale.mkdir()
    past = os.stat(str(tmp_path)).st_mtime - 7200
    os.utime(stale, (past, past))
    w = BundleWriter(str(tmp_path / "bundle"), p=4, t=8)
    try:
        assert not stale.exists()
    finally:
        w.abort()


# ---------------------------------------------------------------------------
# Fleet liveness: leases, lock timeout, WorkerLost
# ---------------------------------------------------------------------------

def _clocked_map(path, t0=1000.0, **kw):
    clk = [t0]
    rmap = ResidencyMap(path, clock=lambda: clk[0],
                        sleep=lambda s: clk.__setitem__(0, clk[0] + s),
                        **kw)
    return rmap, clk


def test_lease_heartbeat_and_expiry(tmp_path):
    rmap, clk = _clocked_map(str(tmp_path / "residency.json"))
    rmap.publish("w0", {"m": 100})
    clk[0] += 10
    rmap.publish("w1", {"m": 50})
    assert rmap.holders("m") == ["w0", "w1"]
    assert rmap.holders("m", ttl_s=5.0) == ["w1"]

    clk[0] += 10
    rmap.heartbeat("w1")
    c0 = _counters("lease_expirations")
    assert rmap.expire_dead(15.0) == ["w0"]
    assert _counters("lease_expirations") - c0 == 1
    snap = rmap.snapshot()["workers"]
    assert set(snap) == {"w1"}
    assert snap["w1"]["models"] == {"m": 50}
    assert rmap.expire_dead(15.0) == []


def test_unstamped_row_counts_as_dead(tmp_path):
    rmap, clk = _clocked_map(str(tmp_path / "residency.json"))
    rmap.publish("w0", {"m": 1})
    data = rmap.snapshot()
    del data["workers"]["w0"]["heartbeat"]
    rmap._write(data)
    assert rmap.expire_dead(1e9) == ["w0"]


def test_heartbeat_claims_lease_before_first_load(tmp_path):
    rmap, clk = _clocked_map(str(tmp_path / "residency.json"))
    rmap.heartbeat("w0")
    row = rmap.snapshot()["workers"]["w0"]
    assert row["models"] == {} and row["heartbeat"] == clk[0]


def test_lock_timeout_is_typed(tmp_path):
    import fcntl
    path = str(tmp_path / "residency.json")
    rmap, clk = _clocked_map(path, lock_timeout_s=0.5)
    fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    tracer = obs.install()
    try:
        t0 = clk[0]
        with pytest.raises(FleetError):
            rmap.publish("w0", {})
        assert clk[0] - t0 >= 0.5
    finally:
        obs.uninstall()
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    assert [e["name"] for e in tracer.events()] == ["fleet.lock_timeout"]
    rmap.publish("w0", {})


class _FakeStats:
    def __init__(self):
        self.rejected = []

    def record_rejected(self, tenant):
        self.rejected.append(tenant)


class _FlakyService:
    """Raises ``WorkerLost`` on the first ``fail_times`` serve calls."""

    def __init__(self, fail_times=1):
        self.stats = _FakeStats()
        self.fail_times = fail_times
        self.calls = 0

    def serve(self, batch, wave_rows=None):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise WorkerLost("worker died mid-batch")
        return [f"r{p.model}:{i}" for i, p in enumerate(batch)]


def _req(model="m", rows=4):
    return PredictRequest(model, np.zeros((rows, 3), np.float32))


def test_worker_lost_readmits_batch():
    svc = _FlakyService(fail_times=1)
    fe = FleetFrontend(svc, max_pending_rows=64)
    fe.submit(_req(rows=4))
    fe.submit(_req(rows=6))
    c0 = _counters("requests_replayed")
    with pytest.raises(WorkerLost):
        fe.flush()
    assert fe.pending_rows == 10 and fe.replayed == 2
    assert _counters("requests_replayed") - c0 == 2
    out = fe.flush()
    assert len(out) == 2 and fe.pending_rows == 0


def test_replay_survives_lost_worker():
    svc = _FlakyService(fail_times=1)
    fe = FleetFrontend(svc, max_pending_rows=64)
    reqs = [_req(rows=4) for _ in range(5)]
    a0 = _counters("admitted_rows")
    results, rejections = replay(fe, reqs)
    assert all(r is not None for r in results)
    assert rejections == [] and fe.replayed == 5
    assert _counters("admitted_rows") - a0 == 20


def test_replay_gives_up_after_max_attempts():
    svc = _FlakyService(fail_times=99)
    fe = FleetFrontend(svc, max_pending_rows=64)
    with pytest.raises(WorkerLost):
        replay(fe, [_req()], max_flush_attempts=3)
    assert svc.calls == 3


def test_backpressure_still_typed_alongside_replay():
    svc = _FlakyService(fail_times=0)
    fe = FleetFrontend(svc, max_pending_rows=8)
    fe.submit(_req(rows=8))
    r0 = _counters("rejected_requests")
    with pytest.raises(ServiceError):
        fe.submit(_req(rows=1))
    assert svc.stats.rejected == ["m"]
    assert _counters("rejected_requests") - r0 == 1
