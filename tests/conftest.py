import numpy as np
import pytest


@pytest.fixture
def make_run_store(tmp_path):
    """Tiny ``RunStore`` factory: write (X, Y) into a tmp_path-backed store
    split into ``n_runs`` row shards, reopen read-only, return the store.

    ``factory(X, Y, n_runs=3)`` → validated, memory-mapped ``RunStore``.
    """
    from repro.data.store import RunStore

    counter = {"n": 0}

    def factory(X, Y, *, n_runs: int = 2, n_folds: int = 5):
        X, Y = np.asarray(X), np.asarray(Y)
        counter["n"] += 1
        root = tmp_path / f"run_store_{counter['n']}"
        store = RunStore.create(str(root), n_folds=n_folds, dtype=X.dtype)
        n = X.shape[0]
        bounds = [(i * n // n_runs, (i + 1) * n // n_runs)
                  for i in range(n_runs)]
        for i, (lo, hi) in enumerate(bounds):
            store.write(X[lo:hi], Y[lo:hi], f"run-{i:03d}")
        return RunStore.open(str(root))

    return factory


def pytest_configure(config):
    # pytest-timeout provides this marker when installed; register it so the
    # suite runs warning-free (and without the plugin, e.g. in this container).
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test timeout (pytest-timeout)")
    # Slow lane: interpret-mode Pallas kernel tests (correct but orders of
    # magnitude slower than compiled).  CI's quick lane runs
    # ``pytest -m "not slow"``; the tier-1 gate still runs everything.
    config.addinivalue_line(
        "markers", "slow: interpret-mode Pallas / long-running tests "
                   "(excluded from the CI quick lane)")
    # Tests of the PyTorch port's CUDA kernels: they skip without a card
    # (decided inside the test, never at import) and run on the GPU host.
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written kernels)")
