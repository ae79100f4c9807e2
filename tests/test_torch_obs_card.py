"""The port's spans on the card, in a file free of JAX so that it runs on
the GPU host (``python -m pytest -q -m cuda tests/test_torch_obs_card.py``).

A fit with an ``obs`` tracer installed forces the card's work at the
spans that synchronise, and only there; a fit under ``torch.profiler``
alone, or untraced, forces nothing; all of them give the same bits.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.encoding import BrainEncoder


def _problem(seed, n, p, t):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = rng.normal(size=(p, t)).astype(np.float32) / np.sqrt(p)
    Y = (X @ W + 0.05 * rng.normal(size=(n, t))).astype(np.float32)
    return X, Y


@pytest.mark.cuda
def test_cuda_in_memory_fit_synchronizes_at_the_primal_leaves(monkeypatch):
    """The in-memory primal fit, traced, synchronises once in each
    ``fit.primal.*`` leaf (the statistics, k folds' and the refit's
    ``eigh``, k folds' scores, the solve) and nowhere else; under the
    profiler alone it synchronises nowhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the synchronise points are CUDA's")
    k = 5
    X, Y = _problem(8, 2048, 64, 32)
    real = torch.cuda.synchronize
    at = []

    def counting(device=None):
        tracer = obs.current()
        stack = getattr(tracer._tls, "stack", None) if tracer else None
        at.append(stack[-1].name if stack else None)
        real(device)

    monkeypatch.setattr(torch.cuda, "synchronize", counting)

    def fit():
        return BrainEncoder(n_folds=k).fit(X, Y)

    plain = fit()
    assert at == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        profiled = fit()
        during = list(at)        # the profiler's own stop synchronises
    assert during == []
    at.clear()
    obs.install()
    try:
        traced = fit()
    finally:
        obs.uninstall()
    assert collections.Counter(at) == {
        "fit.primal.stats": 1, "fit.primal.eigh": k + 1,
        "fit.primal.score": k, "fit.primal.solve": 1}
    assert traced.report_.decision.method == "eigh"
    for other in (profiled, traced):
        assert torch.equal(plain.weights_, other.weights_)
        np.testing.assert_array_equal(plain.report_.cv_scores,
                                      other.report_.cv_scores)
