"""Layer loop over stacked parameters.

Port of ``repro/models/scanning.py``.  The reference scans its layer
bodies with ``lax.scan`` and unrolls them only for the dry run's cost
probes; eager PyTorch has no traced loop, so ``scan_blocks`` is a Python
loop over the leading (layer) axis either way.  ``unroll`` is accepted and
changes nothing, so the dry-run port can pass it as the reference does.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils.checkpoint


def _index(tree: Any, i: int) -> Any:
    """Entry ``i`` of the leading axis of every tensor in a nested
    dict/tuple/list (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]


def _stack(items: list) -> Any:
    """The per-step outputs stacked on a new leading axis, tree by tree."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[j] for t in items])
                           for j in range(len(first)))
    return torch.stack(items, dim=0)


def _length(tree: Any) -> int:
    if isinstance(tree, dict):
        return _length(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _length(tree[0])
    return tree.shape[0]


def scan_blocks(body: Callable, init: Any, xs: Any, unroll: bool = False):
    """``carry, y = body(carry, xs[i])`` for every i of the leading axis →
    (final carry, the ys stacked, or None when the body returns None)."""
    del unroll                      # one loop either way (module docstring)
    carry, ys = init, []
    for i in range(_length(xs)):
        carry, y = body(carry, _index(xs, i))
        ys.append(y)
    if ys and ys[0] is not None:
        return carry, _stack(ys)
    return carry, None


def remat(body: Callable) -> Callable:
    """``body`` recomputed in the backward pass instead of keeping its
    intermediates: the reference's ``jax.checkpoint`` of a scanned body,
    as ``torch.utils.checkpoint`` (non-reentrant).  With grad mode off
    there is no backward, and the body runs as it is."""
    def wrapper(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return torch.utils.checkpoint.checkpoint(body, *args,
                                                 use_reentrant=False)
    return wrapper
