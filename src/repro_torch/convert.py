"""Carry state across packages: numpy arrays → the port's objects.

A fit made by the JAX package, exported as numpy arrays, becomes the
port's ``FoldStats`` or a fitted ``BrainEncoder`` here, a model's
parameter tree becomes the port's parameters (``shard_params`` places
them on a device mesh) and a prefill's decode cache the port's cache, so
both packages can be held to the same statistics, weights, forward and
decode.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.foldstats import FoldStats
from repro_torch.device import as_tensor, resolve_device
from repro_torch.encoding.config import EncoderConfig
from repro_torch.encoding.dispatch import DispatchDecision
from repro_torch.encoding.estimator import BrainEncoder, EncodingReport
from repro_torch.encoding.pipeline import Standardizer
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig


def fold_stats_from_numpy(G, C, xsum, ysum, ysq, count, *,
                          device: torch.device | str | None = None
                          ) -> FoldStats:
    """``FoldStats`` from the six per-fold arrays (as f32 tensors)."""
    dev = resolve_device(device)

    def t(a):
        return as_tensor(np.asarray(a, np.float32), dev)

    return FoldStats(G=t(G), C=t(C), xsum=t(xsum), ysum=t(ysum), ysq=t(ysq),
                     count=t(count))


def encoder_from_numpy(weights, best_lambda, cv_scores, lambdas,
                       decision: dict, standardizer: dict | None = None, *,
                       device: torch.device | str | None = None
                       ) -> BrainEncoder:
    """A fitted ``BrainEncoder`` from a fit's arrays and its decision dict
    (``dataclasses.asdict`` of a dispatch decision, or a report's
    ``to_dict()["decision"]``).  ``standardizer`` holds any of ``mu_x``,
    ``sd_x``, ``mu_y``, ``sd_y``."""
    enc = BrainEncoder(EncoderConfig(lambdas=tuple(lambdas)), device=device)
    enc.report_ = EncodingReport(
        weights=as_tensor(np.asarray(weights, np.float32), enc.device),
        best_lambda=np.atleast_1d(np.asarray(best_lambda, np.float64)),
        cv_scores=np.atleast_2d(np.asarray(cv_scores, np.float64)),
        lambdas=tuple(lambdas), decision=DispatchDecision(**decision))
    if standardizer is not None:
        enc.standardizer_ = Standardizer(**{
            k: None if v is None else as_tensor(np.asarray(v, np.float32),
                                                enc.device)
            for k, v in standardizer.items()})
    return enc


def _tree_from_numpy(tree, defs, dev, free_axes=()) -> dict:
    """``tree``'s leaves as tensors on ``dev`` (dtypes kept), its keys and
    shapes checked against the ``ParamDef`` tree ``defs``; a dimension on
    one of ``free_axes`` may take any size."""
    def walk(t, d, path):
        if isinstance(d, dict):
            if not isinstance(t, dict) or set(t) != set(d):
                got = sorted(t) if isinstance(t, dict) else type(t).__name__
                raise ValueError(f"tree at {path or '/'}: keys {got}, want "
                                 f"{sorted(d)}")
            return {k: walk(t[k], d[k], f"{path}/{k}") for k in sorted(d)}
        a = np.asarray(t)
        want = tuple(None if ax in free_axes else n
                     for n, ax in zip(d.shape, d.axes))
        if a.ndim != len(want) or any(w is not None and w != n
                                      for n, w in zip(a.shape, want)):
            raise ValueError(f"leaf {path}: shape {a.shape}, want "
                             f"{d.shape} (any size on axes {free_axes})")
        return as_tensor(np.ascontiguousarray(a), dev)

    return walk(tree, defs, "")


def model_params_from_numpy(tree: dict, cfg: ModelConfig, *,
                            device: torch.device | str | None = None) -> dict:
    """The port's parameters of ``build_model(cfg)`` from a parameter tree
    as numpy (the JAX ``model.init(...)`` tree passed through
    ``np.asarray``): nested dicts of arrays, bf16 leaves as ml_dtypes
    ``bfloat16`` or ``uint16`` bit patterns (``device.host_view``).  Every
    leaf keeps its dtype; keys and shapes are checked against the port's
    ``param_defs()``."""
    return _tree_from_numpy(tree, build_model(cfg).param_defs(),
                            resolve_device(device))


def cache_from_numpy(tree: dict, cfg: ModelConfig, *,
                     device: torch.device | str | None = None) -> dict:
    """The port's decode cache of ``build_model(cfg)`` from a cache tree as
    numpy (a JAX ``prefill``'s or ``decode_step``'s cache through
    ``np.asarray``), ready for the port's ``decode_step``.  Every leaf
    keeps its dtype; keys and shapes are checked against the port's
    ``cache_defs``, at any batch size and cache length."""
    return _tree_from_numpy(tree, build_model(cfg).cache_defs(1, 1),
                            resolve_device(device),
                            free_axes=("batch", "cache_seq"))


def shard_params(params: dict, cfg: ModelConfig, mesh,
                 rules: str = "tp") -> dict:
    """A whole parameter tree (``model_params_from_numpy``'s, the same on
    every rank) placed on ``mesh`` by the rule table ``rules``: a DTensor
    per leaf, each rank keeping its block (``launch.steps``' shardings)."""
    from repro_torch.launch import steps
    from repro_torch.models.params import specs, tree_map

    table = steps.rule_table(mesh, 0, rules)
    sh = steps.named(mesh, specs(build_model(cfg).param_defs(), table,
                                 mesh.shape))
    return tree_map(lambda t, s: s.distribute(t), params, sh)
