"""Streaming bundle writes — shards land as blocks finish, one atomic commit.

Port of ``repro/wholebrain/artifact.py``.  ``serving_encoders.bundle.
save_bundle`` serialises a fitted encoder whose full ``(p, t)`` weight
matrix is already in memory.  At whole-brain scale that matrix need not
exist: the column-blocked solver emits one ``(p, w)`` shard per target
block.  ``BundleWriter`` accepts those shards incrementally — each
``append`` writes one ``.npy`` leaf into a hidden staging directory — and
``commit`` writes the metadata leaves, the checkpoint manifest and
``bundle.json``, then atomically renames the staging directory into place.
A crash at any point before the rename leaves no bundle (the staging dir
is hidden and removed by ``abort``/``__exit__``); after it, a complete one.

The committed layout is ``save_bundle``'s — the same ``bundle.json``
schema, the same ``step_0/`` leaf naming, the same bf16-as-uint16 storage
— so ``EncoderBundle.open`` reads it in either package.
``lambda_by_target`` is expanded from the writer's ACTUAL shard bounds.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data.store import _dtype_name, _torch_dtype
from repro_torch.device import host_view
from repro_torch.resilience import cleanup
from repro_torch.serving_encoders.bundle import (
    BUNDLE_MANIFEST, _BUNDLE_VERSION, BundleError, _shard_key,
    _standardizer_leaves, config_to_dict,
)


class BundleWriter:
    """Incremental, atomic ``EncoderBundle`` writer.

    Usage::

        with BundleWriter(path, p=p, t=t, overwrite=True) as w:
            res = fit_wholebrain(store, cfg, t_block=tb, writer=w,
                                 collect=False)
            w.commit(config=cfg, report=report,
                     lambda_by_target=res.lambda_by_target)

    ``append`` is called by the solver as each block finishes; the shard
    hits disk at once, so the host holds one ``(p, t_block)`` shard at a
    time.  Leaving the ``with`` without a ``commit`` aborts (staging
    removed).
    """

    def __init__(self, bundle_dir: str, *, p: int, t: int,
                 weight_dtype: str | torch.dtype = "float32",
                 overwrite: bool = False):
        # Refuse BEFORE staging, like save_bundle (re-checked at commit).
        if os.path.exists(bundle_dir) and not overwrite:
            raise BundleError(f"bundle already exists at {bundle_dir}; "
                              f"pass overwrite=True to replace it")
        self.bundle_dir = bundle_dir
        self.p, self.t = int(p), int(t)
        self._dtype = _torch_dtype(weight_dtype)
        self.weight_dtype = _dtype_name(self._dtype)
        self.overwrite = overwrite
        parent = os.path.dirname(os.path.abspath(bundle_dir)) or "."
        os.makedirs(parent, exist_ok=True)
        # A writer killed before commit leaves its hidden staging dir
        # behind; sweep stale ones (age-gated — a CONCURRENT writer's
        # staging is younger) before adding our own.
        cleanup.reap_stale_staging(parent)
        self._tmp = tempfile.mkdtemp(dir=parent, prefix=".tmpbundle_")
        self._step = os.path.join(self._tmp, "step_0")
        os.makedirs(self._step)
        self.bounds: list[tuple[int, int]] = []
        self._leaves: dict[str, dict] = {}
        self._arrays: dict[str, dict] = {}
        self._committed = False

    @property
    def scratch_dir(self) -> str:
        """Staging dir — solver scratch placed here rides the same
        filesystem as the shards and dies with ``abort``."""
        return self._tmp

    def _write_leaf(self, key: str, arr) -> None:
        meta = ckpt_io.write_leaves(self._step, {key: arr})[key]
        self._leaves[key] = meta
        self._arrays[key] = {"shape": list(arr.shape),
                             "dtype": meta["dtype"]}

    def append(self, W_block) -> int:
        """Write the next ``(p, width)`` weight column shard (numpy array
        or tensor); returns its index.  Blocks must arrive in target-column
        order.  A bf16 bundle rounds each shard to nearest even."""
        if self._committed:
            raise BundleError("BundleWriter already committed")
        if not isinstance(W_block, torch.Tensor):
            W_block = host_view(np.asarray(W_block))
        if W_block.ndim != 2 or W_block.shape[0] != self.p:
            raise BundleError(f"weight shard shape {tuple(W_block.shape)} "
                              f"does not match p={self.p}")
        lo = self.bounds[-1][1] if self.bounds else 0
        hi = lo + W_block.shape[1]
        if hi > self.t:
            raise BundleError(f"weight shards overflow the target axis: "
                              f"[{lo}, {hi}) beyond t={self.t}")
        i = len(self.bounds)
        self._write_leaf(f"W/{_shard_key(i)}", W_block.to(self._dtype))
        self.bounds.append((lo, hi))
        return i

    def commit(self, *, config, report, standardizer=None,
               lambda_by_target: np.ndarray | None = None,
               provenance: dict | None = None) -> str:
        """Write metadata + manifests and atomically publish the bundle.

        ``report`` is an ``EncodingReport`` (its ``weights`` may be — and
        at whole-brain scale should be — ``None``; the shards already on
        disk ARE the weights).  ``standardizer`` is an optional fitted
        ``pipeline.Standardizer``.
        """
        if self._committed:
            raise BundleError("BundleWriter already committed")
        if not self.bounds or self.bounds[-1][1] != self.t:
            got = self.bounds[-1][1] if self.bounds else 0
            raise BundleError(f"weight shards cover {got} of t={self.t} "
                              f"target columns — cannot commit")
        try:
            self._write_leaf(
                "best_lambda", np.asarray(report.best_lambda, np.float64))
            self._write_leaf(
                "cv_scores", np.asarray(report.cv_scores, np.float64))
            if lambda_by_target is not None:
                lam_t = np.asarray(lambda_by_target, np.float64)
                if lam_t.shape != (self.t,):
                    raise BundleError(f"lambda_by_target shape {lam_t.shape} "
                                      f"!= (t,)=({self.t},)")
                self._write_leaf("lambda_by_target", lam_t)
            if report.band_lambdas is not None:
                self._write_leaf(
                    "band_lambdas",
                    np.asarray(report.band_lambdas, np.float64))
            std_tree, std_flags = _standardizer_leaves(standardizer)
            for key, arr in std_tree.items():
                self._write_leaf(key, arr)
            ckpt_io.write_manifest(self._step, self._leaves)
            manifest = {
                "version": _BUNDLE_VERSION,
                "kind": "encoder_bundle",
                "p": self.p,
                "t": self.t,
                "weight_dtype": self.weight_dtype,
                "weight_shards": len(self.bounds),
                "weight_shard_bounds": [[lo, hi] for lo, hi in self.bounds],
                "standardizer": std_flags,
                "config": config_to_dict(config),
                "report": report.to_dict(),
                "arrays": self._arrays,
                "provenance": provenance or {},
            }
            with open(os.path.join(self._tmp, BUNDLE_MANIFEST), "w") as f:
                json.dump(manifest, f, indent=2)
                f.write("\n")
            if os.path.exists(self.bundle_dir) and not self.overwrite:
                raise BundleError(f"bundle already exists at "
                                  f"{self.bundle_dir}; pass overwrite=True "
                                  f"to replace it")
            ckpt_io.atomic_replace_dir(self._tmp, self.bundle_dir)
        except BaseException:
            shutil.rmtree(self._tmp, ignore_errors=True)
            raise
        self._committed = True
        return self.bundle_dir

    def abort(self) -> None:
        if not self._committed:
            shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "BundleWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.abort()


__all__ = ["BundleWriter"]
