"""EncoderBundle — the on-disk contract for a fitted ``BrainEncoder``.

Port of ``repro/serving_encoders/bundle.py``, byte-compatible with it in
both directions.  A bundle persists everything needed to predict without
refitting:

* the weight matrix ``W`` — column-sharded ``.npy`` leaves through
  ``checkpoint.io`` (bfloat16 stored as uint16 bit patterns, exactly like
  ``data.store.RunStore`` shards);
* the fitted per-column μ/σ ``Standardizer`` (when one was attached);
* the selected λ per target batch (plus the per-target expansion), the CV
  curve, and the swept grid;
* the full ``EncoderConfig`` and the ``DispatchDecision`` that fitted it.

Layout on disk::

    <dir>/bundle.json        # manifest: shapes, dtypes, config, decision,
                             #   per-leaf shape/dtype table, provenance
    <dir>/step_0/            # checkpoint.io leaf directory

The whole bundle is staged in a hidden directory and renamed into place,
and ``open()`` cross-checks every leaf's ``.npy`` header against the
manifest before any prediction (``BundleError``, a ``ValueError``).  Arrays
come back as numpy arrays, bf16 as their uint16 bit patterns; the encoder
``load_encoder`` builds holds them as tensors on its device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data.store import (_dtype_name, _read_npy_header,
                                    _storage_dtype, _torch_dtype)
from repro_torch.device import as_tensor, resolve_device
from repro_torch.encoding.config import EncoderConfig
from repro_torch.encoding.dispatch import DispatchDecision

BUNDLE_MANIFEST = "bundle.json"
_BUNDLE_VERSION = 1
_TUPLE_FIELDS = ("lambdas", "bands", "band_log_lambda_range")


class BundleError(ValueError):
    """Bundle inconsistency: missing/corrupt manifest, missing or
    mismatched leaf, unsupported version, or an unfit encoder."""


def config_to_dict(cfg: EncoderConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> EncoderConfig:
    kw = dict(d)
    for f in _TUPLE_FIELDS:
        if kw.get(f) is not None:
            kw[f] = tuple(kw[f])
    known = {f.name for f in dataclasses.fields(EncoderConfig)}
    unknown = set(kw) - known
    if unknown:
        raise BundleError(f"bundle config has unknown EncoderConfig "
                          f"field(s) {sorted(unknown)}")
    return EncoderConfig(**kw)


def _shard_key(i: int) -> str:
    return f"{i:03d}"


def _weight_shard_bounds(t: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous column blocks, as even as possible."""
    return [(t * i // n_shards, t * (i + 1) // n_shards)
            for i in range(n_shards)]


def _lambda_by_target(best_lambda: np.ndarray, t: int) -> np.ndarray | None:
    """Expand the per-batch λ to a (t,) per-target vector.

    Batches are contiguous equal column blocks of the (padded) target axis
    (Alg. 1 line 13 — one λ per target batch); reports with an empty
    ``best_lambda`` get no expansion.
    """
    b = np.asarray(best_lambda).ravel()
    if b.size == 0:
        return None
    per = -(-t // b.size)                      # ceil — padding-aware
    return np.repeat(b, per)[:t].astype(np.float64)


def _arrays_table(flat: dict, leaves: dict) -> dict:
    """The manifest's per-leaf ``{shape, dtype}`` table."""
    return {key: {"shape": list(flat[key].shape),
                  "dtype": leaves[key]["dtype"]} for key in leaves}


def _standardizer_leaves(std) -> tuple[dict, dict]:
    """The fitted μ/σ as f32 leaves, and the manifest's flags."""
    tree, flags = {}, {"x": False, "y": False}
    if std is None:
        return tree, flags
    for side in ("x", "y"):
        mu = getattr(std, f"mu_{side}")
        if mu is not None:
            flags[side] = True
            tree[f"mu_{side}"] = torch.as_tensor(mu).float()
            tree[f"sd_{side}"] = torch.as_tensor(
                getattr(std, f"sd_{side}")).float()
    return tree, flags


def save_bundle(bundle_dir: str, encoder, *, overwrite: bool = False,
                weight_shards: int | None = None,
                weight_dtype: str | torch.dtype | None = None,
                provenance: dict | None = None,
                weights: torch.Tensor | None = None) -> str:
    """Write a fitted ``BrainEncoder`` as an atomic bundle directory.

    ``weight_dtype`` casts ``W`` before writing (``"bfloat16"`` rounds to
    nearest even, halving a whole-brain bundle).  Predict parity is then
    defined against the *cast* weights.  ``weights`` (default
    ``encoder.report_.weights``) is the full (p, t) matrix, which a
    target-sharded encoder gathers first (``BrainEncoder.save``).
    """
    report = encoder.report_
    if report is None:
        raise BundleError("encoder is not fitted (report_ is None) — "
                          "call fit() before save()")
    # Refuse BEFORE staging: serializing a whole-brain W costs GBs of I/O
    # that a pre-existing bundle would throw away (re-checked before the
    # final swap in case the directory appears mid-save).
    if os.path.exists(bundle_dir) and not overwrite:
        raise BundleError(f"bundle already exists at {bundle_dir}; "
                          f"pass overwrite=True to replace it")
    W = torch.as_tensor(report.weights if weights is None
                        else weights).detach().cpu()
    if weight_dtype is not None:
        W = W.to(_torch_dtype(weight_dtype))
    p, t = W.shape
    n_shards = max(1, min(weight_shards or
                          max(1, report.decision.target_shards), t))
    bounds = _weight_shard_bounds(t, n_shards)

    tree: dict = {"W": {_shard_key(i): W[:, lo:hi]
                        for i, (lo, hi) in enumerate(bounds)}}
    tree["best_lambda"] = np.asarray(report.best_lambda, np.float64)
    tree["cv_scores"] = np.asarray(report.cv_scores, np.float64)
    lam_t = _lambda_by_target(report.best_lambda, t)
    if lam_t is not None:
        tree["lambda_by_target"] = lam_t
    if report.band_lambdas is not None:
        tree["band_lambdas"] = np.asarray(report.band_lambdas, np.float64)
    std_tree, std_flags = _standardizer_leaves(
        getattr(encoder, "standardizer_", None))
    tree.update(std_tree)
    flat = ckpt_io._flatten(tree)

    parent = os.path.dirname(os.path.abspath(bundle_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".tmpbundle_")
    try:
        step = os.path.join(tmp, "step_0")
        os.makedirs(step)
        leaves = ckpt_io.write_leaves(step, flat)
        ckpt_io.write_manifest(step, leaves)
        manifest = {
            "version": _BUNDLE_VERSION,
            "kind": "encoder_bundle",
            "p": int(p),
            "t": int(t),
            "weight_dtype": _dtype_name(W.dtype),
            "weight_shards": n_shards,
            "weight_shard_bounds": [[int(lo), int(hi)] for lo, hi in bounds],
            "standardizer": std_flags,
            "config": config_to_dict(encoder.config),
            # The dispatch decision lives ONCE, inside the report dict.
            "report": report.to_dict(),
            "arrays": _arrays_table(flat, leaves),
            "provenance": provenance or {},
        }
        with open(os.path.join(tmp, BUNDLE_MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
            f.write("\n")
        if os.path.exists(bundle_dir) and not overwrite:
            raise BundleError(f"bundle already exists at {bundle_dir}; "
                              f"pass overwrite=True to replace it")
        ckpt_io.atomic_replace_dir(tmp, bundle_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return bundle_dir


class EncoderBundle:
    """A validated, *unloaded* bundle: manifest in memory, arrays on disk.

    ``open()`` is cheap (headers only); ``load_encoder`` materialises the
    weights on a device.
    """

    def __init__(self, root: str, manifest: dict):
        self.root = root
        self.manifest = manifest
        self._leaf_table: dict | None = None

    # -- cheap metadata ------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        """(p, t) of the weight matrix."""
        return self.manifest["p"], self.manifest["t"]

    @property
    def weight_dtype(self) -> torch.dtype:
        return _torch_dtype(self.manifest["weight_dtype"])

    @property
    def has_standardizer(self) -> bool:
        f = self.manifest["standardizer"]
        return bool(f.get("x") or f.get("y"))

    def config(self) -> EncoderConfig:
        return config_from_dict(self.manifest["config"])

    def decision(self) -> DispatchDecision:
        return DispatchDecision(**self.manifest["report"]["decision"])

    def weight_nbytes(self) -> int:
        p, t = self.shape
        return p * t * self.weight_dtype.itemsize

    # -- construction --------------------------------------------------------
    @classmethod
    def open(cls, root: str) -> "EncoderBundle":
        """Open and eagerly validate (headers only, no array data)."""
        path = os.path.join(root, BUNDLE_MANIFEST)
        if not os.path.exists(path):
            raise BundleError(f"no {BUNDLE_MANIFEST} under {root}")
        try:
            with open(path) as f:
                m = json.load(f)
        except json.JSONDecodeError as e:
            raise BundleError(f"corrupt {BUNDLE_MANIFEST} under {root}: {e}")
        if m.get("kind") != "encoder_bundle":
            raise BundleError(f"{root} is not an encoder bundle "
                              f"(kind={m.get('kind')!r})")
        if m.get("version") != _BUNDLE_VERSION:
            raise BundleError(f"unsupported bundle version {m.get('version')}")
        bundle = cls(root, m)
        bundle._validate()
        return bundle

    def _validate(self) -> None:
        m = self.manifest
        try:
            leaves = self._leaves()
        except ckpt_io.CheckpointError as e:
            raise BundleError(f"bundle {self.root}: {e}")
        bounds = m["weight_shard_bounds"]
        if len(bounds) != m["weight_shards"]:
            raise BundleError(f"bundle {self.root}: weight_shard_bounds has "
                              f"{len(bounds)} entries != weight_shards="
                              f"{m['weight_shards']}")
        pos = 0
        for lo, hi in bounds:
            if lo != pos or hi < lo:
                raise BundleError(f"bundle {self.root}: weight shard bounds "
                                  f"{bounds} overlap or gap the target axis")
            pos = hi
        if pos != m["t"]:
            raise BundleError(f"bundle {self.root}: weight shards cover "
                              f"{pos} target columns, manifest says {m['t']}")
        for i in range(m["weight_shards"]):
            key = f"W/{_shard_key(i)}"
            if key not in m["arrays"]:
                raise BundleError(f"bundle {self.root}: weight shard {key} "
                                  f"missing from the arrays table")
        for key, meta in m["arrays"].items():
            if key not in leaves:
                raise BundleError(
                    f"bundle {self.root}: leaf {key!r} in {BUNDLE_MANIFEST} "
                    f"but absent from the checkpoint manifest")
            npy = os.path.join(self.root, "step_0", leaves[key]["file"])
            if not os.path.exists(npy):
                raise BundleError(f"bundle {self.root}: leaf {key!r} shard "
                                  f"{os.path.basename(npy)} is missing")
            shape, dtype = _read_npy_header(npy)
            want_shape = tuple(meta["shape"])
            want_store = _storage_dtype(_torch_dtype(meta["dtype"]))
            if shape != want_shape:
                raise BundleError(
                    f"bundle {self.root}: leaf {key!r} shape {shape} != "
                    f"manifest {want_shape}")
            if dtype != want_store:
                raise BundleError(
                    f"bundle {self.root}: leaf {key!r} dtype {dtype} != "
                    f"manifest storage dtype {want_store}")

    # -- materialisation -----------------------------------------------------
    def _leaves(self) -> dict:
        """Cached checkpoint-manifest leaf table (one json read)."""
        if self._leaf_table is None:
            self._leaf_table = ckpt_io._read_manifest(
                os.path.join(self.root, "step_0"))["leaves"]
        return self._leaf_table

    def load_arrays(self, keys: list[str] | None = None, *,
                    mmap: bool = False) -> dict[str, np.ndarray]:
        """Load checkpoint leaves — all of them, or just ``keys``
        (``mmap=True``: read-only memmap views).  bf16 leaves come back as
        uint16 bit patterns."""
        leaves = self._leaves()
        if keys is None:
            keys = list(leaves)
        else:
            missing = [k for k in keys if k not in leaves]
            if missing:
                raise BundleError(f"bundle {self.root}: requested leaf/leaves "
                                  f"{missing} not in the checkpoint manifest")
        src = os.path.join(self.root, "step_0")
        return {k: ckpt_io._load_leaf(src, k, leaves[k], mmap=mmap)
                for k in keys}

    def weight_shard_bounds(self) -> list[tuple[int, int]]:
        return [(int(lo), int(hi))
                for lo, hi in self.manifest["weight_shard_bounds"]]

    def shards_for_columns(self, lo: int, hi: int) -> list[int]:
        """Indices of the weight shards overlapping columns ``[lo, hi)``."""
        p, t = self.shape
        if not (0 <= lo <= hi <= t):
            raise BundleError(f"bundle {self.root}: column window "
                              f"[{lo}, {hi}) outside [0, {t})")
        return [i for i, (slo, shi) in enumerate(self.weight_shard_bounds())
                if slo < hi and lo < shi]

    def load_weight_shard(self, i: int, *, mmap: bool = False) -> np.ndarray:
        """Load ONE ``(p, width)`` weight column shard (``mmap=True``: a
        read-only view that faults in only the pages read)."""
        m = self.manifest
        if not (0 <= i < m["weight_shards"]):
            raise BundleError(f"bundle {self.root}: weight shard {i} out of "
                              f"range [0, {m['weight_shards']})")
        key = f"W/{_shard_key(i)}"
        return ckpt_io._load_leaf(os.path.join(self.root, "step_0"), key,
                                  self._leaves()[key], mmap=mmap)

    def load_standardizer(self, arrays: dict[str, np.ndarray],
                          device: torch.device | str | None = None):
        """The fitted ``Standardizer`` (tensors on ``device``, CUDA unless
        ``device="cpu"``), or ``None`` when the bundle has none."""
        from repro_torch.encoding.pipeline import Standardizer

        if not self.has_standardizer:
            return None
        dev = resolve_device(device)
        flags = self.manifest["standardizer"]
        std = Standardizer()
        for side in ("x", "y"):
            if flags.get(side):
                setattr(std, f"mu_{side}", as_tensor(arrays[f"mu_{side}"],
                                                     dev))
                setattr(std, f"sd_{side}", as_tensor(arrays[f"sd_{side}"],
                                                     dev))
        return std

    def load_encoder(self, *, target_shards: int | None = None,
                     mmap: bool = False,
                     device: torch.device | str | None = None):
        """Materialise a fitted ``BrainEncoder`` (no refit) on ``device``
        (CUDA unless ``device="cpu"``).  ``mmap=True`` reads the weight
        shards through read-only memmaps.

        ``target_shards`` > 1 is the serving layout over the ranks of
        ``torch.distributed``: a ``(1, target_shards)`` mesh (every rank
        calls ``load_encoder``), each rank holding its column block of
        ``W`` on its device; ``predict`` computes the local block and
        gathers the columns.  ``t`` must divide evenly and the world must
        have the ranks."""
        from repro_torch.core import compat
        from repro_torch.encoding.estimator import BrainEncoder, EncodingReport
        from repro_torch.encoding.sharding import ShardingPlan

        dev = resolve_device(device)
        m = self.manifest
        cfg = self.config()
        arrays = self.load_arrays(
            [k for k in self._leaves() if not k.startswith("W/")])
        shard = None
        cols = (0, self.shape[1])
        if target_shards is not None and target_shards > 1:
            p, t = self.shape
            if t % target_shards:
                raise BundleError(
                    f"t={t} targets do not divide over target_shards="
                    f"{target_shards} for sharded load")
            if target_shards > compat.device_count():
                raise BundleError(
                    f"sharded load wants {target_shards} devices, have "
                    f"{compat.device_count()}")
            plan = ShardingPlan(data_shards=1, target_shards=target_shards,
                                data_axis=cfg.data_axis,
                                target_axis=cfg.target_axis)
            mesh = plan.build_mesh(dev)
            shard = (mesh, plan.target_axis)
            cols = plan.col_window(mesh, t)
        lo, hi = cols
        blocks = [self.load_weight_shard(i, mmap=mmap)[
                      :, max(lo, slo) - slo:min(hi, shi) - slo]
                  for i, (slo, shi) in enumerate(self.weight_shard_bounds())
                  if slo < hi and lo < shi]
        W = blocks[0] if len(blocks) == 1 else np.concatenate(blocks, axis=1)
        enc = BrainEncoder(cfg, device=dev)
        band = arrays.get("band_lambdas")
        enc.report_ = EncodingReport(
            weights=as_tensor(np.ascontiguousarray(W), dev),
            best_lambda=np.asarray(arrays["best_lambda"]),
            cv_scores=np.asarray(arrays["cv_scores"]),
            lambdas=tuple(m["report"]["lambdas"]),
            decision=self.decision(),
            band_lambdas=None if band is None else np.asarray(band))
        enc.target_shard_ = shard
        enc.standardizer_ = self.load_standardizer(arrays, dev)
        return enc


__all__ = ["BundleError", "EncoderBundle", "save_bundle", "BUNDLE_MANIFEST",
           "config_to_dict", "config_from_dict"]
