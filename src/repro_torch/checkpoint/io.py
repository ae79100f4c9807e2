"""Minimal, dependency-free checkpointing of nested dicts of arrays.

Port of ``repro/checkpoint/io.py``, byte-compatible with it: the layout is
``<dir>/step_<n>/`` with one ``.npy`` per leaf (named by the flattened key
path, '/'-joined, '/' → '__' in the file name) plus ``manifest.json``
recording each leaf's file and dtype.  Atomic via write-to-tmp + rename.
bfloat16 leaves are stored as uint16 bit patterns with the true dtype in
the manifest (npy has no bf16).

The tree is a nested dict whose leaves are numpy arrays, tensors or
scalars; keys flatten in sorted order, as JAX flattens a dict.  The
manifest's ``treedef`` string is provenance only — ``load`` never parses
it — so the port writes its own description of the tree, and reads
checkpoints whose manifest carries JAX's.  On load, bfloat16 leaves come
back as their uint16 bit patterns (numpy has no bfloat16, and the port
does not depend on ``ml_dtypes``); ``device.host_view``/``as_tensor`` view
them as ``torch.bfloat16``.

``restore`` reads a checkpoint back into the structure of a template
tree (the training driver's ``{"params", "opt"}`` state) on a device.

Errors are typed: a missing/corrupt manifest, a leaf recorded in the
manifest whose ``.npy`` is gone, a requested leaf the manifest never
recorded, or a stored shape that is not the template's all raise
``CheckpointError`` (a ``ValueError``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.data.store import _dtype_name, _to_storage
from repro_torch.device import host_view, resolve_device


class CheckpointError(ValueError):
    """Checkpoint inconsistency: missing/corrupt manifest, missing leaf
    file, a leaf absent from the manifest, or a shape mismatch on
    restore."""


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{'/'-joined key path: leaf}`` of a nested dict, keys sorted."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key in sorted(tree, key=str):
        out.update(_flatten(tree[key], f"{prefix}/{key}" if prefix
                            else str(key)))
    return out


def _treedef(keys) -> str:
    """Provenance string of the tree's structure (never parsed)."""
    return "flat dict: " + ", ".join(keys)


def _storage(leaf) -> tuple[np.ndarray, str]:
    """A leaf as its on-disk array and the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        return _to_storage(leaf, leaf.dtype), _dtype_name(leaf.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


def atomic_replace_dir(tmp: str, target: str) -> None:
    """Crash-safely swap a fully-written ``tmp`` directory into ``target``.

    If ``target`` exists it is renamed aside first and deleted only after
    the swap, so a failure at any point leaves one complete directory:
    either the old content (restored on exception) or the new.  On
    failure ``tmp`` is cleaned up and the exception re-raised.
    """
    parent = os.path.dirname(os.path.abspath(target)) or "."
    old = None
    try:
        if os.path.exists(target):
            old = tempfile.mkdtemp(dir=parent, prefix=".old_")
            os.rename(target, os.path.join(old, "d"))
        os.rename(tmp, target)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        if old is not None:
            moved = os.path.join(old, "d")
            if not os.path.exists(target) and os.path.exists(moved):
                os.rename(moved, target)                 # restore old
            if not os.path.exists(moved):                # payload safe →
                shutil.rmtree(old, ignore_errors=True)   # drop aside dir
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def write_leaves(dest: str, flat: dict[str, Any]) -> dict[str, dict]:
    """Write each leaf of ``flat`` as ``.npy`` under ``dest``; returns the
    manifest's leaf table ``{key: {"file", "dtype"}}``."""
    leaves = {}
    for key, leaf in flat.items():
        arr, dtype_name = _storage(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(dest, fname), arr)
        leaves[key] = {"file": fname, "dtype": dtype_name}
    return leaves


def write_manifest(dest: str, leaves: dict[str, dict]) -> None:
    with open(os.path.join(dest, "manifest.json"), "w") as f:
        json.dump({"treedef": _treedef(leaves), "leaves": leaves}, f,
                  indent=1)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    target = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        write_manifest(tmp, write_leaves(tmp, _flatten(tree)))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    atomic_replace_dir(tmp, target)
    return target


def _read_manifest(src: str) -> dict:
    path = os.path.join(src, "manifest.json")
    if not os.path.exists(path):
        raise CheckpointError(f"no manifest.json under {src}")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointError(f"corrupt manifest.json under {src}: {e}")
    if not isinstance(manifest.get("leaves"), dict):
        raise CheckpointError(f"manifest.json under {src} has no 'leaves'")
    return manifest


def _load_leaf(src: str, key: str, meta: dict, *,
               mmap: bool = False) -> np.ndarray:
    path = os.path.join(src, meta["file"])
    if not os.path.exists(path):
        raise CheckpointError(
            f"leaf {key!r}: manifest records {meta['file']} but the file "
            f"is missing under {src}")
    return np.load(path, mmap_mode="r" if mmap else None)


def load_leaf(ckpt_dir: str, step: int, key: str, *,
              mmap: bool = False) -> np.ndarray:
    """Load ONE leaf by its flattened key path.

    ``mmap=True`` returns a read-only memmap view — nothing is paged in
    until the caller touches it, so a consumer that needs one column
    shard of a whole-brain weight matrix never faults in the rest.
    """
    src = os.path.join(ckpt_dir, f"step_{step}")
    manifest = _read_manifest(src)
    if key not in manifest["leaves"]:
        raise CheckpointError(
            f"leaf {key!r} is not recorded in the manifest under {src}")
    return _load_leaf(src, key, manifest["leaves"][key], mmap=mmap)


def load(ckpt_dir: str, step: int) -> dict[str, np.ndarray]:
    """Load every leaf of a checkpoint as a flat ``{path: array}`` dict,
    driven by the manifest alone (bf16 leaves as uint16 bit patterns)."""
    src = os.path.join(ckpt_dir, f"step_{step}")
    manifest = _read_manifest(src)
    return {key: _load_leaf(src, key, meta)
            for key, meta in manifest["leaves"].items()}


def restore(ckpt_dir: str, step: int, like: Any, *,
            device: torch.device | str | None = None) -> Any:
    """Restore into the structure of ``like`` (a nested dict of tensors or
    arrays, e.g. a ``{"params", "opt"}`` train state): every leaf ``like``
    has must be stored with ``like``'s shape, and comes back as a tensor
    of its stored dtype on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    src = os.path.join(ckpt_dir, f"step_{step}")
    manifest = _read_manifest(src)
    flat_like = _flatten(like)
    missing = sorted(set(flat_like) - set(manifest["leaves"]))
    if missing:
        raise CheckpointError(
            f"checkpoint {src} is missing {len(missing)} leave(s) that the "
            f"restore template requires: {missing[:5]}"
            + (" ..." if len(missing) > 5 else ""))
    restored = {}
    for key, ref in flat_like.items():
        meta = manifest["leaves"][key]
        arr = _load_leaf(src, key, meta)
        if tuple(arr.shape) != tuple(ref.shape):
            raise CheckpointError(
                f"leaf {key!r}: stored shape {tuple(arr.shape)} != template "
                f"shape {tuple(ref.shape)}")
        t = host_view(arr) if meta["dtype"] == "bfloat16" else \
            torch.from_numpy(arr)
        restored[key] = t.to(dev)
    return _unflatten(like, restored)


def _unflatten(like: Any, flat: dict[str, Any], prefix: str = "") -> Any:
    """``like``'s nested dicts with the leaves of ``flat`` (the inverse of
    ``_flatten``)."""
    if not isinstance(like, dict):
        return flat[prefix]
    return {key: _unflatten(like[key], flat,
                            f"{prefix}/{key}" if prefix else str(key))
            for key in like}


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


__all__ = ["CheckpointError", "atomic_replace_dir", "latest_step", "load",
           "load_leaf", "restore", "save"]
