"""Crash-consistent progress ledger for the column-blocked whole-brain fit.

Port of ``repro/resilience/journal.py``; the directory layout
(``ledger.json``, ``xstats.{G,xsum,count}.npy``,
``block_{bi:05d}.{scores,ahat,curve,W}.npy``) and the ledger's keys are the
reference's byte for byte, so a journal either package wrote attaches in
the other.

A :class:`FitJournal` lives in its own directory next to the
``BundleWriter`` staging dir (``<bundle>.journal`` by convention) and
records, durably, everything ``fit_wholebrain`` would otherwise lose to
a crash:

* the fused X-stats pass (``G``/``xsum``/``count`` of the k-fold
  ``FoldStats`` — the inputs of the hoisted eighs, which are themselves
  recomputed on resume, never persisted), and
* each completed column block: its float64 per-fold validation-score
  contribution, plus the block's ``Â`` projection (global-λ mode) or its
  chosen λ, CV curve, and solved weight shard (per-block mode).

Write protocol (crash-consistent by construction):

1. array payloads land as ``<name>.tmp-<pid>`` then ``os.replace`` —
   a reader never sees a torn ``.npy``;
2. the ``ledger.json`` index is rewritten the same way, LAST — a block
   exists exactly when the ledger lists it.  A crash between (1) and (2)
   leaves an orphaned payload that the next attach sweeps
   (:func:`repro_torch.resilience.cleanup.reap_stale_staging`).

Bit-identity: the journal stores the exact arrays the live fit produced
(f32 statistics, f64 score contributions), and the resuming fit *replays*
them — adds the same f64 addends in the same block order, writes the same
f32 ``Â`` bytes into the scratch — so λ and W of a resumed fit are
bitwise equal to an uninterrupted run's.  The ledger's ``signature``
pins every input that shapes those bytes (shape, folds, blocking, λ
grid, scoring, chunking); attaching with a different signature raises
:class:`JournalError` rather than resuming into silent garbage.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from repro_torch import obs
from repro_torch.resilience import cleanup

__all__ = ["FitJournal", "JournalError", "LEDGER_NAME"]

LEDGER_NAME = "ledger.json"
_VERSION = 1


class JournalError(RuntimeError):
    """Unusable journal: signature mismatch or corrupt ledger."""


def _atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_save_array(path: str, arr: np.ndarray) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class FitJournal:
    """Progress ledger of one ``fit_wholebrain`` invocation.

    ``attach`` is the one constructor: it creates the directory on first
    use, reap-sweeps stale ``*.tmp-*`` payloads from a previous crash,
    and validates the signature when a ledger already exists.
    """

    def __init__(self, root: str, signature: dict, ledger: dict):
        self.root = root
        self.signature = signature
        self._ledger = ledger

    # -- construction --------------------------------------------------------
    @classmethod
    def attach(cls, root: str, signature: dict) -> "FitJournal":
        os.makedirs(root, exist_ok=True)
        # Torn payloads from a crashed writer are garbage immediately —
        # nothing else writes here, so no age gate.
        cleanup.reap_stale_staging(root, max_age_s=0.0,
                                   patterns=("*.tmp-*",))
        path = os.path.join(root, LEDGER_NAME)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    ledger = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                raise JournalError(f"corrupt journal ledger {path}: {e}")
            if ledger.get("version") != _VERSION:
                raise JournalError(
                    f"journal version {ledger.get('version')} != {_VERSION}")
            if ledger.get("signature") != signature:
                raise JournalError(
                    f"journal at {root} was written by a different fit "
                    f"configuration; delete it or pass a fresh journal dir "
                    f"(journal {ledger.get('signature')} != fit {signature})")
            obs.instant("journal.resume", root=root,
                        blocks=len(ledger.get("blocks", {})))
        else:
            ledger = {"version": _VERSION, "signature": signature,
                      "xstats": False, "blocks": {}}
        j = cls(root, signature, ledger)
        if not os.path.exists(path):
            j._flush()
        return j

    def _flush(self) -> None:
        data = (json.dumps(self._ledger, indent=1) + "\n").encode()
        _atomic_write_bytes(os.path.join(self.root, LEDGER_NAME), data)

    # -- X statistics --------------------------------------------------------
    @property
    def has_xstats(self) -> bool:
        return bool(self._ledger["xstats"])

    def put_xstats(self, G: np.ndarray, xsum: np.ndarray,
                   count: np.ndarray) -> None:
        for name, arr in (("G", G), ("xsum", xsum), ("count", count)):
            _atomic_save_array(os.path.join(self.root, f"xstats.{name}.npy"),
                               np.asarray(arr))
        self._ledger["xstats"] = True
        self._flush()

    def load_xstats(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self.has_xstats:
            raise JournalError("journal has no X statistics yet")
        return tuple(np.load(os.path.join(self.root, f"xstats.{n}.npy"))
                     for n in ("G", "xsum", "count"))

    # -- column blocks -------------------------------------------------------
    def completed_blocks(self) -> set[int]:
        return {int(b) for b in self._ledger["blocks"]}

    def has_block(self, bi: int) -> bool:
        return str(bi) in self._ledger["blocks"]

    def put_block(self, bi: int, *, scores: np.ndarray | None = None,
                  ahat: np.ndarray | None = None,
                  lam: float | None = None,
                  curve: np.ndarray | None = None,
                  W: np.ndarray | None = None) -> None:
        """Record block ``bi`` as complete; payloads land before the ledger."""
        rec: dict = {}
        for name, arr in (("scores", scores), ("ahat", ahat),
                          ("curve", curve), ("W", W)):
            if arr is not None:
                fname = f"block_{bi:05d}.{name}.npy"
                _atomic_save_array(os.path.join(self.root, fname),
                                   np.asarray(arr))
                rec[name] = fname
        if lam is not None:
            rec["lam"] = float(lam)
        self._ledger["blocks"][str(bi)] = rec
        self._flush()
        obs.instant("journal.block", block=bi)

    def load_block(self, bi: int) -> dict:
        """Block record with array fields loaded (keys as written)."""
        rec = self._ledger["blocks"].get(str(bi))
        if rec is None:
            raise JournalError(f"block {bi} is not journaled")
        out: dict = {}
        for name, val in rec.items():
            if name == "lam":
                out["lam"] = float(val)
            else:
                out[name] = np.load(os.path.join(self.root, val))
        return out

    # -- lifecycle -----------------------------------------------------------
    def finish(self) -> None:
        """Delete the journal after the fit committed its result."""
        import shutil
        shutil.rmtree(self.root, ignore_errors=True)
        obs.instant("journal.finish", root=self.root)

    @staticmethod
    def default_dir(bundle_dir: str | None) -> str:
        """Conventional journal location for a bundle-producing fit."""
        if bundle_dir:
            return os.path.abspath(bundle_dir).rstrip(os.sep) + ".journal"
        return tempfile.mkdtemp(prefix="wholebrain_journal_")
