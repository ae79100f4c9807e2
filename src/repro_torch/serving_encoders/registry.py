"""EncoderRegistry — many bundles, bounded device memory, LRU residency.

Port of ``repro/serving_encoders/registry.py``.  The registry holds every
bundle's *manifest* (``EncoderBundle.open`` reads headers only) and
materialises tensors on its device lazily on ``get``, evicting
least-recently-used entries whenever the resident-bytes account would
exceed ``device_memory_budget``.

The account is the reference's: serving a wave of ``wave_rows`` rows holds
``wave_rows·(p + t_shard)`` floats next to the ``p·t`` weight matrix
(``dispatch.estimated_resident_bytes`` at ``n = wave_rows``); mixed
(scored) waves add ``dispatch.mixed_wave_scoring_bytes``.  All bookkeeping
runs under one reentrant lock, so service threads can share a registry
without the account drifting past the budget; the high-water mark is
``peak_resident_bytes``.  Weight shards are read through read-only mmap
(``mmap_weights=True``), so processes pointed at one artifact directory
share the OS page cache.  A fault while materialising a bundle (truncated
shard, flipped checkpoint manifest, vanished leaf) surfaces as a typed
``BundleError``, retried first under ``fault_policy`` when one is given.

Every hit, cold load and eviction also bumps the ``repro_torch.obs``
counters ``registry_hits`` / ``registry_loads`` / ``registry_evictions``
(beside the int attributes ``hits``, ``loads``, ``evictions``,
``shard_hits``, ``shard_loads``); loads run under a ``registry.load`` span
and hits and evictions are ``registry.hit`` / ``registry.evict`` instants.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.device import as_tensor, resolve_device
from repro_torch.encoding.dispatch import (
    estimated_resident_bytes, mixed_wave_scoring_bytes,
)
from repro_torch.resilience.policy import FaultPolicy, retry_call
from repro_torch.serving_encoders.bundle import BundleError, EncoderBundle


class RegistryError(ValueError):
    """Unknown model name, duplicate registration, or a bundle whose
    resident estimate alone exceeds the registry's memory budget."""


def bundle_resident_bytes(bundle: EncoderBundle, wave_rows: int,
                          target_shards: int | None = None,
                          score_slots: int = 0) -> int:
    """Device bytes one loaded bundle pins while serving ``wave_rows``
    waves: the weight matrix, the four μ/σ vectors (identity vectors for a
    standardizer-less bundle) and the per-wave activation working set,
    plus the mixed-wave scoring extras when ``score_slots`` > 0."""
    p, t = bundle.shape
    std = 2 * (p + t) * 4
    act = estimated_resident_bytes(wave_rows, p, t,
                                   target_shards=target_shards or 1)
    act += mixed_wave_scoring_bytes(wave_rows, t, score_slots)
    return bundle.weight_nbytes() + std + act


@dataclasses.dataclass
class LoadedEncoder:
    """A resident registry entry: the encoder plus serving-ready tensors
    (identity μ/σ when the bundle has no standardizer, so every bundle is
    served by the same program)."""

    name: str
    bundle: EncoderBundle
    encoder: "object"
    resident_bytes: int
    charged_wave_rows: int  # wave size the resident_bytes account assumed
    charged_score_slots: int  # mixed-wave slot count the account assumed
    mu_x: torch.Tensor      # (p,)
    sd_x: torch.Tensor
    mu_y: torch.Tensor      # (t,)
    sd_y: torch.Tensor
    load_seconds: float

    @property
    def weights(self) -> torch.Tensor:
        return self.encoder.weights_


@dataclasses.dataclass
class LoadedShard:
    """A resident weight COLUMN shard (the whole-brain serving granule):
    one ``(p, width)`` column window plus its μ/σ slice, paged in and
    evicted on its own."""

    name: str
    shard: int
    bounds: tuple[int, int]  # [lo, hi) target columns of the bundle
    W: torch.Tensor          # (p, width)
    mu_x: torch.Tensor       # (p,)
    sd_x: torch.Tensor
    mu_y: torch.Tensor       # (width,) — the shard's slice
    sd_y: torch.Tensor
    resident_bytes: int
    charged_wave_rows: int
    load_seconds: float


def shard_resident_bytes(bundle: EncoderBundle, width: int, wave_rows: int
                         ) -> int:
    """Device bytes one column shard pins while serving ``wave_rows``
    waves: its weight slice, μ/σ (the x vectors plus the shard's y slice)
    and the windowed activation working set."""
    p, _ = bundle.shape
    w_bytes = p * width * bundle.weight_dtype.itemsize
    std = (2 * p + 2 * width) * 4
    return w_bytes + std + estimated_resident_bytes(wave_rows, p, width)


def _serving_arrays(encoder, p: int, t: int, device: torch.device
                    ) -> tuple[torch.Tensor, ...]:
    """``(mu_x, sd_x, mu_y, sd_y)`` f32 on ``device``; identity where the
    encoder's standardizer leaves a side raw."""
    f32 = dict(dtype=torch.float32, device=device)
    mu_x, sd_x = torch.zeros(p, **f32), torch.ones(p, **f32)
    mu_y, sd_y = torch.zeros(t, **f32), torch.ones(t, **f32)
    std = encoder.standardizer_
    if std is not None:
        if std.mu_x is not None:
            mu_x = torch.as_tensor(std.mu_x).to(**f32)
            sd_x = torch.as_tensor(std.sd_x).to(**f32)
        if std.mu_y is not None:
            mu_y = torch.as_tensor(std.mu_y).to(**f32)
            sd_y = torch.as_tensor(std.sd_y).to(**f32)
    return mu_x, sd_x, mu_y, sd_y


class EncoderRegistry:
    """Lazy-loading, budget-bounded collection of encoder bundles on one
    device (CUDA unless ``device="cpu"``).

    >>> reg = EncoderRegistry(device_memory_budget=256 * 2**20)
    >>> reg.add("sub-01/L12", "/bundles/sub-01_L12")
    >>> entry = reg.get("sub-01/L12")     # loads; LRU-evicts if over budget

    ``get`` on a resident entry is a hit (moves it to most-recently-used);
    a miss loads the bundle, first evicting LRU entries until the new
    resident total fits the budget.  A single bundle that cannot fit at
    all raises ``RegistryError`` instead of thrashing.  ``target_shards``
    > 1 loads every bundle column-sharded over a ``(1, target_shards)``
    mesh of the ranks of ``torch.distributed`` (every rank constructs the
    registry and makes the same calls), each rank charging the
    reference's per-device account
    (``bundle_resident_bytes(..., target_shards)``).
    """

    def __init__(self, *, device_memory_budget: int | None = None,
                 wave_rows: int = 128, target_shards: int | None = None,
                 mmap_weights: bool = True,
                 fault_policy: FaultPolicy | None = None,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.device_memory_budget = device_memory_budget
        self.wave_rows = wave_rows
        self.target_shards = target_shards
        self.mmap_weights = mmap_weights
        #: transient-fault retry for bundle/shard materialisation;
        #: exhausted retries still raise the typed ``BundleError``.
        self.fault_policy = fault_policy
        self._bundles: dict[str, EncoderBundle] = {}
        self._loaded: "OrderedDict[str, LoadedEncoder]" = OrderedDict()
        # Shard-granular residency pool (whole-brain serving): keyed by
        # (model, shard index), LRU-ordered, charged against the SAME
        # budget as the full-bundle pool.
        self._shards: "OrderedDict[tuple[str, int], LoadedShard]" \
            = OrderedDict()
        self._std_host: dict[str, tuple] = {}   # host μ/σ cache per model
        # ONE lock over all bookkeeping; reentrant because get_columns'
        # load path nests _std_host_arrays and _evict_until_fits.
        self._lock = threading.RLock()
        self.hits = 0
        self.loads = 0
        self.evictions = 0
        self.shard_hits = 0
        self.shard_loads = 0
        self.peak_resident_bytes = 0
        m = obs.get_metrics()
        self._m_hits = m.counter("registry_hits")
        self._m_loads = m.counter("registry_loads")
        self._m_evictions = m.counter("registry_evictions")

    # -- registration --------------------------------------------------------
    def add(self, name: str, path: str) -> EncoderBundle:
        """Register a bundle directory (opened + validated eagerly, arrays
        stay on disk)."""
        with self._lock:
            if name in self._bundles:
                raise RegistryError(f"model {name!r} already registered")
            bundle = EncoderBundle.open(path)
            self._bundles[name] = bundle
            return bundle

    def bundle(self, name: str) -> EncoderBundle:
        """Manifest-only access — no array load, no LRU touch."""
        if name not in self._bundles:
            raise RegistryError(f"unknown model {name!r}; registered: "
                                f"{sorted(self._bundles)}")
        return self._bundles[name]

    def ensure_servable(self, name: str, wave_rows: int | None = None,
                        score_slots: int = 0) -> None:
        """Raise ``RegistryError`` NOW if ``name`` could never be served at
        this wave size (its lone resident estimate exceeds the budget).
        Manifest-only."""
        need = bundle_resident_bytes(self.bundle(name),
                                     max(self.wave_rows, wave_rows or 0),
                                     self.target_shards, score_slots)
        budget = self.device_memory_budget
        if budget is not None and need > budget:
            raise RegistryError(
                f"bundle {name!r} needs {need / 2**20:.1f} MB resident at "
                f"wave size {max(self.wave_rows, wave_rows or 0)}, over "
                f"the registry budget {budget / 2**20:.1f} MB")

    def __len__(self) -> int:
        return len(self._bundles)

    def __contains__(self, name: str) -> bool:
        return name in self._bundles

    @property
    def names(self) -> list[str]:
        return list(self._bundles)

    @property
    def loaded_names(self) -> list[str]:
        """LRU → MRU order."""
        return list(self._loaded)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return (sum(e.resident_bytes for e in self._loaded.values())
                    + sum(e.resident_bytes for e in self._shards.values()))

    @property
    def loaded_shards(self) -> list[tuple[str, int]]:
        """LRU → MRU order of the resident column shards."""
        return list(self._shards)

    # -- residency -----------------------------------------------------------
    def get(self, name: str, *, wave_rows: int | None = None,
            score_slots: int = 0) -> LoadedEncoder:
        """Resident entry for ``name`` (loading + LRU-evicting as needed).

        ``wave_rows``/``score_slots`` are what the caller is about to serve
        with; the larger of them and the registry's default is charged, and
        a resident entry is re-charged when a caller flies bigger waves.
        Thread-safe.  A fault while materialising the bundle raises a
        typed ``BundleError`` and leaves the registry state untouched.
        """
        with self._lock:
            if name not in self._bundles:
                raise RegistryError(f"unknown model {name!r}; registered: "
                                    f"{sorted(self._bundles)}")
            eff_wave = max(self.wave_rows, wave_rows or 0)
            budget = self.device_memory_budget
            if name in self._loaded:
                self.hits += 1
                self._m_hits.inc()
                obs.instant("registry.hit", model=name)
                entry = self._loaded[name]
                self._loaded.move_to_end(name)
                if eff_wave > entry.charged_wave_rows \
                        or score_slots > entry.charged_score_slots:
                    # Bigger waves against a resident entry pin a bigger
                    # activation set: re-charge and make room, refusing an
                    # unservable size without flushing the other residents.
                    eff_wave = max(eff_wave, entry.charged_wave_rows)
                    slots = max(score_slots, entry.charged_score_slots)
                    new_need = bundle_resident_bytes(
                        entry.bundle, eff_wave, self.target_shards, slots)
                    if budget is not None and new_need > budget:
                        raise RegistryError(
                            f"bundle {name!r} needs {new_need / 2**20:.1f} "
                            f"MB resident at wave size {eff_wave}, over "
                            f"the registry budget {budget / 2**20:.1f} MB")
                    entry.resident_bytes = new_need
                    entry.charged_wave_rows = eff_wave
                    entry.charged_score_slots = slots
                    self._evict_until_fits(extra_need=0, keep=name)
                    self._note_peak()
                return entry
            bundle = self._bundles[name]
            need = bundle_resident_bytes(bundle, eff_wave,
                                         self.target_shards, score_slots)
            if budget is not None and need > budget:
                raise RegistryError(
                    f"bundle {name!r} needs {need / 2**20:.1f} MB "
                    f"resident, over the registry budget "
                    f"{budget / 2**20:.1f} MB — raise the budget or shard "
                    f"the targets")
            # Evict BEFORE loading so the peak never exceeds budget.
            self._evict_until_fits(extra_need=need)
            t0 = time.perf_counter()
            with obs.span("registry.load", model=name, bytes=need):
                try:
                    encoder = retry_call(
                        lambda: bundle.load_encoder(
                            target_shards=self.target_shards,
                            mmap=self.mmap_weights, device=self.device),
                        self.fault_policy, "registry.load_encoder")
                except BundleError:
                    raise
                except (ckpt_io.CheckpointError, OSError, ValueError) as e:
                    # Whatever the disk path throws mid-materialisation
                    # becomes the typed fault the service degrades on; no
                    # partial entry is ever inserted.
                    raise BundleError(
                        f"bundle {name!r} failed to materialise: {e}") from e
                p, t = bundle.shape
                mu_x, sd_x, mu_y, sd_y = _serving_arrays(encoder, p, t,
                                                         self.device)
            entry = LoadedEncoder(
                name=name, bundle=bundle, encoder=encoder,
                resident_bytes=need, charged_wave_rows=eff_wave,
                charged_score_slots=score_slots,
                mu_x=mu_x, sd_x=sd_x, mu_y=mu_y, sd_y=sd_y,
                load_seconds=time.perf_counter() - t0)
            self._loaded[name] = entry
            self.loads += 1
            self._m_loads.inc()
            self._note_peak()
            return entry

    def _note_peak(self) -> None:
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.resident_bytes)

    # -- shard-granular residency (whole-brain serving) ----------------------
    def _std_host_arrays(self, name: str) -> tuple:
        """Host μ/σ of a bundle, read once per model, so windowed gets never
        re-read the standardizer leaves per shard."""
        cached = self._std_host.get(name)
        if cached is None:
            bundle = self.bundle(name)
            p, t = bundle.shape
            mu_x = np.zeros((p,), np.float32)
            sd_x = np.ones((p,), np.float32)
            mu_y = np.zeros((t,), np.float32)
            sd_y = np.ones((t,), np.float32)
            flags = bundle.manifest["standardizer"]
            keys = (["mu_x", "sd_x"] if flags.get("x") else []) + \
                   (["mu_y", "sd_y"] if flags.get("y") else [])
            if keys:
                arrays = bundle.load_arrays(keys)
                if flags.get("x"):
                    mu_x = np.asarray(arrays["mu_x"], np.float32)
                    sd_x = np.asarray(arrays["sd_x"], np.float32)
                if flags.get("y"):
                    mu_y = np.asarray(arrays["mu_y"], np.float32)
                    sd_y = np.asarray(arrays["sd_y"], np.float32)
            cached = (mu_x, sd_x, mu_y, sd_y)
            self._std_host[name] = cached
        return cached

    def get_columns(self, name: str, col_range: tuple[int, int], *,
                    wave_rows: int | None = None) -> list[LoadedShard]:
        """Resident shard entries covering target columns ``[lo, hi)``.

        ONLY the bundle's shards overlapping the window are charged and
        paged in (``load_weight_shard(mmap=True)``: the read faults just
        that shard's file pages); each shard is an independent LRU
        resident.  Thread-safe; load faults surface as ``BundleError``.
        """
        with self._lock:
            bundle = self.bundle(name)
            lo, hi = col_range
            idxs = bundle.shards_for_columns(lo, hi)
            if not idxs:
                raise RegistryError(f"column window [{lo}, {hi}) of "
                                    f"{name!r} touches no weight shard")
            eff_wave = max(self.wave_rows, wave_rows or 0)
            budget = self.device_memory_budget
            bounds = bundle.weight_shard_bounds()
            wanted = frozenset((name, i) for i in idxs)
            out = []
            for i in idxs:
                key = (name, i)
                slo, shi = bounds[i]
                if key in self._shards:
                    self.shard_hits += 1
                    self._m_hits.inc()
                    obs.instant("registry.hit", model=name, shard=i)
                    entry = self._shards[key]
                    self._shards.move_to_end(key)
                    if eff_wave > entry.charged_wave_rows:
                        new_need = shard_resident_bytes(bundle, shi - slo,
                                                        eff_wave)
                        if budget is not None and new_need > budget:
                            raise RegistryError(
                                f"shard {i} of {name!r} needs "
                                f"{new_need / 2**20:.1f} MB resident at "
                                f"wave size {eff_wave}, over the registry "
                                f"budget {budget / 2**20:.1f} MB")
                        entry.resident_bytes = new_need
                        entry.charged_wave_rows = eff_wave
                        self._evict_until_fits(extra_need=0,
                                               keep_shards=wanted)
                        self._note_peak()
                    out.append(entry)
                    continue
                need = shard_resident_bytes(bundle, shi - slo, eff_wave)
                if budget is not None and need > budget:
                    raise RegistryError(
                        f"shard {i} of {name!r} needs {need / 2**20:.1f} "
                        f"MB resident, over the registry budget "
                        f"{budget / 2**20:.1f} MB — re-save with narrower "
                        f"weight shards")
                self._evict_until_fits(extra_need=need, keep_shards=wanted)
                t0 = time.perf_counter()
                with obs.span("registry.load", model=name, shard=i,
                              bytes=need):
                    try:
                        W = as_tensor(retry_call(
                            lambda: bundle.load_weight_shard(i, mmap=True),
                            self.fault_policy, "registry.load_shard"),
                            self.device)
                        mu_x, sd_x, mu_y, sd_y = retry_call(
                            lambda: self._std_host_arrays(name),
                            self.fault_policy, "registry.load_std")
                    except BundleError:
                        raise
                    except (ckpt_io.CheckpointError, OSError,
                            ValueError) as e:
                        raise BundleError(
                            f"shard {i} of {name!r} failed to materialise: "
                            f"{e}") from e
                entry = LoadedShard(
                    name=name, shard=i, bounds=(slo, shi), W=W,
                    mu_x=as_tensor(mu_x, self.device),
                    sd_x=as_tensor(sd_x, self.device),
                    mu_y=as_tensor(mu_y[slo:shi], self.device),
                    sd_y=as_tensor(sd_y[slo:shi], self.device),
                    resident_bytes=need, charged_wave_rows=eff_wave,
                    load_seconds=time.perf_counter() - t0)
                self._shards[key] = entry
                self.shard_loads += 1
                self._m_loads.inc()
                self._note_peak()
                out.append(entry)
            return out

    def _evict_until_fits(self, extra_need: int, keep: str | None = None,
                          keep_shards: frozenset = frozenset()) -> None:
        """Evict LRU-first (sparing ``keep``/``keep_shards``) until
        ``extra_need`` more bytes fit the budget.  Shard entries go first:
        dropping one column window is cheaper to undo than reloading a
        whole bundle."""
        budget = self.device_memory_budget
        while budget is not None \
                and self.resident_bytes + extra_need > budget:
            skey = next((k for k in self._shards if k not in keep_shards),
                        None)
            if skey is not None:
                del self._shards[skey]
                self.evictions += 1
                self._m_evictions.inc()
                obs.instant("registry.evict", model=skey[0], shard=skey[1])
                continue
            victim = next((n for n in self._loaded if n != keep), None)
            if victim is None:
                return
            del self._loaded[victim]
            self.evictions += 1
            self._m_evictions.inc()
            obs.instant("registry.evict", model=victim)

    def evict(self, name: str) -> bool:
        """Drop a resident entry — the full-bundle entry AND the model's
        resident column shards, plus the host μ/σ cache so a repaired
        bundle re-reads fresh."""
        with self._lock:
            hit = False
            if name in self._loaded:
                del self._loaded[name]
                self.evictions += 1
                self._m_evictions.inc()
                obs.instant("registry.evict", model=name)
                hit = True
            for key in [k for k in self._shards if k[0] == name]:
                del self._shards[key]
                self.evictions += 1
                self._m_evictions.inc()
                obs.instant("registry.evict", model=key[0], shard=key[1])
                hit = True
            self._std_host.pop(name, None)
            return hit

    def stats(self) -> dict:
        with self._lock:
            return {"registered": len(self._bundles),
                    "loaded": len(self._loaded),
                    "loaded_shards": len(self._shards),
                    "resident_bytes": self.resident_bytes,
                    "peak_resident_bytes": self.peak_resident_bytes,
                    "hits": self.hits, "loads": self.loads,
                    "shard_hits": self.shard_hits,
                    "shard_loads": self.shard_loads,
                    "evictions": self.evictions}


__all__ = ["EncoderRegistry", "RegistryError", "LoadedEncoder",
           "LoadedShard", "bundle_resident_bytes", "shard_resident_bytes"]
