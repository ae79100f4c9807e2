"""Out-of-core run store: memory-mapped fMRI runs behind a JSON manifest.

Port of ``repro/data/store.py``, byte-compatible with it in both
directions: the same manifest (version 1) and the same ``.npy`` shards, so
a store written by either package opens in the other.  Each acquisition
*run* is written once as a pair of shards (``X``: stimulus features, ``Y``:
BOLD targets) and thereafter only memory-mapped, so ``iter_chunks`` hands
out zero-copy row batches whose resident footprint is one chunk, never
``(n, p)``.

Layout on disk::

    <root>/manifest.json          # shapes, dtypes, row offsets, fold split
    <root>/<run_id>.X.npy         # (n_run, p) feature shard
    <root>/<run_id>.Y.npy         # (n_run, t) target shard

Chunks are read-only numpy arrays in the shard's storage dtype.  numpy has
no bfloat16, so bf16 shards are stored — and served — as their ``uint16``
bit patterns, as the reference stores them; ``device.as_tensor`` and
``device.host_view`` view such arrays as ``torch.bfloat16`` without a copy.
The store's ``dtype_x``/``dtype_y`` are the logical torch dtypes.

Design points (as in the reference):

* **Global row order is the manifest's run order**, and the k-fold split
  is recorded at write time, so every consumer derives the same folds.
* **Read paths are read-only.**  ``open()`` maps shards with
  ``mmap_mode="r"``; writing through a served chunk raises.
* **Validation is eager**: ``open()`` cross-checks every shard header
  against the manifest and raises ``StoreError`` before any fit starts.
* **Chunks respect nothing but row order**: they may span run and fold
  boundaries; the fold-stats accumulator splits at fold bounds itself.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.fmri import SubjectSpec
from repro_torch.device import host_view
from repro_torch.resilience import cleanup
from repro_torch.resilience.policy import (FaultPolicy, classify_default,
                                           retry_call)

MANIFEST_NAME = "manifest.json"
_MANIFEST_VERSION = 1


class StoreError(ValueError):
    """Manifest/shard inconsistency (missing file, shape/dtype mismatch,
    overlapping or gapped row ranges)."""


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a manifest name
    (``"float32"``, ``"bfloat16"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise StoreError(f"unsupported dtype {dtype!r}")
    return dt


def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a dtype (numpy's / ml_dtypes' names)."""
    return str(dtype).removeprefix("torch.")


def _storage_dtype(dtype: torch.dtype) -> np.dtype:
    """On-disk numpy dtype for a logical dtype: bfloat16 → ``uint16`` bit
    patterns (what the reference writes), the rest as themselves."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _to_storage(a, dtype: torch.dtype) -> np.ndarray:
    """``a`` (numpy array or tensor) as a C-contiguous host array in the
    storage form of ``dtype`` (bf16 rounded to nearest even)."""
    t = (a.detach().cpu() if isinstance(a, torch.Tensor)
         else host_view(np.asarray(a)))
    t = t.to(dtype).contiguous()
    if dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _cast(a: np.ndarray, src: torch.dtype, dst: torch.dtype) -> np.ndarray:
    """Storage array of logical dtype ``src`` → storage array of ``dst``."""
    if src == dst:
        return a
    return _to_storage(host_view(a).to(dst), dst)


@dataclasses.dataclass(frozen=True)
class RunEntry:
    """One acquisition run inside the store (one X/Y shard pair)."""

    run_id: str
    row_offset: int     # first global row of this run
    n_rows: int

    @property
    def row_end(self) -> int:
        return self.row_offset + self.n_rows


def _shard_paths(root: str, run_id: str) -> tuple[str, str]:
    return (os.path.join(root, f"{run_id}.X.npy"),
            os.path.join(root, f"{run_id}.Y.npy"))


@dataclasses.dataclass
class PrefetchStats:
    """Where a prefetched stream spent its waiting time.

    ``read_stall_s`` is consumer time blocked on an empty queue (the disk
    reader was the bottleneck); ``compute_stall_s`` is reader time blocked
    on a full queue (compute was the bottleneck — the overlap is working).

    Every field is DERIVED from the prefetcher's observability spans
    (``prefetch.stage`` / ``prefetch.wait`` / ``prefetch.compute_stall``
    via ``obs.timed``) — the stats and a recorded trace are two views of
    the same measurements, never parallel bookkeeping.
    """

    chunks: int = 0
    bytes_staged: int = 0
    read_stall_s: float = 0.0
    compute_stall_s: float = 0.0

    def to_dict(self) -> dict:
        """Flat snapshot in the reference's schema (``repro.obs/v1``)."""
        return {"schema": obs.SCHEMA_VERSION, "kind": "prefetch",
                "chunks": int(self.chunks),
                "bytes_staged": int(self.bytes_staged),
                "read_stall_s": float(self.read_stall_s),
                "compute_stall_s": float(self.compute_stall_s)}


class ChunkPrefetcher:
    """Double-buffered background reader over ``RunStore.iter_chunks``.

    A daemon thread walks the synchronous chunk iterator and stages each
    chunk — memmap page-in plus any dtype conversion — into one of
    ``depth + 2`` reusable host buffers, then hands it over through a
    bounded queue of ``depth``.  While the consumer works on chunk *i*,
    the reader is already faulting in chunk *i+1*.

    With ``pin_memory=True`` (a CUDA consumer) the buffers are page-locked
    host memory, so a chunk's copy to the card can run asynchronously
    (``non_blocking=True``).  Such a copy must have finished before the
    consumer asks for the next chunk: the buffer is recycled from then on.
    The port's consumers (``FoldStatsAccumulator.update``,
    ``ColumnMoments.update``) synchronise their stream before returning.

    Contracts (as in the reference):

    * **Bit-identical**: staging is a straight copy, so chunk order,
      shapes and values are exactly the synchronous iterator's.
    * **Bounded residency**: ``depth + 2`` buffers of ``chunk_rows`` rows,
      allocated lazily on first iteration and released when the stream is
      exhausted or closed.  A yielded chunk is valid until the NEXT
      ``next()`` call.
    * **Exceptions propagate**: a reader-thread failure re-raises in the
      consumer at ``next()``.
    * **Early shutdown**: ``close()`` stops the reader thread and frees the
      buffers even mid-stream.

    Yielded arrays are read-only views into the staging buffers.
    """

    _SENTINEL = object()

    def __init__(self, store: "RunStore", chunk_rows: int, *,
                 dtype: torch.dtype | None,
                 row_range: tuple[int, int] | None,
                 col_range: tuple[int, int] | None = None,
                 col_range_x: tuple[int, int] | None = None,
                 depth: int = 2, pin_memory: bool = False):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._store = store
        self._chunk_rows = chunk_rows
        self._dtype = dtype
        self._row_range = row_range
        self._col_range = col_range
        self._col_range_x = col_range_x
        self._depth = depth
        self._pin = pin_memory
        self.stats = PrefetchStats()
        # Hoisted global-metric instruments (one dict lookup each, here,
        # instead of one per staged chunk on the hot path).
        _m = obs.get_metrics()
        self._m_bytes = _m.counter("bytes_staged")
        self._m_chunks = _m.counter("chunks_staged")
        self._m_read_stall = _m.counter("read_stall_s")
        self._m_compute_stall = _m.counter("compute_stall_s")
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._bufs: list[tuple[np.ndarray, np.ndarray]] | None = None
        # The host tensors behind the numpy views of ``_bufs``.
        self._host: list[torch.Tensor] | None = None
        self._done = False

    # -- iterator protocol ---------------------------------------------------
    def __iter__(self) -> "ChunkPrefetcher":
        return self

    def _buffer(self, cols: int, dtype: torch.dtype) -> np.ndarray:
        np_dt = _storage_dtype(dtype)
        nbytes = self._chunk_rows * cols * np_dt.itemsize
        host = torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=self._pin and nbytes > 0)
        self._host.append(host)
        return host.numpy().view(np_dt).reshape(self._chunk_rows, cols)

    def _start(self) -> None:
        dt_x = self._dtype or self._store.dtype_x
        dt_y = self._dtype or self._store.dtype_y
        clo, chi = (self._col_range if self._col_range is not None
                    else (0, self._store.t))
        xlo, xhi = (self._col_range_x if self._col_range_x is not None
                    else (0, self._store.p))
        self._host = []
        self._bufs = [(self._buffer(xhi - xlo, dt_x),
                       self._buffer(chi - clo, dt_y))
                      for _ in range(self._depth + 2)]
        self._thread = threading.Thread(
            target=self._reader, name="runstore-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware bounded put; returns False when closed mid-stream.
        Time spent blocked here is compute stall (queue full = the
        consumer is behind) — one ``prefetch.compute_stall`` span, from
        which ``stats.compute_stall_s`` is derived."""
        try:
            self._queue.put_nowait(item)
            return True
        except queue.Full:
            pass
        with obs.timed("prefetch.compute_stall") as t:
            ok = False
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.05)
                    ok = True
                    break
                except queue.Full:
                    continue
        if ok:
            self.stats.compute_stall_s += t.dur_s
            self._m_compute_stall.inc(t.dur_s)
        return ok

    def _reader(self) -> None:
        """Walk the synchronous iterator, staging each chunk into the pool.

        With a ``fault_policy`` on the store, a transient mid-stream
        failure backs off and RESTARTS the synchronous iterator at the
        first unconsumed chunk.  Chunks are uniformly ``chunk_rows`` rows
        except the ragged tail, so chunk ``seq`` always starts at global
        row ``lo + seq·chunk_rows`` and the restarted stream yields the
        identical remaining sequence.  The attempt counter resets on every
        staged chunk; a give-up (or any permanent error) propagates to the
        consumer.
        """
        policy = self._store.fault_policy
        lo, hi = (self._row_range if self._row_range is not None
                  else (0, self._store.n_total))
        metrics = obs.get_metrics()
        seq = 0
        attempt = 0
        burst_start = None
        try:
            while True:
                try:
                    for X_c, Y_c in self._store._iter_chunks_sync(
                            self._chunk_rows, self._dtype,
                            lo + seq * self._chunk_rows, hi,
                            self._col_range, self._col_range_x):
                        if self._stop.is_set():
                            return
                        bx, by = self._bufs[seq % len(self._bufs)]
                        m = X_c.shape[0]
                        # The staging copy (memmap page-in + dtype
                        # conversion) is one ``prefetch.stage`` span;
                        # bytes_staged derives from the same region.
                        with obs.timed("prefetch.stage", chunk=seq) as t:
                            np.copyto(bx[:m], X_c)
                            np.copyto(by[:m], Y_c)
                            staged = bx[:m].nbytes + by[:m].nbytes
                            t.set(bytes=staged)
                        vx, vy = bx[:m].view(), by[:m].view()
                        vx.flags.writeable = False
                        vy.flags.writeable = False
                        self.stats.bytes_staged += staged
                        self._m_bytes.inc(staged)
                        if not self._put((vx, vy)):
                            return
                        seq += 1
                        attempt = 0
                        burst_start = None
                    break
                except BaseException as exc:         # noqa: BLE001
                    if self._stop.is_set():
                        return
                    if policy is None or not classify_default(exc):
                        raise
                    attempt += 1
                    now = policy.clock()
                    if burst_start is None:
                        burst_start = now
                    out_of_time = (policy.deadline_s is not None and
                                   now - burst_start >= policy.deadline_s)
                    if attempt >= policy.max_attempts or out_of_time:
                        metrics.counter("io_giveups",
                                        op="prefetch.read").inc()
                        obs.instant("retry.giveup", op="prefetch.read",
                                    attempt=attempt)
                        raise
                    metrics.counter("io_retries", op="prefetch.read").inc()
                    delay = policy.delay_for("prefetch.read", attempt)
                    with obs.span("retry.backoff", op="prefetch.read",
                                  attempt=attempt,
                                  delay_s=round(delay, 6)):
                        if delay > 0.0:
                            policy.sleep(delay)
            self._put(self._SENTINEL)
        except BaseException as exc:                 # noqa: BLE001
            self._put(exc)

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._thread is None:
            self._start()
        # Consumer-side block on an empty queue: one ``prefetch.wait``
        # span, from which ``stats.read_stall_s`` is derived.
        with obs.timed("prefetch.wait") as t:
            item = self._queue.get()
        self.stats.read_stall_s += t.dur_s
        self._m_read_stall.inc(t.dur_s)
        if item is self._SENTINEL:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        self.stats.chunks += 1
        self._m_chunks.inc()
        obs.instant("prefetch.yield", chunk=self.stats.chunks - 1)
        return item

    def close(self) -> None:
        """Stop the reader, drain the queue, release the staging buffers."""
        self._done = True
        self._stop.set()
        while True:                     # unblock a reader stuck on put()
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._bufs = None
        self._host = None

    def __del__(self):
        try:
            self.close()
        except Exception:               # interpreter teardown
            pass


def _read_npy_header(path: str) -> tuple[tuple[int, ...], np.dtype]:
    """Shape/dtype from the .npy header alone (no data page-in)."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        major, _ = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if major == 1
                else fmt.read_array_header_2_0)
        shape, _, dtype = read(f)
    return shape, dtype


class RunStore:
    """On-disk (X, Y) row store — write runs once, stream them many times.

    Writing (builds/extends the manifest)::

        store = RunStore.create(path, n_folds=5)
        store.write(X_run1, Y_run1, "ses-001_run-1")   # numpy or tensors

    Streaming (read-only memmaps; resident set = one chunk)::

        store = RunStore.open(path)
        for X_c, Y_c in store.iter_chunks(chunk_rows=4096):
            ...                        # read-only numpy views, zero-copy
    """

    def __init__(self, root: str, *, n_folds: int, dtype_x: torch.dtype,
                 dtype_y: torch.dtype, p: int | None, t: int | None,
                 runs: list[RunEntry], writable: bool,
                 fault_policy: FaultPolicy | None = None):
        self.root = root
        self.n_folds = n_folds
        self.dtype_x = dtype_x
        self.dtype_y = dtype_y
        self.p = p
        self.t = t
        self.runs = runs
        self._writable = writable
        #: transient-fault retry policy for shard reads (None = no retry).
        self.fault_policy = fault_policy

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, root: str, *, n_folds: int = 5,
               dtype: torch.dtype | np.dtype | str = torch.float32
               ) -> "RunStore":
        """Start an empty, writable store at ``root`` (created if missing)."""
        os.makedirs(root, exist_ok=True)
        # A crashed writer leaves `*.tmp-*` shard stubs / a manifest tmp
        # behind; reap them (age-gated) before validating emptiness.
        cleanup.reap_stale_staging(root)
        if os.path.exists(os.path.join(root, MANIFEST_NAME)):
            raise StoreError(f"store already exists at {root}; use open()")
        dt = _torch_dtype(dtype)
        store = cls(root, n_folds=n_folds, dtype_x=dt, dtype_y=dt, p=None,
                    t=None, runs=[], writable=True)
        store._write_manifest()
        return store

    @classmethod
    def open(cls, root: str, *, fault_policy: FaultPolicy | None = None
             ) -> "RunStore":
        """Open read-only and validate the manifest against the shards.

        ``fault_policy`` arms transient-fault retry on every subsequent
        shard mmap and on the prefetcher's chunk stream.
        """
        path = os.path.join(root, MANIFEST_NAME)
        if not os.path.exists(path):
            raise StoreError(f"no {MANIFEST_NAME} under {root}")
        with open(path) as f:
            m = json.load(f)
        if m.get("version") != _MANIFEST_VERSION:
            raise StoreError(f"unsupported manifest version {m.get('version')}")
        runs = [RunEntry(run_id=r["run_id"], row_offset=r["row_offset"],
                         n_rows=r["n_rows"]) for r in m["runs"]]
        store = cls(root, n_folds=m["n_folds"],
                    dtype_x=_torch_dtype(m["dtype_x"]),
                    dtype_y=_torch_dtype(m["dtype_y"]),
                    p=m["p"], t=m["t"], runs=runs, writable=False,
                    fault_policy=fault_policy)
        store._validate()
        return store

    # -- manifest ------------------------------------------------------------
    def _write_manifest(self) -> None:
        payload = {
            "version": _MANIFEST_VERSION,
            "n_folds": self.n_folds,
            "dtype_x": _dtype_name(self.dtype_x),
            "dtype_y": _dtype_name(self.dtype_y),
            "p": self.p,
            "t": self.t,
            "n_total": self.n_total,
            # The fold split is part of the data contract: every consumer
            # derives the same contiguous k-fold assignment from
            # (n_total, n_folds).
            "runs": [{"run_id": r.run_id, "row_offset": r.row_offset,
                      "n_rows": r.n_rows} for r in self.runs],
        }
        tmp = os.path.join(self.root, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        os.replace(tmp, os.path.join(self.root, MANIFEST_NAME))

    def _validate(self) -> None:
        """Cross-check every shard header against the manifest."""
        offset = 0
        for r in self.runs:
            if r.row_offset != offset:
                raise StoreError(
                    f"run {r.run_id!r}: row_offset {r.row_offset} overlaps or "
                    f"gaps the preceding runs (expected {offset})")
            offset = r.row_end
            for path, want_cols, want_dtype, name in (
                    (_shard_paths(self.root, r.run_id)[0], self.p,
                     _storage_dtype(self.dtype_x), "X"),
                    (_shard_paths(self.root, r.run_id)[1], self.t,
                     _storage_dtype(self.dtype_y), "Y")):
                if not os.path.exists(path):
                    raise StoreError(f"run {r.run_id!r}: missing {name} shard "
                                     f"{os.path.basename(path)}")
                shape, dtype = _read_npy_header(path)
                if shape != (r.n_rows, want_cols):
                    raise StoreError(
                        f"run {r.run_id!r}: {name} shard shape {shape} != "
                        f"manifest ({r.n_rows}, {want_cols})")
                if dtype != want_dtype:
                    raise StoreError(
                        f"run {r.run_id!r}: {name} shard dtype {dtype} != "
                        f"manifest {want_dtype}")

    # -- writing -------------------------------------------------------------
    def write(self, X, Y, run_id: str) -> RunEntry:
        """Append one run's rows (numpy arrays or tensors on any device);
        shards land as ``.npy``, then the manifest updates."""
        if not self._writable:
            raise StoreError("store was open()'d read-only; create() to write")
        X = _to_storage(X, self.dtype_x)
        Y = _to_storage(Y, self.dtype_y)
        if X.ndim != 2 or Y.ndim != 2 or X.shape[0] != Y.shape[0]:
            raise StoreError(f"need matching 2-D row blocks, got X{X.shape} "
                             f"Y{Y.shape}")
        if any(r.run_id == run_id for r in self.runs):
            raise StoreError(f"run {run_id!r} already written")
        if self.p is None:
            self.p, self.t = X.shape[1], Y.shape[1]
        elif (X.shape[1], Y.shape[1]) != (self.p, self.t):
            raise StoreError(f"run {run_id!r}: columns ({X.shape[1]}, "
                             f"{Y.shape[1]}) != store ({self.p}, {self.t})")
        entry = RunEntry(run_id=run_id, row_offset=self.n_total,
                         n_rows=X.shape[0])
        # Crash-safe shard landing: stage as `<shard>.tmp-<pid>` then
        # atomic-rename, manifest LAST — a killed writer leaves only a
        # reapable tmp stub, never a manifest pointing at a torn shard.
        for path, arr in zip(_shard_paths(self.root, run_id), (X, Y)):
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, path)
        self.runs.append(entry)
        self._write_manifest()
        return entry

    def materialize_synthetic(self, spec: SubjectSpec, *, seed: int = 0,
                              rows_per_run: int | None = None,
                              device: torch.device | str | None = None
                              ) -> "RunStore":
        """Write a ``data.fmri`` subject once, split into run-sized shards.

        Runs are generated one at a time on ``device`` (CUDA unless
        ``device="cpu"``), each from its own ``torch.Generator`` seeded
        from ``(seed, first row)``, so the subject is never resident as a
        whole.  As in the reference, every run draws its own planted map.
        """
        from repro_torch.data import fmri
        from repro_torch.device import resolve_device

        dev = resolve_device(device)
        cleanup.reap_stale_staging(self.root)
        rows_per_run = rows_per_run or spec.n
        lo = 0
        while lo < spec.n:
            hi = min(lo + rows_per_run, spec.n)
            run_seed = int(np.random.SeedSequence([seed, lo])
                           .generate_state(1)[0])
            g = torch.Generator(dev.type).manual_seed(run_seed)
            X, Y, _ = fmri.generate(dataclasses.replace(spec, n=hi - lo), g,
                                    device=dev)
            self.write(X, Y, f"{spec.subject}_rows-{lo:08d}")
            lo = hi
        return self

    # -- reading -------------------------------------------------------------
    @property
    def n_total(self) -> int:
        return self.runs[-1].row_end if self.runs else 0

    @property
    def shape(self) -> tuple[int, int, int]:
        """(n_total, p, t)."""
        if self.p is None:
            raise StoreError("empty store has no shape yet")
        return self.n_total, self.p, self.t

    def nbytes_resident(self) -> int:
        """Bytes an in-memory fit would hold resident: full X plus Y."""
        n, p, t = self.shape
        return n * (p * self.dtype_x.itemsize + t * self.dtype_y.itemsize)

    def _mmap_raw(self, r: RunEntry) -> tuple[np.ndarray, np.ndarray]:
        """The raw (no-retry) shard mapping — the fault-injection seam."""
        x_path, y_path = _shard_paths(self.root, r.run_id)
        return (np.load(x_path, mmap_mode="r"), np.load(y_path, mmap_mode="r"))

    def _mmap(self, r: RunEntry) -> tuple[np.ndarray, np.ndarray]:
        if self.fault_policy is None:
            return self._mmap_raw(r)
        return retry_call(lambda: self._mmap_raw(r), self.fault_policy,
                          "store.mmap")

    def iter_chunks(self, chunk_rows: int, *,
                    dtype: torch.dtype | str | None = None,
                    row_range: tuple[int, int] | None = None,
                    col_range: tuple[int, int] | None = None,
                    col_range_x: tuple[int, int] | None = None,
                    prefetch: bool = False, prefetch_depth: int = 2,
                    pin_memory: bool = False
                    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield ``(X_chunk, Y_chunk)`` row batches in global row order.

        Batches are views into the read-only memmaps (zero host copies,
        also when ``dtype`` names the stored dtype) unless ``dtype``
        requests a real cast or a chunk spans a run boundary (then the
        spanning rows are concatenated into a fresh array of at most
        ``chunk_rows`` rows).  ``row_range=(lo, hi)`` restricts the stream
        to a global row window; ``col_range``/``col_range_x`` restrict the
        ``Y``/``X`` columns (strided memmap views).

        ``prefetch=True`` returns a ``ChunkPrefetcher``: a background
        reader stages the next chunk into a reusable host buffer (pinned
        with ``pin_memory=True``, for a CUDA consumer) while the caller
        processes the current one — same chunks, same order, same values.
        """
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        lo, hi = row_range if row_range is not None else (0, self.n_total)
        if not 0 <= lo <= hi <= self.n_total:
            raise ValueError(f"row_range {row_range} outside "
                             f"[0, {self.n_total}]")
        if col_range is not None:
            clo, chi = col_range
            if not 0 <= clo <= chi <= (self.t or 0):
                raise ValueError(f"col_range {col_range} outside "
                                 f"[0, {self.t}]")
        if col_range_x is not None:
            xlo, xhi = col_range_x
            if not 0 <= xlo <= xhi <= (self.p or 0):
                raise ValueError(f"col_range_x {col_range_x} outside "
                                 f"[0, {self.p}]")
        dtype = None if dtype is None else _torch_dtype(dtype)
        if prefetch:
            return ChunkPrefetcher(self, chunk_rows, dtype=dtype,
                                   row_range=(lo, hi), col_range=col_range,
                                   col_range_x=col_range_x,
                                   depth=prefetch_depth,
                                   pin_memory=pin_memory)
        return self._iter_chunks_sync(chunk_rows, dtype, lo, hi, col_range,
                                      col_range_x)

    def _iter_chunks_sync(self, chunk_rows: int, dtype: torch.dtype | None,
                          lo: int, hi: int,
                          col_range: tuple[int, int] | None = None,
                          col_range_x: tuple[int, int] | None = None
                          ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        pending_x: list[np.ndarray] = []
        pending_y: list[np.ndarray] = []
        pending = 0

        def cast(X: np.ndarray, Y: np.ndarray):
            # Aligned-dtype fast path: hand back the memmap view itself.
            if dtype is None:
                return X, Y
            return _cast(X, self.dtype_x, dtype), _cast(Y, self.dtype_y, dtype)

        for r in self.runs:
            if r.row_end <= lo or r.row_offset >= hi:
                continue
            Xm, Ym = self._mmap(r)
            if col_range is not None:
                Ym = Ym[:, col_range[0]:col_range[1]]
            if col_range_x is not None:
                Xm = Xm[:, col_range_x[0]:col_range_x[1]]
            s_lo = max(lo, r.row_offset) - r.row_offset
            s_hi = min(hi, r.row_end) - r.row_offset
            pos = s_lo
            while pos < s_hi:
                take = min(chunk_rows - pending, s_hi - pos)
                if pending:
                    pending_x.append(Xm[pos:pos + take])
                    pending_y.append(Ym[pos:pos + take])
                    pending += take
                    if pending == chunk_rows:
                        yield cast(np.concatenate(pending_x),
                                   np.concatenate(pending_y))
                        pending_x, pending_y, pending = [], [], 0
                elif take == chunk_rows:
                    yield cast(Xm[pos:pos + take], Ym[pos:pos + take])
                else:
                    pending_x = [Xm[pos:pos + take]]
                    pending_y = [Ym[pos:pos + take]]
                    pending = take
                pos += take
        if pending:     # ragged tail
            yield cast(np.concatenate(pending_x), np.concatenate(pending_y))

    def load(self, *, dtype: torch.dtype | str | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Materialise the full (X, Y) as host arrays in storage form (the
        in-memory reference path).  Streaming consumers must never call
        this; ``BrainEncoder.fit(store=...)`` does when the store fits the
        memory budget."""
        n, p, t = self.shape
        dx = self.dtype_x if dtype is None else _torch_dtype(dtype)
        dy = self.dtype_y if dtype is None else _torch_dtype(dtype)
        X = np.empty((n, p), _storage_dtype(dx))
        Y = np.empty((n, t), _storage_dtype(dy))
        for r in self.runs:
            Xm, Ym = self._mmap(r)
            X[r.row_offset:r.row_end] = _cast(Xm, self.dtype_x, dx)
            Y[r.row_offset:r.row_end] = _cast(Ym, self.dtype_y, dy)
        return X, Y


__all__ = ["ChunkPrefetcher", "PrefetchStats", "RunStore", "RunEntry",
           "StoreError", "MANIFEST_NAME"]
