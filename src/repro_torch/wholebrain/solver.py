"""Column-blocked CV ridge solver — Eq. 5 mutualisation across target blocks.

Port of ``repro/wholebrain/solver.py``.  The ``k+1`` eigendecompositions of
the downdated Grams depend only on ``X``: they are computed once, from the
shared X-only pass, and reused for every column block; each block's
``(k, p, t_block)`` statistics stream through ``ColumnBlockAccumulator`` and
are scored against the hoisted eigenbases.  The X-only half of each fold's
scores (``foldstats.eigenbasis_x_terms``: ``u`` and ``Ĝ_c``) is hoisted
with them — the same arithmetic on the same tensors, once per fold instead
of once per fold and block.

Two λ-selection modes:

* ``"global"`` (default) — one λ for ALL targets, the unblocked
  ``ridge_cv_from_stats`` contract.  Per-column validation scores are
  summed on the host in float64 in global column order, and the final
  weights come per block from the refit eigenbasis projection
  ``Â_b = Q_Rᵀ C_total[:, block]``, kept in an on-disk float32 scratch
  during the single statistics pass — no second pass over the rows.
* ``"per_block"`` — one λ per target block, scored and argmaxed as
  ``ridge_cv_from_stats`` would on the block-restricted statistics, its
  weights solved at the block's own λ in the same pass.

Device memory: ``O(p² + r·p·t_block)`` — independent of ``t``.  ``Y`` is
streamed once, each block reading only its own columns.  ``X`` is streamed
once when its rows fit the cache policy (the X-only statistics ride block
0's stream and a host cache replays the rows for later blocks), else once
per block (telemetry: ``row_passes_x``).

``journal=`` (a ``resilience.FitJournal``) makes the fit resumable: the X
statistics and every finished block are committed as they complete, and a
killed fit re-run with the same journal replays them and streams only the
rest, with λ and W bitwise equal to an uninterrupted run on the same card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import foldstats
from repro_torch.data.store import _storage_dtype
from repro_torch.device import resolve_device, sync_if_traced
from repro_torch.encoding.config import EncoderConfig
from repro_torch.resilience.journal import FitJournal, JournalError
from repro_torch.wholebrain.stats import (
    ColumnBlockAccumulator, colblock_update_compile_count,
    colblock_update_compiles, column_blocks,
)


@dataclasses.dataclass
class WholebrainResult:
    """Fit result of the column-blocked solver.

    ``best_lambda``/``cv_scores`` follow the ``EncodingReport`` batch
    convention: one row per λ-selection batch — shape ``(1,)``/``(1, r)``
    in global mode, ``(n_blocks,)``/``(n_blocks, r)`` per block.
    ``weights`` is the assembled host ``(p, t)`` float32 matrix when the
    fit collected it, ``None`` when every shard went to a writer instead.
    """

    best_lambda: np.ndarray            # (n_batches,) float64
    cv_scores: np.ndarray              # (n_batches, r) float64
    lambdas: tuple[float, ...]
    lambda_mode: str                   # "global" | "per_block"
    t_block: int
    block_bounds: list[tuple[int, int]]
    lambda_by_target: np.ndarray       # (t,) float64, from the REAL bounds
    weights: np.ndarray | None
    telemetry: dict


def _stream_stats(agg: dict, stream) -> None:
    s = getattr(stream, "stats", None)
    if s is None:
        return
    d = s.to_dict()
    for key in ("chunks", "bytes_staged", "read_stall_s", "compute_stall_s"):
        agg[key] += d[key]


class _XChunkCache:
    """Chunk-granular host cache of the ``X`` rows seen in one stream.

    Filled during the fused first-block pass (the prefetcher's staging
    buffers recycle, so each chunk is copied out into one contiguous
    ``(n, p)`` host array in the store's storage dtype); later target
    blocks replay the identical chunk partition from it and re-stream only
    their ``Y`` columns (``iter_chunks(col_range_x=(0, 0))``).
    """

    def __init__(self, n: int, p: int, dtype) -> None:
        self._arr = np.empty((n, p), dtype)
        self._fill = 0
        self._chunk_ends: list[int] = []

    @property
    def nbytes(self) -> int:
        return self._arr.nbytes

    def append(self, Xc: np.ndarray) -> None:
        m = Xc.shape[0]
        self._arr[self._fill:self._fill + m] = Xc
        self._fill += m
        self._chunk_ends.append(self._fill)

    def chunks(self):
        """Read-only views replaying the captured chunk partition."""
        lo = 0
        for hi in self._chunk_ends:
            v = self._arr[lo:hi].view()
            v.flags.writeable = False
            yield v
            lo = hi

    @staticmethod
    def fits(n: int, p: int, itemsize: int, budget: int | None) -> bool:
        """Cache policy: the whole-brain regime is p ≪ t, so ``n·p`` is the
        small axis — cache it whenever it takes at most a quarter of the
        device-memory budget, or always when no budget was set."""
        return budget is None or n * p * itemsize <= budget // 4


def journal_signature(store, cfg: EncoderConfig | None = None, *,
                      t_block: int | None = None,
                      lambda_mode: str = "global",
                      chunk_rows: int | None = None,
                      device: torch.device | str | None = None) -> dict:
    """The ``FitJournal`` signature ``fit_wholebrain`` would compute for
    these arguments — every input that shapes the bits of λ/W.  Callers
    that attach a journal themselves (to wrap it in
    ``faultsim.KillAfterBlock``, say) build it from here so the solver
    accepts it.  The kernel tier is resolved for ``device`` (CUDA unless
    ``device="cpu"``); the keys are the reference's, so a journal either
    package wrote attaches in the other."""
    cfg = cfg or EncoderConfig()
    n, p, t = store.shape
    t_block = t_block or getattr(cfg, "target_block", None)
    return {
        "n": int(n), "p": int(p), "t": int(t), "k": int(cfg.n_folds),
        "t_block": int(t_block), "lambda_mode": lambda_mode,
        "chunk_rows": int(min(chunk_rows or cfg.chunk_rows, n)),
        "lambdas": [float(l) for l in cfg.lambdas],
        "scoring": cfg.scoring,
        "use_pallas": bool(cfg.resolve_use_pallas(resolve_device(device))),
    }


def _check_target_scale(bstats, n_total: int, lo: int, hi: int) -> None:
    """The row tier's un-standardized-target refusal, per block:
    statistics-based CV scoring loses f32 precision quadratically in
    |ȳ|/σ_y."""
    w = hi - lo
    mu = bstats.ysum.sum(0).cpu().numpy()[:w] / n_total
    var = bstats.ysq.sum(0).cpu().numpy()[:w] / max(n_total - 1, 1)
    ratio = float(np.max(np.abs(mu) / np.sqrt(var + 1e-12)))
    if ratio > 1e3:
        raise ValueError(
            f"wholebrain fit: target mean/std ratio {ratio:.0f} in columns "
            f"[{lo}, {hi}) is too large for statistics-based CV scoring in "
            f"float32 — standardize the targets first")


def _project(Q_R: torch.Tensor, C_total: torch.Tensor) -> torch.Tensor:
    """The refit eigenbasis projection ``Â = Q_Rᵀ C_total``."""
    return torch.matmul(Q_R.T, C_total)


def _solve_projected(Q_R: torch.Tensor, evals_R: torch.Tensor,
                     lam: torch.Tensor, Ahat: torch.Tensor) -> torch.Tensor:
    """``W = Q_R (Λ+λ)⁻¹ Â`` — ``ridge.solve``'s arithmetic on a projection
    computed earlier."""
    return torch.matmul(Q_R, Ahat / (evals_R + lam)[:, None])


def fit_wholebrain(store, cfg: EncoderConfig | None = None, *,
                   t_block: int | None = None,
                   lambda_mode: str = "global",
                   chunk_rows: int | None = None,
                   writer=None, collect: bool | None = None,
                   scratch_dir: str | None = None,
                   journal=None,
                   device: torch.device | str | None = None
                   ) -> WholebrainResult:
    """Column-blocked streaming CV ridge over a ``RunStore``.

    ``writer`` (any object with ``append(W_block)``, e.g.
    ``wholebrain.artifact.BundleWriter``) receives the ``(p, w)`` float32
    weight shards in block order as they finish — the streaming-save path
    where the full ``(p, t)`` matrix never exists in memory.  Without a
    writer, ``collect=True`` (the default then) assembles the host weight
    matrix.  ``scratch_dir`` hosts the global-mode ``Â`` scratch memmap
    (default: the writer's staging dir, else a temporary directory).
    ``device`` runs the fit (CUDA unless ``device="cpu"``); the kernel tier
    follows ``cfg.use_pallas`` for it.

    ``journal`` makes the fit resumable: a directory path, or an attached
    ``FitJournal`` whose signature matches :func:`journal_signature`
    (``JournalError`` otherwise), where the X-statistics pass and every
    completed column block are committed as they finish.  A fit killed
    mid-stream and re-run with the same journal replays the committed
    statistics — never re-accumulating them — streams only the remaining
    blocks, and produces λ and W bitwise equal to an uninterrupted run.
    On success the journal directory is deleted.

    The whole fit runs under a ``fit.wholebrain`` root span (children:
    ``wholebrain.xstats``, ``wholebrain.block``, ``fit.eigh``,
    ``fit.solve``) with the recompile sentinel armed at one new signature
    per update tier for the full run — every block shares the X-only and
    column-block updates; under ``REPRO_OBS_STRICT=1`` a second raises
    ``obs.RecompileError`` at the update that sees it.  Leaf spans name
    the host work between kernels: ``wholebrain.score``,
    ``wholebrain.project``, ``wholebrain.weights_emit`` and, in global
    mode, the ``Â`` scratch's ``wholebrain.scratch_{write,flush,read,
    free}``, whose seconds sum to ``telemetry["scratch_io_s"]``.
    """
    n, p, t = store.shape
    with obs.span("fit.wholebrain", n=n, p=p, t=t,
                  lambda_mode=lambda_mode), \
         foldstats.chunk_update_compiles().expect(at_most=1), \
         colblock_update_compiles().expect(at_most=1):
        return _fit_wholebrain(store, cfg, t_block=t_block,
                               lambda_mode=lambda_mode,
                               chunk_rows=chunk_rows, writer=writer,
                               collect=collect, scratch_dir=scratch_dir,
                               journal=journal, device=device)


def _attach_journal(journal, signature: dict):
    """A ``FitJournal`` (or a wrapper of one) for ``signature``."""
    if isinstance(journal, (str, os.PathLike)):
        return FitJournal.attach(os.fspath(journal), signature)
    if getattr(journal, "signature", None) != signature:
        raise JournalError(
            f"attached journal signature {journal.signature} does not "
            f"match this fit's {signature}")
    return journal


def _fit_wholebrain(store, cfg: EncoderConfig | None, *,
                    t_block: int | None, lambda_mode: str,
                    chunk_rows: int | None, writer, collect: bool | None,
                    scratch_dir: str | None, journal,
                    device: torch.device | str | None) -> WholebrainResult:
    cfg = cfg or EncoderConfig()
    if cfg.solver not in ("auto", "ridge"):
        raise ValueError(f"wholebrain fit supports only the ridge solver; "
                         f"solver={cfg.solver!r} is pinned")
    if cfg.method == "dual" or cfg.bands is not None:
        raise ValueError("wholebrain fit is primal/eigh only (streamed "
                         "statistics cannot build the dual kernel or bands)")
    if lambda_mode not in ("global", "per_block"):
        raise ValueError(f"lambda_mode must be 'global' or 'per_block', "
                         f"got {lambda_mode!r}")
    k_store = getattr(store, "n_folds", None)
    if k_store is not None and k_store != cfg.n_folds:
        raise ValueError(f"store manifest records n_folds={k_store} but the "
                         f"config says n_folds={cfg.n_folds}")
    n, p, t = store.shape
    t_block = t_block or getattr(cfg, "target_block", None)
    if t_block is None:
        raise ValueError("pass t_block= (or set EncoderConfig.target_block)")
    bounds = column_blocks(t, t_block)
    t_pad = bounds[0][1] - bounds[0][0]
    k = cfg.n_folds
    r = len(cfg.lambdas)
    chunk_rows = min(chunk_rows or cfg.chunk_rows, n)
    if collect is None:
        collect = writer is None
    dev = resolve_device(device)
    use_pallas = cfg.resolve_use_pallas(dev)
    stream_kw = dict(prefetch=cfg.prefetch, prefetch_depth=cfg.prefetch_depth,
                     pin_memory=dev.type == "cuda")
    acc_kw = dict(chunk_rows=chunk_rows, use_pallas=use_pallas, device=dev)

    agg = {"chunks": 0, "bytes_staged": 0, "read_stall_s": 0.0,
           "compute_stall_s": 0.0}
    fixed0 = foldstats.chunk_update_compile_count()
    colblock0 = colblock_update_compile_count()
    dtype_x = getattr(store, "dtype_x", torch.float32)
    x_cache_fits = _XChunkCache.fits(n, p, dtype_x.itemsize,
                                     cfg.device_memory_budget)

    jrn = None
    if journal is not None:
        jrn = _attach_journal(journal, journal_signature(
            store, cfg, t_block=t_block, lambda_mode=lambda_mode,
            chunk_rows=chunk_rows, device=dev))
    done: set[int] = jrn.completed_blocks() if jrn is not None else set()
    resumed = jrn is not None and jrn.has_xstats
    # The last block that streams this run: a rebuilt X cache pays off only
    # if a streamed block follows it.
    last_streamed = max((i for i in range(len(bounds)) if i not in done),
                        default=-1)

    if not resumed:
        # -- fused first pass: the X-only statistics (G/xsum/count from a
        # zero-width Y window) ride block 0's stream, and the feature rows
        # are cached when they fit the policy, so later blocks re-stream
        # only their own Y columns.
        lo0, hi0 = bounds[0]
        with obs.span("wholebrain.xstats", rows=n, fused_block=0) as xsp:
            gacc = foldstats.FoldStatsAccumulator(n, k, **acc_kw)
            bacc0 = ColumnBlockAccumulator(n, k, t_pad, **acc_kw)
            x_cache = None
            if len(bounds) > 1 and x_cache_fits:
                x_cache = _XChunkCache(n, p, _storage_dtype(dtype_x))
            xsp.set(cached=x_cache is not None)
            with contextlib.closing(store.iter_chunks(
                    chunk_rows, col_range=(lo0, hi0), **stream_kw)) as stream:
                for Xc, Yc in stream:
                    gacc.update(Xc, Yc[:, :0])
                    bacc0.update(Xc, Yc)
                    if x_cache is not None:
                        x_cache.append(np.asarray(Xc))
            _stream_stats(agg, stream)
            xsp.set(bytes_staged=agg["bytes_staged"])
            gstats = gacc.finalize()
            block0_stats = bacc0.finalize()
            del gacc, bacc0
        G, xsum, count = gstats.G, gstats.xsum, gstats.count
        del gstats
        if jrn is not None:
            jrn.put_xstats(G.cpu().numpy(), xsum.cpu().numpy(),
                           count.cpu().numpy())
    else:
        # -- resume: REPLAY the journaled X statistics (the f32 bytes the
        # killed fit produced, so the recomputed eighs and everything
        # downstream match bitwise).  The X chunk cache died with the old
        # process; the first streamed block rebuilds it.
        with obs.span("wholebrain.xstats", rows=n, replayed=True):
            G, xsum, count = (torch.from_numpy(a).to(dev)
                              for a in jrn.load_xstats())
        block0_stats = None
        x_cache = None

    # -- hoisted factorisations: k downdated eighs + the refit, once, and
    # each fold's X-only scoring terms; the (k, p, p) Gram is not needed
    # after them.
    with obs.span("fit.eigh", folds=k, p=p):
        eye = cfg.jitter * torch.eye(p, dtype=torch.float32, device=dev)
        lams = torch.tensor(cfg.lambdas, dtype=torch.float32, device=dev)
        G_total = G.sum(0)
        fold_eigs, x_terms = [], []
        for f in range(k):
            evals_f, Q_f = torch.linalg.eigh(G_total - G[f] + eye)
            fold_eigs.append((evals_f, Q_f))
            x_terms.append(foldstats.eigenbasis_x_terms(
                xsum[f], G[f], count[f], Q_f))
        evals_R, Q_R = torch.linalg.eigh(G_total + eye)
        del G, xsum, G_total, eye
        sync_if_traced(dev)

    W_full = np.empty((p, t), np.float32) if collect else None
    scratch = None
    scratch_path = None
    tmp_holder = None
    per_block_lams: list[float] = []
    per_block_curves: list[np.ndarray] = []
    score_sum = np.zeros((k, r), np.float64)     # global: Σ_cols per fold
    restreamed_x = 0
    blocks_replayed = 0
    # Host seconds of the global-mode Â scratch: its creation, writes,
    # flush, read-back and removal (the wholebrain.scratch_* spans).
    scratch_io = []

    def scratch_timed(name: str, **attrs):
        t = obs.timed(name, **attrs)
        scratch_io.append(t)
        return t

    def emit(Wb: np.ndarray, lo: int, hi: int) -> None:
        with obs.span("wholebrain.weights_emit", lo=lo, hi=hi):
            if collect:
                W_full[:, lo:hi] = Wb
            if writer is not None:
                writer.append(Wb)

    try:
        if lambda_mode == "global":
            with scratch_timed("wholebrain.scratch_write", bytes=p * t * 4):
                base = scratch_dir or getattr(writer, "scratch_dir", None)
                if base is None:
                    tmp_holder = tempfile.mkdtemp(
                        prefix="wholebrain_scratch_")
                    base = tmp_holder
                scratch_path = os.path.join(base, "ahat.npy")
                scratch = np.lib.format.open_memmap(
                    scratch_path, mode="w+", dtype=np.float32, shape=(p, t))

        # -- per-block pass: stream the block's columns, score every fold.
        # Block 0 came from the fused first pass; later blocks read X from
        # the cache when it was captured, else re-stream the full rows.
        # Blocks a killed fit journaled are REPLAYED in block order.
        for bi, (lo, hi) in enumerate(bounds):
            if bi in done:
                with obs.span("wholebrain.block", block=bi, lo=lo, hi=hi,
                              replayed=True):
                    rec = jrn.load_block(bi)
                    blocks_replayed += 1
                    if lambda_mode == "global":
                        # The killed fit's f64 addends in the same block
                        # order: the running sum stays bitwise equal.
                        score_sum += rec["scores"]
                        with scratch_timed("wholebrain.scratch_write",
                                           lo=lo, hi=hi):
                            scratch[:, lo:hi] = rec["ahat"]
                    else:
                        per_block_lams.append(rec["lam"])
                        per_block_curves.append(rec["curve"])
                        emit(rec["W"], lo, hi)
                continue
            with obs.span("wholebrain.block", block=bi, lo=lo, hi=hi) as bsp:
                bytes0 = agg["bytes_staged"]
                w = hi - lo
                if bi == 0 and block0_stats is not None:
                    bstats, block0_stats = block0_stats, None
                else:
                    bacc = ColumnBlockAccumulator(n, k, t_pad, **acc_kw)
                    if x_cache is not None:
                        # A Y-only store pass zipped with the cache's
                        # replay of the identical chunk partition.
                        with contextlib.closing(store.iter_chunks(
                                chunk_rows, col_range=(lo, hi),
                                col_range_x=(0, 0), **stream_kw)) as stream:
                            for Xc, (_, Yc) in zip(x_cache.chunks(), stream):
                                bacc.update(Xc, Yc)
                    else:
                        restreamed_x += 1
                        # Re-streaming the full rows anyway: capture them
                        # when more streamed blocks follow (the resume
                        # path's cache rebuild).
                        capture = None
                        if bi < last_streamed and x_cache_fits:
                            capture = _XChunkCache(n, p,
                                                   _storage_dtype(dtype_x))
                        with contextlib.closing(store.iter_chunks(
                                chunk_rows, col_range=(lo, hi),
                                **stream_kw)) as stream:
                            for Xc, Yc in stream:
                                bacc.update(Xc, Yc)
                                if capture is not None:
                                    capture.append(np.asarray(Xc))
                        if capture is not None:
                            x_cache = capture
                    _stream_stats(agg, stream)
                    bstats = bacc.finalize()
                    del bacc
                _check_target_scale(bstats, n, lo, hi)
                C_total_b = bstats.C_total                # (p, t_pad)
                fold_scores = []
                contrib = np.zeros((k, r), np.float64)    # this block's Σ_cols
                # The host reads the scores back (global) or the selected
                # λ (per block), so the span ends with the card's work.
                with obs.span("wholebrain.score", folds=k):
                    for f in range(k):
                        evals_f, Q_f = fold_eigs[f]
                        u_f, Ghat_f = x_terms[f]
                        s_rt = foldstats.validation_scores_from_terms(
                            bstats.C[f], bstats.ysum[f], bstats.ysq[f],
                            count[f], Q_f, evals_f, C_total_b - bstats.C[f],
                            lams, cfg.scoring, u_f, Ghat_f)
                        if lambda_mode == "global":
                            # Host f64 sums in global column order: the
                            # aggregate does not depend on the blocking.
                            contrib[f] = (s_rt[:, :w].cpu().numpy()
                                          .astype(np.float64).sum(axis=1))
                        else:
                            fold_scores.append(s_rt[:, :w].mean(1))
                        del s_rt
                    if lambda_mode != "global":
                        cv_b = torch.stack(fold_scores).mean(0)
                        best_b = int(torch.argmax(cv_b))
                del bstats
                if lambda_mode == "global":
                    score_sum += contrib
                    # The refit projection of the block: the only
                    # per-block quantity the final solve needs, so λ
                    # selection costs no second pass over the rows.
                    with obs.span("wholebrain.project", p=p):
                        Ahat_w = _project(Q_R, C_total_b).cpu().numpy()[:, :w]
                    with scratch_timed("wholebrain.scratch_write",
                                       lo=lo, hi=hi):
                        scratch[:, lo:hi] = Ahat_w
                    if jrn is not None:
                        jrn.put_block(bi, scores=contrib, ahat=Ahat_w)
                else:
                    # The projection and the block's solve at its own λ.
                    with obs.span("wholebrain.project", p=p):
                        Wb = _solve_projected(
                            Q_R, evals_R, lams[best_b],
                            _project(Q_R, C_total_b))[:, :w].cpu().numpy()
                    lam_b = float(lams[best_b])
                    curve_b = cv_b.cpu().numpy().astype(np.float64)
                    per_block_lams.append(lam_b)
                    per_block_curves.append(curve_b)
                    if jrn is not None:
                        jrn.put_block(bi, lam=lam_b, curve=curve_b, W=Wb)
                    emit(Wb, lo, hi)
                del C_total_b
                bsp.set(bytes_staged=agg["bytes_staged"] - bytes0)

        scratch_bytes = 0
        if lambda_mode == "global":
            cv_scores = (score_sum / t).mean(axis=0)          # (r,) f64
            best = int(np.argmax(cv_scores))
            lam = float(lams[best])
            # -- weight pass: read each block's Â back, padded to t_pad as
            # every block's products ran, and solve at the selected λ.
            with obs.span("fit.solve", p=p, blocks=len(bounds)):
                with scratch_timed("wholebrain.scratch_flush"):
                    scratch.flush()
                for lo, hi in bounds:
                    w = hi - lo
                    with scratch_timed("wholebrain.scratch_read",
                                       lo=lo, hi=hi):
                        Ab = np.zeros((p, t_pad), np.float32)
                        Ab[:, :w] = scratch[:, lo:hi]
                    Wb = _solve_projected(Q_R, evals_R, lams[best],
                                          torch.from_numpy(Ab).to(dev))[:, :w]
                    emit(Wb.cpu().numpy(), lo, hi)
            scratch_bytes = p * t * 4
            best_lambda = np.asarray([lam], np.float64)
            curves = cv_scores[None, :]
            lam_t = np.full((t,), lam, np.float64)
        else:
            best_lambda = np.asarray(per_block_lams, np.float64)
            curves = np.stack(per_block_curves)
            # λ per target from the REAL block bounds.
            lam_t = np.empty((t,), np.float64)
            for lam_b, (lo, hi) in zip(per_block_lams, bounds):
                lam_t[lo:hi] = lam_b
    finally:
        if scratch_path is not None or tmp_holder is not None:
            with scratch_timed("wholebrain.scratch_free"):
                del scratch                      # unmap before unlink
                if scratch_path is not None and os.path.exists(scratch_path):
                    os.unlink(scratch_path)
                if tmp_holder is not None:
                    shutil.rmtree(tmp_holder, ignore_errors=True)

    telemetry = {
        **agg,
        "n_blocks": len(bounds),
        "t_block": t_block,
        "t_pad": t_pad,
        "eighs": k + 1,
        "gram_compile_delta": foldstats.chunk_update_compile_count() - fixed0,
        "colblock_compile_delta": (colblock_update_compile_count()
                                   - colblock0),
        "scratch_bytes": scratch_bytes if lambda_mode == "global" else 0,
        "scratch_io_s": sum((s.dur_s for s in scratch_io), 0.0),
        # 1 fused first pass (none on resume) + every block that
        # re-streamed the feature shards because the X chunk cache was not
        # captured (or died with the killed fit).
        "row_passes_x": (0 if resumed else 1) + restreamed_x,
        "row_passes_y": 1,
        "x_cache_bytes": 0 if x_cache is None else x_cache.nbytes,
        "use_pallas": use_pallas,
        "resumed": resumed,
        "blocks_replayed": blocks_replayed,
        "blocks_streamed": len(bounds) - blocks_replayed,
    }
    if jrn is not None:
        jrn.finish()
    return WholebrainResult(
        best_lambda=best_lambda, cv_scores=np.asarray(curves, np.float64),
        lambdas=cfg.lambdas, lambda_mode=lambda_mode, t_block=t_block,
        block_bounds=bounds, lambda_by_target=lam_t,
        weights=W_full, telemetry=telemetry)


__all__ = ["WholebrainResult", "fit_wholebrain", "journal_signature"]
