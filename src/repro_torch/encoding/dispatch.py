"""Complexity-driven solver dispatch (paper §3, Eq. 6–7).

Port of ``repro/encoding/dispatch.py``.  Given ``(n, p, t,
device_count)`` and an ``EncoderConfig``, ``resolve`` picks the solver —
single-shard mutualised ridge, B-MOR, dual B-MOR, banded, or the explicit
MOR baseline — the factorisation side (primal eigh when ``n >= p``, dual
kernel otherwise), and the mesh layout ``(data_shards, target_shards)``
minimising the analytic critical-path cost ``T_W/c_t + T_M/c_d``.  When
the resident set exceeds ``device_memory_budget`` it pins the row-streamed
``chunked`` tier, or the target-blocked ``colblocked`` tier when even the
``(k, p, t)`` fold statistics break the budget (or ``target_block`` is
set).  ``device_count`` is the world of ranks (``core.compat.
device_count()``).  The decision fields and the plan's rationale match the
reference's for the same inputs; the kernel-tier clause names the CUDA
kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import complexity
from repro_torch.core.complexity import RidgeWorkload
from repro_torch.device import resolve_device
from repro_torch.encoding.config import EncoderConfig


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """The resolved execution plan, with the model cost that justified it."""

    solver: str              # "ridge" | "mor" | "bmor" | "bmor_dual" | "banded"
    method: str              # "eigh" | "dual" | "chunked" | "colblocked"
    data_shards: int
    target_shards: int
    predicted_cost: float    # §3 fp-mult count on the critical path
    rationale: str
    target_block: int | None = None
    use_pallas: bool = False

    @property
    def device_count(self) -> int:
        return self.data_shards * self.target_shards


def _divisor_layouts(c: int) -> list[tuple[int, int]]:
    """All (data_shards, target_shards) with data·target == c."""
    return [(d, c // d) for d in range(1, c + 1) if c % d == 0]


def _best_bmor_layout(w: RidgeWorkload, device_count: int,
                      data_shards: int | None, target_shards: int | None
                      ) -> tuple[int, int, float]:
    """Minimise T_W/c_t + T_M/c_d over divisor splits of the device count.

    Pinned shard counts are honoured directly; with one side pinned the
    other takes the remaining devices; with neither pinned the search
    covers divisor pairs of the full device count, ties preferring more
    target shards (the paper's batch axis — per-batch λ, Alg. 1 line 13).
    """
    if data_shards is not None and target_shards is not None:
        if data_shards * target_shards > device_count:
            raise ValueError(
                f"pinned layout {data_shards}x{target_shards} needs more "
                f"than the {device_count} available devices")
        return (data_shards, target_shards,
                complexity.t_bmor_sharded(w, data_shards, target_shards))
    if data_shards is not None or target_shards is not None:
        pinned = data_shards if data_shards is not None else target_shards
        if not 1 <= pinned <= device_count:
            raise ValueError(f"pinned shard count {pinned} exceeds the "
                             f"{device_count} available devices")
        other = device_count // pinned
        c_d, c_t = ((pinned, other) if data_shards is not None
                    else (other, pinned))
        return c_d, c_t, complexity.t_bmor_sharded(w, c_d, c_t)
    best_key: tuple[float, int] | None = None
    best_layout: tuple[int, int, float] | None = None
    for c_d, c_t in _divisor_layouts(device_count):
        if c_d > max(w.n, 1):
            continue
        cost = complexity.t_bmor_sharded(w, c_d, c_t)
        key = (cost, -c_t)
        if best_key is None or key < best_key:
            best_key, best_layout = key, (c_d, c_t, cost)
    if best_layout is None:
        raise ValueError(f"no B-MOR layout of {device_count} devices for "
                         f"n={w.n}")
    return best_layout


def estimated_resident_bytes(n: int, p: int, t: int,
                             target_shards: int = 1,
                             itemsize: int = 4) -> int:
    """Per-device resident working set of a materialised fit:
    ``n·p + n·t_shard`` elements."""
    t_shard = -(-t // max(target_shards, 1))
    return n * (p + t_shard) * itemsize


def mixed_wave_scoring_bytes(wave_rows: int, t: int, score_slots: int,
                             itemsize: int = 4) -> int:
    """Extra resident bytes a MIXED serving wave pins beyond the plain
    predict's activation set: the padded target block (``wave_rows·t``),
    the per-row request one-hot (``wave_rows·score_slots``), and the
    in/out per-slot Pearson-sum carries (``2·score_slots·5·t``)."""
    if score_slots <= 0:
        return 0
    return (wave_rows * t + wave_rows * score_slots
            + 2 * 5 * score_slots * t) * itemsize


def _chunked_decision(cfg: EncoderConfig, w: RidgeWorkload, resident: int,
                      device_count: int) -> DispatchDecision:
    """Pin the streamed fold-statistics path (out-of-core regime)."""
    c_d = cfg.data_shards or device_count
    cost = (complexity.t_w(w) +
            complexity.t_m(w) + complexity.t_w_folded(w) / max(c_d, 1))
    overlap = (f"double-buffered chunk prefetch (depth "
               f"{cfg.prefetch_depth})" if cfg.prefetch
               else "prefetch off (serial read→accumulate)")
    return DispatchDecision(
        solver="ridge", method="chunked", data_shards=c_d, target_shards=1,
        predicted_cost=cost,
        rationale=f"resident set n·p + n·t_shard = {resident / 2**20:.1f} MB "
                  f"exceeds device_memory_budget = "
                  f"{cfg.device_memory_budget / 2**20:.1f} MB → streamed "
                  f"fold-statistics accumulation over {c_d} row shard(s), "
                  f"chunk_rows={cfg.chunk_rows}, {overlap} (only the "
                  f"(k, p, p+t) sufficient statistics and the staging "
                  f"buffers stay resident)")


def chunked_stats_bytes(n_folds: int, p: int, t: int,
                        itemsize: int = 4) -> int:
    """Footprint of the accumulated fold statistics ``k·p·(p + t)``."""
    return n_folds * p * (p + t) * itemsize


def pick_target_block(budget: int, n_folds: int, p: int, t: int,
                      itemsize: int = 4) -> int:
    """Largest column-block width whose blocked statistics
    ``k·p·(p + t_block)`` fit in HALF the budget (the other half covers
    staging buffers, the hoisted eigenbases, and solve temporaries),
    clamped to ``[2, t]`` — the reference's rule, unchanged (it does not
    price the scoring's ``(r, p, t_block)`` temporaries)."""
    per_col = n_folds * p * itemsize
    spare = budget // 2 - n_folds * p * p * itemsize
    return max(2, min(t, spare // max(per_col, 1)))


def _colblocked_decision(cfg: EncoderConfig, w: RidgeWorkload, resident: int,
                         t_axis_bytes: int, t: int) -> DispatchDecision:
    """Pin the target-axis streaming tier (whole-brain regime)."""
    t_block = cfg.target_block or pick_target_block(
        cfg.device_memory_budget, cfg.n_folds, w.p, t)
    n_blocks = -(-t // t_block)
    # Same FLOPs as the chunked tier — the Gram is accumulated once and the
    # C products total n·p·t across blocks; the per-block cost is the
    # re-streamed I/O, which the FLOP model does not price.
    cost = (complexity.t_w(w) +
            complexity.t_m(w) + complexity.t_w_folded(w))
    return DispatchDecision(
        solver="ridge", method="colblocked", data_shards=1, target_shards=1,
        predicted_cost=cost, target_block=t_block,
        rationale=f"the target-axis working set (k·p·(p+t) fold statistics "
                  f"+ (p, t) solve arrays) = {t_axis_bytes / 2**20:.1f} MB "
                  f"breaks device_memory_budget = "
                  f"{cfg.device_memory_budget / 2**20:.1f} MB regardless of "
                  f"row streaming → column-blocked target streaming: "
                  f"{n_blocks} block(s) of t_block={t_block} targets, "
                  f"shared Gram pass + per-block (k, p, t_block) "
                  f"statistics, eigendecompositions mutualised across "
                  f"blocks (resident set O(p² + p·t_block), independent "
                  f"of t={t})")


def _kernel_tier(cfg: EncoderConfig, device: torch.device
                 ) -> tuple[bool, str]:
    """Resolve the kernel tier to a concrete bool plus a rationale clause."""
    up = cfg.resolve_use_pallas(device)
    if up:
        why = ("pinned on by config" if cfg.use_pallas is True
               else "auto: CUDA device")
        return True, (f"kernel tier: CUDA ON ({why}; hand-written "
                      f"xty_folds/xty cross-Gram kernels, xty_folds_masked "
                      f"chunk updates)")
    why = ("pinned off by config" if cfg.use_pallas is False
           else f"auto: device {device.type!r} has no CUDA kernels")
    return False, f"kernel tier: CUDA OFF ({why}; plain kernels.ref products)"


def resolve(cfg: EncoderConfig, n: int, p: int, t: int,
            device_count: int = 1, *,
            device: torch.device | str | None = None) -> DispatchDecision:
    """Resolve ``cfg.solver`` ("auto" or explicit) into a concrete plan.

    ``device_count`` is the number of ranks the fit runs on
    (``core.compat.device_count()``): with one, ``auto`` resolves to the
    ``ridge`` solver, with more to B-MOR (dual B-MOR when ``n < p``), or
    ``banded`` when ``cfg.bands`` is set.  ``device`` (default: CUDA,
    raising without one) decides the kernel tier.
    """
    decision = _resolve_plan(cfg, n, p, t, device_count)
    up, tier = _kernel_tier(cfg, resolve_device(device))
    return dataclasses.replace(decision, use_pallas=up,
                               rationale=f"{decision.rationale}; {tier}")


def _resolve_plan(cfg: EncoderConfig, n: int, p: int, t: int,
                  device_count: int) -> DispatchDecision:
    valid = ("auto", "ridge", "mor", "bmor", "bmor_dual", "banded")
    if cfg.solver not in valid:
        raise ValueError(f"unknown solver {cfg.solver!r}; expected one of "
                         f"{valid}")
    for name, pinned in (("data_shards", cfg.data_shards),
                         ("target_shards", cfg.target_shards)):
        if pinned is not None and not 1 <= pinned <= device_count:
            raise ValueError(f"{name}={pinned} is outside the valid range "
                             f"[1, {device_count}] (available devices)")
    w = RidgeWorkload(n=n, p=p, t=t, r=len(cfg.lambdas), n_folds=cfg.n_folds)
    method = cfg.method if cfg.method != "auto" else (
        "eigh" if n >= p else "dual")
    solver = cfg.solver

    # Memory-budgeted dispatch: the reference pins a streamed tier when the
    # materialised working set cannot fit (same tests as the reference).
    if cfg.device_memory_budget is not None and solver in ("auto", "ridge"):
        resident = estimated_resident_bytes(n, p, t, cfg.target_shards or 1)
        t_axis_bytes = chunked_stats_bytes(cfg.n_folds, p, t) + 3 * p * t * 4
        colblock_viable = (chunked_stats_bytes(cfg.n_folds, p, 2)
                           <= cfg.device_memory_budget // 2)
        streamable = cfg.method != "dual" and cfg.bands is None
        colblocked = cfg.target_block is not None or (
            t_axis_bytes > cfg.device_memory_budget and colblock_viable)
        if resident > cfg.device_memory_budget:
            if not streamable:
                raise ValueError(
                    f"resident set {resident} B exceeds device_memory_budget="
                    f"{cfg.device_memory_budget} B but the pinned "
                    f"method/bands ({cfg.method!r}/{cfg.bands}) cannot "
                    f"stream — the streaming paths are primal/eigh only")
            if colblocked:
                return _colblocked_decision(cfg, w, resident, t_axis_bytes, t)
            return _chunked_decision(cfg, w, resident, device_count)
        if streamable and colblocked:
            return _colblocked_decision(cfg, w, resident, t_axis_bytes, t)

    if solver == "auto":
        if cfg.bands is not None:
            solver = "banded"
        elif device_count <= 1:
            solver = "ridge"
        elif n < p:
            solver = "bmor_dual"
        else:
            solver = "bmor"

    if solver == "banded":
        if cfg.bands is None:
            raise ValueError("banded solver requires EncoderConfig.bands")
        return DispatchDecision(
            solver="banded", method="eigh", data_shards=1, target_shards=1,
            predicted_cost=cfg.n_band_candidates * complexity.t_m(w),
            rationale=f"{len(cfg.bands)} feature bands → per-band λ "
                      f"(Tikhonov substitution), one T_M per candidate")

    if solver == "ridge":
        # The CV Gram statistics are single-pass (t_w_folded = np², not the
        # per-fold k·np²) — foldstats downdating keeps the k-fold
        # redundancy off the critical path.
        cost = (complexity.t_w(w) +
                (complexity.t_m(w) + complexity.t_w_folded(w)
                 if method == "eigh"
                 else complexity.t_m_dual(w) + complexity.t_w_folded_dual(w)))
        return DispatchDecision(
            solver="ridge", method=method, data_shards=1, target_shards=1,
            predicted_cost=cost,
            rationale=f"single shard, {method} factorisation mutualised "
                      f"across t={t} targets and r={w.r} λ (T_M + T_W); "
                      f"single-pass fold stats save "
                      f"{complexity.fold_redundancy_factor(w):.0f}× on the "
                      f"np² Gram term")

    if solver == "mor":
        c_t = cfg.target_shards or 1
        cost = complexity.t_mor(w, c_t)
        return DispatchDecision(
            solver="mor", method=method, data_shards=1, target_shards=c_t,
            predicted_cost=cost,
            rationale=f"explicit MOR baseline: t·T_M recompute, Eq. 6 — "
                      f"{complexity.mor_overhead_factor(w, max(c_t, 1)):.0f}×"
                      f" the B-MOR work at c={c_t} (never auto-selected)")

    if solver == "bmor_dual":
        c_t = cfg.target_shards or device_count
        if cfg.data_shards not in (None, 1):
            raise ValueError("bmor_dual replicates rows; data_shards must "
                             "be 1 (the n×n kernel is small when n < p)")
        cost = (complexity.t_w(w) / c_t + complexity.t_m_dual(w) +
                complexity.t_w_folded_dual(w))
        return DispatchDecision(
            solver="bmor_dual", method="dual", data_shards=1,
            target_shards=c_t, predicted_cost=cost,
            rationale=f"n={n} < p={p}: kernel (n×n) factorisation replicated,"
                      f" targets batched over c={c_t} shards (Eq. 7 dual)")

    c_d, c_t, cost = _best_bmor_layout(w, device_count, cfg.data_shards,
                                       cfg.target_shards)
    return DispatchDecision(
        solver="bmor", method="eigh", data_shards=c_d, target_shards=c_t,
        predicted_cost=cost,
        rationale=f"B-MOR Eq. 7: T_W/{c_t} + T_M/{c_d} minimal over divisor "
                  f"layouts of {device_count} devices "
                  f"(vs MOR {complexity.mor_overhead_factor(w, c_t):.0f}× "
                  f"work at equal parallelism)")
