"""Complexity-driven solver dispatch (paper §3, Eq. 6–7).

Port of ``repro/encoding/dispatch.py`` for the plans the port runs: the
single-shard ``ridge`` solver, primal eigh when ``n >= p`` and dual
otherwise, the row-streamed ``chunked`` tier when the resident set exceeds
``device_memory_budget``, and the target-blocked ``colblocked`` tier when
even the ``(k, p, t)`` fold statistics break the budget (or
``target_block`` is set).  Every other plan the reference can choose —
MOR, B-MOR, dual B-MOR, banded — raises ``NotImplementedError`` naming the
ROADMAP item that ports it.  The decision fields and the plan's rationale
match the reference's for the same inputs; the kernel-tier clause names
the CUDA kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import complexity
from repro_torch.core.complexity import RidgeWorkload
from repro_torch.device import resolve_device
from repro_torch.encoding.config import EncoderConfig

# Plans of the reference that the port does not run yet → ROADMAP item.
_NOT_PORTED = {
    "mor": "queue 1, item 9 (multi-device)",
    "bmor": "queue 1, item 9 (multi-device)",
    "bmor_dual": "queue 1, item 9 (multi-device)",
    "banded": "queue 1, item 9 (banded ridge)",
}


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """The resolved execution plan, with the model cost that justified it."""

    solver: str              # "ridge" (the only solver the port runs yet)
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


def _not_ported(plan: str):
    return NotImplementedError(
        f"dispatch chose the {plan!r} plan, which the PyTorch port does not "
        f"run yet (ROADMAP {_NOT_PORTED[plan]})")


def estimated_resident_bytes(n: int, p: int, t: int,
                             target_shards: int = 1,
                             itemsize: int = 4) -> int:
    """Per-device resident working set of a materialised fit:
    ``n·p + n·t_shard`` elements."""
    t_shard = -(-t // max(target_shards, 1))
    return n * (p + t_shard) * itemsize


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

    The port is single-device for now, so ``device_count`` is 1 and
    ``auto`` resolves to the ``ridge`` solver.  ``device`` (default: CUDA,
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
    if solver != "ridge":
        raise _not_ported(solver)

    # The CV Gram statistics are single-pass (t_w_folded = np², not the
    # per-fold k·np²) — foldstats downdating keeps the k-fold redundancy off
    # the critical path.
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
