"""Reduce a ``torch.profiler`` trace of the window to layers.

``collect`` reads the profiler's raw events once: host operations (an
interval on a thread) and device activities (kernels, copies and fills,
each linked to the innermost host operation that launched it).  Each
device activity is put in one layer, by the host operations around its
launch and then by its kernel's name:

* ``factorisation`` — under ``aten::linalg_eigh`` (cuSOLVER);
* ``products`` — under a matrix product (``aten::mm``, ``matmul``,
  ``bmm``, ``einsum``, …) and not under ``eigh``;
* ``fold statistics`` — the split-bf16 engine's kernels (the program's
  ``xty_folds``/``xty_folds_masked``; launched through ``ctypes``, so
  under no ``aten`` product);
* ``copies`` — memory copies and fills;
* ``elementwise`` — every other kernel.

``summarize`` gives the device's busy time (the union of the activities'
intervals), the traced window, the seconds of each layer, the kernels
that took most time and the longest idle gaps, each labelled with the
innermost host operation that was running at its middle.
"""
from __future__ import annotations

import bisect
import dataclasses
import re

from torch.autograd import DeviceType

EIGH_OPS = frozenset({"aten::linalg_eigh", "aten::_linalg_eigh"})
PRODUCT_OPS = frozenset({
    "aten::mm", "aten::matmul", "aten::bmm", "aten::addmm", "aten::baddbmm",
    "aten::addbmm", "aten::einsum", "aten::mv", "aten::addmv", "aten::dot",
    "aten::linear", "aten::tensordot", "aten::_addmm_activation"})
SPLIT_ENGINE = re.compile(r"\b(split_kernel|product_kernel|"
                          r"xty_split_sum_kernel)\b")
# Idle gaps are named by what the host was doing.
GAP_NAMES = {"aten::linalg_eigh": "eigh host step",
             "aten::_linalg_eigh": "eigh host step"}
# The harness's own range around the window; its bounds are the window's.
WINDOW = "ridgebench.window"


@dataclasses.dataclass
class Op:
    start: int
    end: int
    thread: int
    ident: int
    name: str
    parent: int = -1        # index into the op list, -1 at the top
    eigh: bool = False
    product: bool = False


@dataclasses.dataclass
class Activity:
    start: int
    end: int
    link: int               # the launching host op's ident, 0 if none
    name: str
    kind: str               # "kernel" or "copy" (memory copies, fills)


@dataclasses.dataclass
class Records:
    ops: list[Op]
    activities: list[Activity]
    window: tuple[int, int]     # ns, the traced window on the host clock


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    layers: dict[str, float]            # layer -> device seconds
    device_ops: list[list]              # [[name, seconds], ...] top 10
    idle_gaps: list[list]               # [[label, seconds], ...] top 10
    kernels: dict[str, float]           # kernel name -> device seconds


def collect(events) -> Records:
    """Records from the profiler's raw events (``prof.profiler.
    kineto_results.events()``); the window is the harness's
    ``ridgebench.window`` range, on the profiler's own clock.

    Host operations are the host events linked to no other event (a
    runtime call such as ``cudaLaunchKernel`` inside an operation links
    to it); device events named as a host event are the device's mirror
    of a host range and are left out."""
    ops, dev = [], []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() or e.is_async() \
                    or e.start_thread_id() != e.end_thread_id():
                continue
            ops.append(Op(start, end, e.start_thread_id(),
                          e.correlation_id(), e.name()))
        else:
            name = e.name()
            kind = ("copy" if name.startswith(("Memcpy", "Memset"))
                    else "kernel")
            dev.append(Activity(start, end, e.linked_correlation_id(), name,
                                kind))
    host_names = {o.name for o in ops}
    acts = [a for a in dev if a.name not in host_names]
    marks = [o for o in ops if o.name == WINDOW]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} {WINDOW} ranges, "
                           f"not one")
    return Records(ops=nest(ops), activities=acts,
                   window=(marks[0].start, marks[0].end))


def nest(ops: list[Op]) -> list[Op]:
    """Sort host ops and give each its parent (the innermost op of its
    thread that contains it) and its ``eigh``/``product`` flags, which
    hold for the op and everything under it."""
    ops = sorted(ops, key=lambda o: (o.thread, o.start, -o.end))
    stack: list[int] = []
    for i, o in enumerate(ops):
        while stack and (ops[stack[-1]].thread != o.thread
                         or ops[stack[-1]].end < o.end):
            stack.pop()
        if stack:
            p = ops[stack[-1]]
            o.parent = stack[-1]
            o.eigh, o.product = p.eigh, p.product
        o.eigh = o.eigh or o.name in EIGH_OPS
        o.product = o.product or o.name in PRODUCT_OPS
        stack.append(i)
    return ops


def layer(act: Activity, op: Op | None) -> str:
    if act.kind != "kernel":
        return "copies"
    if op is not None and op.eigh:
        return "factorisation"
    if op is not None and op.product:
        return "products"
    if SPLIT_ENGINE.search(act.name):
        return "fold statistics"
    return "elementwise"


def _short(name: str, width: int = 96) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= width else name[:width - 1] + "…"


def _label(ops: list[Op], threads: dict, at: int) -> str:
    """The innermost host op running at ``at`` on the thread that runs
    the most ops (the one that drives the fit), else on any thread."""
    for lo, hi, starts in threads.values():
        i = bisect.bisect_right(starts, at) - 1 + lo
        while lo <= i < hi:
            o = ops[i]
            if o.end >= at:
                if o.name == WINDOW:
                    break
                return "host: " + GAP_NAMES.get(o.name, o.name)
            i = o.parent
    return "host: no torch op (Python, I/O or waiting)"


def summarize(rec: Records) -> Summary:
    by_ident = {o.ident: o for o in rec.ops}
    w0, w1 = rec.window
    layers: dict[str, float] = {}
    kernels: dict[str, float] = {}
    spans = []
    for a in rec.activities:
        s, e = max(a.start, w0), min(a.end, w1)
        if e <= s:
            continue
        sec = (e - s) / 1e9
        lay = layer(a, by_ident.get(a.link))
        layers[lay] = layers.get(lay, 0.0) + sec
        key = f"{lay}: {_short(a.name)}"
        kernels[key] = kernels.get(key, 0.0) + sec
        spans.append((s, e))
    spans.sort()
    busy = 0
    gaps = []
    cur_s, cur_e = (spans[0] if spans else (w0, w0))
    if spans and cur_s > w0:
        gaps.append((w0, cur_s))
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if spans:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    # Label the ten longest gaps; threads with the most ops first.
    threads: dict[int, tuple] = {}
    for i, o in enumerate(rec.ops):
        lo, _, starts = threads.get(o.thread, (i, i, []))
        starts.append(o.start)
        threads[o.thread] = (lo, i + 1, starts)
    threads = dict(sorted(threads.items(),
                          key=lambda kv: kv[1][0] - kv[1][1]))
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle: dict[str, float] = {}
    for s, e in top:
        lab = _label(rec.ops, threads, (s + e) // 2)
        idle[lab] = idle.get(lab, 0.0) + (e - s) / 1e9
    return Summary(
        busy_s=busy / 1e9, window_s=(w1 - w0) / 1e9, layers=layers,
        device_ops=[[k, v] for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[k, v] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])],
        kernels=kernels)
