"""Shared ``--trace-out`` / ``--metrics-out`` wiring for the port's drivers.

Port of ``repro/launch/obscli.py``, over ``repro_torch.obs``.  Every
driver takes the same two flags:

* ``--trace-out PATH`` — install the process-global tracer for the run
  and write the span trace on exit: Chrome/Perfetto ``trace_event`` JSON
  when ``PATH`` ends in ``.json``, JSONL otherwise (the format
  ``launch/obs_report.py`` reads).
* ``--metrics-out PATH`` — start the background RSS gauge poller and
  write the ``MetricsRegistry`` snapshot JSON on exit.

``obs_session(args)`` is the one context manager a driver wraps its work
in; with neither flag given it is a no-op (the tracer stays uninstalled,
so the instrumented hot paths keep their disabled-cost contract).

``add_device_arg`` adds the port's one flag the reference lacks,
``--device``: CUDA by default (raising without a card, as
``device.resolve_device`` does), ``--device cpu`` to run on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib

from repro_torch import obs


def add_obs_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--trace-out", default=None,
                    help="write a span trace here on exit (.json = "
                         "Perfetto trace_event, else JSONL for "
                         "launch/obs_report.py)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the obs metrics snapshot JSON here on "
                         "exit (counters/gauges/histograms incl. the "
                         "RSS high-water gauge)")


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda, which "
                         "fails without a CUDA card; pass cpu for the CPU)")


def resolve_device_arg(args):
    """``args.device`` as a ``torch.device``; without a usable device the
    driver exits non-zero with ``resolve_device``'s message."""
    from repro_torch.device import resolve_device
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from e


@contextlib.contextmanager
def obs_session(args):
    """Install tracing/metrics per the parsed flags; flush on exit.

    Yields the installed :class:`repro_torch.obs.Tracer` (or ``None``).
    The trace and snapshot are written even when the wrapped driver
    raises — a crashed run's partial trace is exactly when you want one.
    """
    tracer = obs.install() if args.trace_out else None
    poller = obs.start_rss_poller() if args.metrics_out else None
    try:
        yield tracer
    finally:
        if poller is not None:
            poller.stop()
        if tracer is not None:
            fmt = obs.write_trace(tracer, args.trace_out)
            obs.uninstall()
            print(f"trace written → {args.trace_out} ({fmt})")
        if args.metrics_out:
            obs.get_metrics().write_json(args.metrics_out)
            print(f"metrics snapshot → {args.metrics_out}")


__all__ = ["add_device_arg", "add_obs_args", "obs_session",
           "resolve_device_arg"]
