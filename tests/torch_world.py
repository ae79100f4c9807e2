"""Spawning the processes of a CPU test world: one process a rank of a
gloo world (``file://`` rendezvous), beside reference subprocesses with
forced host devices.  Every spawn has one shared time limit and fails,
with the tail of each failed process's log, rather than hang.

Used by ``tests/test_torch_mesh.py`` and
``tests/test_torch_sharded_steps.py``; each calls its own file as the
worker script (``python <file> --worker RANK WORLD INIT ROOT``).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)


def reference_env(devices: int) -> dict:
    return env(JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")


def run_all(script: str, jobs: dict[str, tuple[list[str], dict]],
            root: str, timeout_s: float) -> list[tuple[str, object]]:
    """Start every job (name → (argv, env)) at once, wait for all of
    them; → the (name, exit code or "timeout") of each failure, with its
    log's tail in ``root/<name>.log``."""
    procs = {}
    for name, (argv, e) in jobs.items():
        with open(os.path.join(root, f"{name}.log"), "w") as f:
            procs[name] = subprocess.Popen(
                [sys.executable, script, *argv], env=e, stdout=f,
                stderr=subprocess.STDOUT, cwd=REPO)
    deadline = time.monotonic() + timeout_s
    failed = []
    try:
        for name, p in procs.items():
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((name, rc))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return failed


def failure_report(root: str, failed) -> str:
    return "\n".join(
        f"--- {name} ({rc}) ---\n"
        + open(os.path.join(root, f"{name}.log")).read()[-4000:]
        for name, rc in failed)


def join(rank: int, world: int, init: str):
    """Join the gloo world as ``rank`` → the CPU device."""
    import torch

    from repro_torch.core import compat

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    return compat.init_from_env("cpu", init_method=init, timeout_s=90)
