"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

The sources under ``kernels/csrc/`` (``*.cu``, and the ``*.cuh`` headers
they include) expose a plain C interface, so they are compiled by ``nvcc``
alone — no PyTorch headers — for Hopper (``sm_90a``), one ``nvcc -c``
per source, all started together, then linked into one shared library
and loaded with ``ctypes``.  The build happens at first use, into
``build/kernels/`` at the repository root; the library's file name
carries a hash of the sources, headers and flags, so a changed file is
rebuilt and an unchanged one is loaded as it is.  A failed build or load
raises with nvcc's output: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LOCK = threading.Lock()


@functools.cache
def _sources() -> tuple[Path, ...]:
    return tuple(sorted(CSRC.glob("*.cu")))


@functools.cache
def _headers() -> tuple[Path, ...]:
    return tuple(sorted(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "port's CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing.

    Returns the library path and the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills of every kernel), empty when the
    library was already built.
    """
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(prefix=f"{lib.stem}.",
                                     dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        with ThreadPoolExecutor(len(objs)) as pool:
            log = "".join(pool.map(_run, (
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs))))
        out = Path(tmp) / lib.name
        _run([nvcc, "-shared", "-o", str(out), *map(str, objs)])
        os.replace(out, lib)
    return lib, log


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    with _LOCK:
        path, _ = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("repro_xty_f32", "repro_xty_bf16"):
        fn = getattr(lib, name)
        # x, x strides (2), y, y strides (2), same, scratch_a, scratch_b,
        # part, out, n, p, q, split_rows, device, stream
        fn.argtypes = [ptr, i64, i64, ptr, i64, i64, i32, ptr, ptr, ptr, ptr,
                       i64, i64, i64, i64, i32, ptr]
        fn.restype = i32
    for name in ("repro_xty_folds_f32", "repro_xty_folds_bf16"):
        fn = getattr(lib, name)
        # x, y, bounds (host int64 k×2), scratch_a, scratch_b, out, p, q, k,
        # device, stream
        fn.argtypes = [ptr, ptr, ctypes.POINTER(i64), ptr, ptr, ptr, i64, i64,
                       i32, i32, ptr]
        fn.restype = i32
    for name in ("repro_xty_folds_masked_f32", "repro_xty_folds_masked_bf16"):
        fn = getattr(lib, name)
        # x, z, w, scratch_a, scratch_b, out, m, p, q, s, device, stream
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i32,
                       ptr]
        fn.restype = i32
    for name in ("repro_flash_attention_f32", "repro_flash_attention_bf16"):
        fn = getattr(lib, name)
        # q, k, v, o, strides (host int64 ×12), B, H, n_kv, S, T, K, causal,
        # window, softcap, device, stream
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.POINTER(i64), i64, i32, i32,
                       i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        fn.restype = i32
    for name in ("repro_ssd_intra_f32", "repro_ssd_intra_bf16"):
        fn = getattr(lib, name)
        # cb, la, x, out, nonfinite flag, N, Q, H, P, device, stream
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr]
        fn.restype = i32
    for name in ("repro_solve_lambda_grid_f32",
                 "repro_solve_lambda_grid_bf16"):
        fn = getattr(lib, name)
        # q, q strides (2), evals, a, lambdas, scales, scratch_a, scratch_b,
        # out, p, t, r, device, stream
        fn.argtypes = [ptr, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64,
                       i64, i32, i32, ptr]
        fn.restype = i32
    for name in ("repro_pearson_r_f32", "repro_pearson_r_bf16"):
        fn = getattr(lib, name)
        # y_true, y_pred, partial, out, n, t, splits, device, stream
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr]
        fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_rc(lib: ctypes.CDLL, rc: int, name: str, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg}) at {what}")
