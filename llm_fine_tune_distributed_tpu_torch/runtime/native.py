"""Build and ctypes bindings of the port's native heartbeat
(``native/heartbeat.cc``; counterpart of the JAX ``runtime/native.py``).

The port keeps its own copy of the C++ and compiles it with ``g++`` on first
use into ``build/native/`` at the repository root (beside the CUDA kernels'
``build/torch_kernels/``), keyed by a hash of the source, so an edited
source builds anew and a checkout never loads another's binary. The build
goes to a per-process temporary file that is renamed into place, so
concurrent first uses never load a half-written library. ``load`` returns
None when the build or the load fails, and ``build_error`` says why; the
caller decides whether that is fatal (``runtime/failure.FailureDetector``
raises).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "heartbeat.cc"
BUILD_DIR = _PKG.parent / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"heartbeat-{digest}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall", "-Werror",
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"heartbeat build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, path)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.hb_start_coordinator.restype = c.c_void_p
    lib.hb_start_coordinator.argtypes = [c.c_int, c.c_int]
    lib.hb_coordinator_port.restype = c.c_int
    lib.hb_coordinator_port.argtypes = [c.c_void_p]
    lib.hb_dead_mask.restype = c.c_uint64
    lib.hb_dead_mask.argtypes = [c.c_void_p, c.c_int]
    lib.hb_rank_age_ms.restype = c.c_int64
    lib.hb_rank_age_ms.argtypes = [c.c_void_p, c.c_int]
    lib.hb_stop_coordinator.restype = None
    lib.hb_stop_coordinator.argtypes = [c.c_void_p]
    lib.hb_start_worker.restype = c.c_void_p
    lib.hb_start_worker.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int]
    lib.hb_stop_worker.restype = None
    lib.hb_stop_worker.argtypes = [c.c_void_p]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Compile (when this source has no binary yet, or one that does not
    load here) and load the library; None if either fails."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = lib_path()
            prebuilt = path.exists()
            if not prebuilt:
                _build(path)
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, AttributeError):
                # a binary another machine built from the same source: build
                # it here and load once more
                if not prebuilt:
                    raise
                _build(path)
                _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError, RuntimeError, subprocess.SubprocessError) as e:
            _build_error = str(e)
        return _lib


def build_error() -> Optional[str]:
    return _build_error
