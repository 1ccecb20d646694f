"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build happens at
first use, into ``build/torch_kernels/`` at the repository root, keyed by a
hash of the sources and flags, so a fresh checkout builds what it runs; the
``-Xptxas -v`` report (registers, spills per kernel) is kept beside each
library. ``build_all`` starts one ``nvcc`` per source at once. A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict = {}
# build seconds of every library built by this process
build_log: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first use and need the "
        "CUDA toolkit"
    )


def _source_hash(source: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [source]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return h.hexdigest()[:16]


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash(CSRC / f'{name}.cu')}.so"


def _ptxas_path(library: Path) -> Path:
    return library.with_suffix(".ptxas.txt")


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the library built from ``csrc/<name>.cu``
    (by this process or an earlier one); raises if it is missing."""
    path = _ptxas_path(_library_path(name))
    if not path.exists():
        raise RuntimeError(f"no ptxas report for {name}: build it first ({path} is missing)")
    return path.read_text()


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library for the
    same sources is not already in the build directory: one ``nvcc`` per
    source, all started together. Returns {name: library path}; raises if
    any build fails."""
    paths = {name: _library_path(name) for name in names}
    todo = [name for name, lib in paths.items() if not lib.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    running = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, cmd, tmp)
    failures = []
    for name, (proc, cmd, tmp) in running.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{out}\n{err}")
            continue
        _ptxas_path(paths[name]).write_text(err.strip() + "\n")  # before the library appears
        os.replace(tmp, paths[name])
        build_log[name] = {"seconds": time.monotonic() - t0}
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for the same sources is
    already in the build directory; returns the library's path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
