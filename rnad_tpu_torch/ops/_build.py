"""Builds and loads the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``rnad_tpu_torch/_build/`` (git-ignored), then loaded with ``ctypes``.  The
library's file name carries a hash of its source, so an edited source is
rebuilt at its next use and a stale one is never loaded.  Nothing is built
when a module is imported: the wrappers call :func:`load` at their first
launch, and :func:`build` compiles several sources at once (one ``nvcc``
process each, started together).  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas resource report of each library built by this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compiles every named source whose library is missing, all in
    parallel.  Returns the seconds each build took (0.0 if cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
               "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, entry: str, err: int) -> None:
    """Raises if the C entry point ``entry`` returned a CUDA error code
    (each library exports ``<entry>_error_string`` to name it)."""
    if err != 0:
        what = getattr(lib, f"{entry}_error_string")
        what.restype = ctypes.c_char_p
        what.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({what(err).decode()})")
