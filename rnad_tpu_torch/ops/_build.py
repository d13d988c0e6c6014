"""Builds and loads the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``rnad_tpu_torch/_build/`` (git-ignored), then loaded with ``ctypes``.  The
library's file name carries a hash of its source, so an edited source is
rebuilt at its next use and a stale one is never loaded.  Nothing is built when a module is imported: the wrappers call
:func:`entry` at their first launch, and :func:`build` compiles several
sources at once (one ``nvcc`` process each, started together).  A failed
build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compiles every named source whose library is missing, all in
    parallel.  Returns the seconds each build took (0.0 if cached); what
    nvcc and ptxas reported is kept beside each library (``build_log``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name in names:
        out = library_path(name)
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
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """What nvcc and ptxas reported when the library of ``csrc/<name>.cu``
    was built ("" if it has not been)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def kernel_name(symbol: str) -> str:
    """A mangled kernel's name and template argument, e.g.
    "fused_turn_bf16_kernel<3>" from "_ZN<namespace>22fused_turn_bf16_
    kernelILi3EEEv...": the last of its length-prefixed names."""
    pos, name = len(re.match(r"_ZN?", symbol).group()), "?"
    while pos < len(symbol) and symbol[pos].isdigit():
        digits = re.match(r"\d+", symbol[pos:]).group()
        pos += len(digits)
        name = symbol[pos:pos + int(digits)]
        pos += int(digits)
    arg = re.match(r"ILi(\d+)E", symbol[pos:])
    return f"{name}<{arg.group(1)}>" if arg else name


def ptxas_lines(log: str):
    """(kernel, report) pairs of the registers and spills lines that
    ``ptxas -v`` wrote to a build log, e.g. ("rmplus_kernel<5>", "Used 84
    registers, ...") or ("fused_turn_bf16_kernel<3>", ...)."""
    out, kernel = [], "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"function '(_Z\w+)'", line)
            kernel = kernel_name(found.group(1)) if found else "?"
        elif "registers" in line or "spill" in line:
            out.append((kernel, line.strip()))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = str(library_path(name))
    lib = _loaded.get(path)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(path)
        _loaded[path] = lib
    return lib


def bind(lib: ctypes.CDLL, symbol: str, argtypes, restype=ctypes.c_int):
    """``lib.<symbol>`` with its ctypes signature set."""
    fn = getattr(lib, symbol)
    fn.restype = restype
    fn.argtypes = list(argtypes)
    return fn


@functools.lru_cache(maxsize=None)
def entry(name: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu``, loaded and given its
    ctypes signature once, at the first launch."""
    return bind(load(name), symbol, argtypes, restype)


def check(lib_name: str, entry_name: str, err: int) -> None:
    """Raises if the C entry point ``entry_name`` of ``csrc/<lib_name>.cu``
    returned a CUDA error code (each library exports
    ``<entry>_error_string`` to name it)."""
    if err != 0:
        what = entry(lib_name, f"{entry_name}_error_string", (ctypes.c_int,),
                     ctypes.c_char_p)
        raise RuntimeError(f"{entry_name}: CUDA error {err} "
                           f"({what(err).decode()})")
