"""Build and load the port's CUDA sources (``kernels/csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, then loaded
with ``ctypes``.  No PyTorch headers are involved, so a build takes
seconds.  The library lands in ``kernels/_build/`` (git-ignored) under a
name keyed by a hash of the source text, of the ``csrc/`` headers it
``#include``s in quotes and of the flags: an edited source or header
builds afresh, an unchanged one is reused.  The compiler's
register and shared-memory report (``-Xptxas=-v``) is kept beside the
library.

Nothing here runs at import time: the CPU tests import every module of the
package on machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                       "the CUDA kernels are built from source at first use")


def source_key(name: str) -> str:
    """The library key of ``csrc/<name>.cu``: a hash of its text, of the
    ``csrc/`` headers it includes in quotes, and of the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.encode() + (CSRC / h).read_bytes() for h in sorted(
        set(re.findall(r'^#include "([^"]+)"', text.decode(), re.M))))
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists; returns
    the library's path.  The output is written under a temporary name and
    renamed into place, so concurrent builders never load a half-written
    file."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}_{source_key(name)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per
    process."""
    return ctypes.CDLL(str(build(name)))


@functools.cache
def bind(name: str, signatures: tuple) -> ctypes.CDLL:
    """:func:`load` ``csrc/<name>.cu`` and declare its C entry points:
    ``signatures`` is ``((function, argtypes), ...)``; every entry point
    returns an ``int`` CUDA error code (0 = success)."""
    lib = load(name)
    for fn_name, argtypes in signatures:
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, fn_name: str, *args) -> None:
    """Call one C entry point; raise on a non-zero CUDA error code."""
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
