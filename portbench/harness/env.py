"""Where the benchmark runs: the checkout's paths, the process environment
set before ``torch`` is imported, the numerics every cell runs under, and the
check that no JAX module was loaded.

The program's own kernel build directory is ``src/repro_torch/kernels/_build``
inside the checkout, keyed by source hash.  Every other cache a library may
write (PyTorch's extensions, Triton, the CUDA driver's JIT cache) is pointed
at fixed directories under ``.portbench_cache/`` in the checkout, so only the
first run of a cell in a checkout builds anything.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"
CACHE_DIR = ROOT / ".portbench_cache"

#: top-level module names that may not be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_environment() -> None:
    """Set the cache directories and library switches; put ``src`` on the
    path.  Called before ``torch`` is imported."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        path = CACHE_DIR / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # transformers and similar libraries load JAX by themselves unless told
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def set_numerics(torch) -> dict:
    """Every cell runs float32 matrix products and convolutions in full
    float32 (TF32 off for cuBLAS and cuDNN), as its configuration states.
    One host thread for PyTorch's own operations: the cells' host work is
    single-threaded Python, and idle worker threads only take cores from
    it.  Returns the settings for the result line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    return {"tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def checkout_complete() -> bool:
    """The program's sources are beside the benchmark: a directory holding
    only ``BENCHMARK.json`` and ``portbench/`` has no system to measure."""
    return (ROOT / "src" / "repro_torch" / "__init__.py").is_file()
