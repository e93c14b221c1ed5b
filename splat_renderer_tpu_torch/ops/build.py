"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled at first
use into `splat_renderer_tpu_torch/_build/` (listed in .gitignore), under a
file name keyed by a hash of the source, the `csrc/*.cuh` headers (included
by name from the source's own directory) and the flags, so an edited source
rebuilds and an unchanged one loads in milliseconds.  Building needs the
CUDA toolkit (`nvcc` under $CUDA_HOME, /usr/local/cuda, or on PATH); nothing
here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no multiply-add contraction, so the kernel's cutoff
# arithmetic rounds like the PyTorch and JAX versions (csrc header note).
# No --use_fast_math: coef needs an IEEE divide and expf its full accuracy.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
# seconds each library took to compile in this process (0.0 when it was
# already built)
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME)"
        )
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed by its source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    # the headers the sources share: an edited header rebuilds every library
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its keyed library exists; returns the
    library's path.  Raises RuntimeError with nvcc's output on failure."""
    out = library_path(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # atomic publish: concurrent builds each write their own temp file
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def build_all(names) -> None:
    """Build several libraries at once: one nvcc per source, all started
    together (each `build` waits on its own subprocess)."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(build, names))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`'s library, once per
    process."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib
