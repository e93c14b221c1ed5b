"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled at first
use into `splat_renderer_tpu_torch/_build/` (listed in .gitignore), under a
file name keyed by a hash of the source, the `csrc/*.cuh` headers (included
by name from the source's own directory) and the flags, so an edited source
rebuilds and an unchanged one loads in milliseconds.  Building needs the
CUDA toolkit (`nvcc` under $CUDA_HOME, /usr/local/cuda, or on PATH); nothing
here runs when the package is imported.

Every wrapper reaches its library through `Entry`, one C entry point bound
at its first call, and checks its tensors with `check_tensor`.  `launches`
counts kernel launches by kernel, for every wrapper: "tile_blend",
"tile_blend_depth", "tile_blend_xp", "tile_blend_xp_depth" (K1's schedules
and forms), "tile_blend_diff_forward", "tile_blend_diff_backward",
"project_words", "bin_words" (one a binner call), "sh_colors",
"sdf_descent" and "sdf_probe" (the modeler's two launches a frame) and
"probe_rate";
`launches.clear()` sets them all to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

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
# kernel launches by kernel, all wrappers (module docstring)
launches: Counter = Counter()


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


class Entry:
    """One `extern "C"` entry point of `csrc/<library>.cu`, returning a CUDA
    error code.  The library is built, loaded and the function given its
    `argtypes` (the whole C signature, a launch's trailing stream included)
    and an int return at the first call, not before."""

    def __init__(self, library: str, name: str, argtypes: Sequence) -> None:
        self.library, self.name, self.argtypes = library, name, list(argtypes)
        self._fn = None

    def _bind(self):
        fn = getattr(load_library(self.library), self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def _check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.name} failed: CUDA error {err}")

    def __call__(self, *args, device: Optional[torch.device] = None) -> None:
        """A query (no stream, not counted): call with `args` as they are, on
        the CUDA `device` (an indexed one, as a tensor's) if given, else on
        the current device."""
        fn = self._fn or self._bind()
        if device is None:
            err = fn(*args)
        else:
            with torch.cuda.device(device.index):
                err = fn(*args)
        self._check(err)

    def launch(self, device: torch.device, *args, count: Optional[str] = None) -> None:
        """Launch on the CUDA `device` (an indexed one, as a tensor's), on its
        current stream, whose handle is appended to `args`; then, if `count`
        names a kernel, count one launch of it."""
        fn = self._fn or self._bind()
        # the raw handle, not `torch.cuda.current_stream(device).cuda_stream`,
        # which builds a Stream object: 0.17 against 4.5 us a call on an
        # H100's host, and a frame makes four launches
        with torch.cuda.device(device.index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
        self._check(err)
        if count is not None:
            launches[count] += 1


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
                 shape: Optional[tuple] = None, contiguous: bool = True) -> None:
    """Raise ValueError naming `name` unless `t` is a `dtype` tensor on
    `device` (of `shape`), contiguous unless the kernel reads its strides."""
    if (t.dtype == dtype and t.device == device
            and (shape is None or tuple(t.shape) == tuple(shape))
            and (t.is_contiguous() or not contiguous)):
        return
    want = f"{'a contiguous' if contiguous else 'a'} {dtype} tensor on {device}"
    if shape is not None:
        want += f" of shape {tuple(shape)}"
    got = f"{t.dtype} {tuple(t.shape)} on {t.device}"
    if contiguous and not t.is_contiguous():
        got += ", not contiguous"
    raise ValueError(f"{name} must be {want}, got {got}")
