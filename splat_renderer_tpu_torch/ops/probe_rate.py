"""Elementwise arithmetic-rate probe: float32 vs bfloat16 multiply-add chains.

`probe_rate` runs `repeats` steps of `acc = acc * 0.5 + 1` on a float32
panel, in float32 or in bfloat16, `steps` times over (every step reads the
same panel and writes the same result), and returns the result as float32.
For CUDA tensors it launches the hand-written kernel `csrc/probe_rate.cu`
(which replaces the JAX package's Pallas kernel
`benchmarks/probe_bf16.py::make(dtype).kernel`) or raises; for CPU tensors
it runs `probe_rate_plain`, the same chain as a Python loop of `torch.mul`
and `torch.add`.  `probe_rate.launches` counts kernel launches.

The question it answers: is bfloat16 elementwise math outside the tensor
cores twice the float32 rate on this card?  That decides whether a bfloat16
profile of the blend kernels' alpha arithmetic could pay.

    python -m splat_renderer_tpu_torch.ops.probe_rate

prints, for each type, the kernel's time and rate in T multiply-adds per
second, beside the card's name and power limit.  It needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict

import torch

PANEL = (128, 256)  # the probe's panel, float32 in and out
REPEATS = 256  # chain length per step
STEPS = 512  # times the whole chain is recomputed
DTYPES = ("f32", "bf16")


def _kernel_fn():
    from .build import load_library

    lib = load_library("probe_rate")
    fn = lib.probe_rate_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def probe_rate(
    x: torch.Tensor, dtype: str = "f32", repeats: int = REPEATS, steps: int = STEPS
) -> torch.Tensor:
    """The chain's result on panel `x` (float32, an even number of
    elements), computed in `dtype` ("f32" or "bf16")."""
    if dtype not in DTYPES:
        raise ValueError(f"unknown probe dtype {dtype!r}; expected one of {DTYPES}")
    if x.device.type == "cpu":
        return probe_rate_plain(x, dtype, repeats, steps=1)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() % 2:
        raise ValueError(
            "the probe panel must be a contiguous float32 tensor with an even "
            f"number of elements, got {x.dtype} {tuple(x.shape)}"
        )
    if not 1 <= steps <= 65535 or repeats < 0:
        raise ValueError(f"steps must be in [1, 65535] and repeats >= 0, got {steps}, {repeats}")
    out = torch.empty_like(x)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), repeats, steps,
                 int(dtype == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"probe_rate_forward launch failed: CUDA error {err}")
    probe_rate.launches += 1
    return out


probe_rate.launches = 0


def probe_rate_plain(
    x: torch.Tensor, dtype: str = "f32", repeats: int = REPEATS, steps: int = STEPS
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per step, `repeats` rounds of
    `torch.mul(acc, 0.5)` then `torch.add(.., 1)` in the working type.

    The multiplication by 0.5 is exact in both types (a power of two), so
    mul-then-add rounds once per round, as the kernel's fused multiply-add
    does: float32 results are equal to the kernel's bit for bit; bfloat16
    results are too wherever PyTorch rounds its bfloat16 sum to nearest even.
    """
    if dtype not in DTYPES:
        raise ValueError(f"unknown probe dtype {dtype!r}; expected one of {DTYPES}")
    work = torch.float32 if dtype == "f32" else torch.bfloat16
    acc = x.to(work)
    for _ in range(steps):
        acc = x.to(work)
        for _ in range(repeats):
            acc = torch.add(torch.mul(acc, 0.5), 1.0)
    return acc.to(torch.float32)


def fma_count(n_elements: int, repeats: int = REPEATS, steps: int = STEPS) -> int:
    """Multiply-adds of one probe call."""
    return repeats * steps * n_elements


def measure(device, reps: int = 10, seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Time the kernel per type on `device` (CUDA events, mean of `reps`
    launches after one warm-up): {"f32"|"bf16": {"ms", "tfma_s"}}."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(PANEL, generator=g, device=device)
    out = {}
    for dtype in DTYPES:
        probe_rate(x, dtype)
        torch.cuda.synchronize(device)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            probe_rate(x, dtype)
        e1.record()
        torch.cuda.synchronize(device)
        ms = e0.elapsed_time(e1) / reps
        out[dtype] = {"ms": ms, "tfma_s": fma_count(x.numel()) / (ms * 1e-3) / 1e12}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_rate: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for dtype, r in measure(torch.device("cuda")).items():
        print(f"{dtype}: {r['ms']:7.3f} ms   ({r['tfma_s']:.2f} Tfma/s)   {card}")


if __name__ == "__main__":
    main()
