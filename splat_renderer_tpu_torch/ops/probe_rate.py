"""Elementwise arithmetic-rate probe: float32 vs bfloat16 multiply-add chains.

`probe_rate` runs `repeats` steps of `acc = acc * 0.5 + 1` on a float32
panel, in float32 or in bfloat16, `steps` times over (every step reads the
same panel and writes the same result), and returns the result as float32.
For CUDA tensors it launches the hand-written kernel `csrc/probe_rate.cu`
(which replaces the JAX package's Pallas kernel
`benchmarks/probe_bf16.py::make(dtype).kernel`) or raises; for CPU tensors
it runs `probe_rate_plain`, the same chain as a Python loop of `torch.mul`
and `torch.add`.  `launches["probe_rate"]` (`ops/build.py`) counts its
kernel launches; the sweep's are not counted.

The question it answers: is bfloat16 elementwise math outside the tensor
cores twice the float32 rate on this card?  That decides whether a bfloat16
profile of the blend kernels' alpha arithmetic could pay.

    python -m splat_renderer_tpu_torch.ops.probe_rate [--sweep]

prints, for each type, the kernel's time and rate in T multiply-adds per
second, beside the card's name and power limit.  With `--sweep` it also
times the same chains laid out C a thread, S steps a block and T threads a
block, in float32, bfloat16 and float16 (`sweep`, the kernel source's
`probe_rate_sweep` entry), in turns with the probe, and checks every
layout's output against the plain chain bit for bit.  It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Dict, List, Optional

import torch

from .build import Entry, check_tensor

PANEL = (128, 256)  # the probe's panel, float32 in and out
REPEATS = 256  # chain length per step
STEPS = 512  # times the whole chain is recomputed
DTYPES = ("f32", "bf16")
# the sweep's layouts
SWEEP_DTYPES = {"f32": 0, "bf16": 1, "f16": 2}
SWEEP_CHAINS = (1, 2, 4, 8)
SWEEP_STEPS_PER_BLOCK = (1, 8, 64)
SWEEP_THREADS = (128, 256)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FORWARD = Entry("probe_rate", "probe_rate_forward", [_P] * 2 + [_I] * 4 + [_P])
_SWEEP = Entry("probe_rate", "probe_rate_sweep", [_I] + [_P] * 2 + [_I] * 6 + [_P])


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
    check_tensor("the probe panel x", x, torch.float32, x.device)
    if x.numel() % 2:
        raise ValueError(f"the probe panel must have an even number of elements, got "
                         f"{tuple(x.shape)}")
    if not 1 <= steps <= 65535 or repeats < 0:
        raise ValueError(f"steps must be in [1, 65535] and repeats >= 0, got {steps}, {repeats}")
    out = torch.empty_like(x)
    _FORWARD.launch(x.device, x.data_ptr(), out.data_ptr(), x.numel(), repeats, steps,
                    int(dtype == "bf16"), count="probe_rate")
    return out


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


def _elapsed_ms(fn, reps: int) -> float:
    """Mean CUDA-event ms of `reps` calls of fn after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def measure(device, reps: int = 10, seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Time the kernel per type on `device` (CUDA events, mean of `reps`
    launches after one warm-up): {"f32"|"bf16": {"ms", "tfma_s"}}."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(PANEL, generator=g, device=device)
    out = {}
    with torch.cuda.device(device):
        for dtype in DTYPES:
            ms = _elapsed_ms(lambda: probe_rate(x, dtype), reps)
            out[dtype] = {"ms": ms, "tfma_s": fma_count(x.numel()) / (ms * 1e-3) / 1e12}
    return out


def plain_f16(x: torch.Tensor, repeats: int = REPEATS) -> torch.Tensor:
    """probe_rate_plain's chain in float16 (exact mul by 0.5, then add)."""
    acc = x.to(torch.float16)
    for _ in range(repeats):
        acc = torch.add(torch.mul(acc, 0.5), 1.0)
    return acc.to(torch.float32)


def sweep(device, rounds: int = 3, reps: int = 20, seed: int = 0):
    """Time every layout of the sweep and the probe itself, in turns, at the
    probe's shape: ({name: [ms per round]}, [layouts whose output is not
    bit-equal to the plain chain]).  A layout is (dtype, chains, steps a
    block, threads)."""
    x = torch.rand(PANEL, generator=torch.Generator(device=device).manual_seed(seed),
                   device=device)
    want = {"f32": probe_rate_plain(x, "f32", steps=1),
            "bf16": probe_rate_plain(x, "bf16", steps=1), "f16": plain_f16(x)}
    layouts = [(d, c, s, t) for d in SWEEP_DTYPES for c in SWEEP_CHAINS
               for s in SWEEP_STEPS_PER_BLOCK for t in SWEEP_THREADS]
    outs = {lay: torch.empty_like(x) for lay in layouts}
    # the events and synchronisations below are the device's
    with torch.cuda.device(device):

        def run(lay):
            d, c, s, t = lay
            _SWEEP.launch(x.device, SWEEP_DTYPES[d], x.data_ptr(), outs[lay].data_ptr(),
                          x.numel(), REPEATS, STEPS, c, s, t)

        bad = []
        for lay in layouts:
            run(lay)
            torch.cuda.synchronize()
            if not torch.equal(outs[lay], want[lay[0]]):
                bad.append(lay)
        times = {k: [] for k in [f"probe_rate {d}" for d in DTYPES] + layouts}
        for _ in range(rounds):
            for d in DTYPES:
                times[f"probe_rate {d}"].append(_elapsed_ms(lambda: probe_rate(x, d), reps))
            for lay in layouts:
                times[lay].append(_elapsed_ms(lambda: run(lay), reps))
    return times, bad


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="float32 vs bfloat16 multiply-add chain rates")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the chains' layouts in float32, bfloat16 and float16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("probe_rate: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for dtype, r in measure(dev).items():
        print(f"{dtype}: {r['ms']:7.3f} ms   ({r['tfma_s']:.2f} Tfma/s)   {card}")
    if not args.sweep:
        return
    times, bad = sweep(dev)
    fmas = fma_count(PANEL[0] * PANEL[1])
    for k, ts in times.items():
        name = k if isinstance(k, str) else "%-4s chains %d steps/block %2d threads %d" % k
        print(f"{name:44s} {' '.join(f'{t:.4f}' for t in ts)} ms  "
              f"{fmas / (min(ts) * 1e-3) / 1e12:.2f} Tfma/s  {card}")
    print(f"layouts not bit-equal to the plain chain: {bad or 'none'}")
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
