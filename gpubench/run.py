"""Run one cell of the benchmark once on this machine's first GPU.

    python3 -m gpubench.run --workload sdf_anim --seed 7 --seconds 10 --trace 0

Prints progress on standard error and, as the last line of standard
output, one JSON object (see `bench.result_line`).  Without a CUDA device
it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # a library that would load JAX by itself must not
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # one process with few threads: the loops are host-bound, and idle
    # OpenMP workers spinning beside the main thread steal its cores
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("gpubench: torch sees no CUDA device", file=sys.stderr)
        return 2
    from .bench import run_cell

    line = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0),
                    T_START)
    sys.stdout.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
