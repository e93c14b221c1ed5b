"""The benchmark of `splat_renderer_tpu_torch` on NVIDIA GPUs.

`python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON result line.
"""
