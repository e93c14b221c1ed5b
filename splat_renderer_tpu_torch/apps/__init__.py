"""Command-line front ends of the port, the counterparts of the JAX
package's root scripts `demo.py`, `fit_demo.py` and `datagen.py`:

    python -m splat_renderer_tpu_torch.apps.demo       # viewer over HTTP
    python -m splat_renderer_tpu_torch.apps.fit_demo   # inverse rendering
    python -m splat_renderer_tpu_torch.apps.datagen    # multi-view datasets

Each takes the JAX script's options plus `--device` (default `cuda`): the
work runs on the card unless `--device cpu` asks for the CPU, and a
missing card is an error, never a silent fall back.  Each `main(argv)`
takes its arguments as a list, so a test or another script runs it in
process.
"""

from __future__ import annotations

import argparse

import torch


def add_device_option(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: 'cuda' (the card, default), "
                         "'cuda:N' or 'cpu'")


def resolve_device(name: str) -> torch.device:
    """The torch device `name`; raises if it is a CUDA device that torch
    cannot see."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch sees no CUDA device (pass --device cpu to run "
            "on the CPU)")
    return device
