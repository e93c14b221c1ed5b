"""Interactive demo: the animated demo scene, or a static 3DGS `.ply`
scene with its SH bands, served to a browser with mouse orbit.

Counterpart of the JAX package's `demo.py`, with the same options plus
--device.  The SDF scene renders through `Engine` (modeler, then the tile
blend kernel), a `.ply` through `SplatEngine` with SH lighting.  Run:

    python -m splat_renderer_tpu_torch.apps.demo [--surface] [--port 8000]
    python -m splat_renderer_tpu_torch.apps.demo --ply garden.ply

and open http://127.0.0.1:8000.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..config import PointConfig, RenderConfig, surface_render_config
from ..render.pipeline import Engine, SplatEngine, animate_demo, demo_scene
from ..utils.ply import load_ply
from ..viewer import serve
from . import add_device_option, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--surface", action="store_true",
                    help="opaque surface mode (the upstream app's live path): "
                         "surface-oriented quads at full size (cap 16)")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--ply", type=str, default=None,
                    help="serve THIS 3DGS .ply scene (with its SH bands) "
                         "instead of the SDF demo scene")
    ap.add_argument("--cap", type=int, default=8,
                    help="tiles_per_splat_cap (raise for big-footprint scenes)")
    ap.add_argument("--aa", type=float, default=0.0, metavar="PX2",
                    help="anti-aliasing dilation in px^2 (0.3 = the 3DGS "
                         "convention; keeps sub-pixel splats from popping "
                         "when orbiting out from a .ply scene)")
    add_device_option(ap)
    return ap.parse_args(argv)


def build(args: argparse.Namespace, device: torch.device
          ) -> Tuple[Engine, Optional[Callable[[float], None]]]:
    """The engine the demo serves and its animation (None for a static
    `.ply` scene), without starting a server."""
    if args.ply:
        splats, sh = load_ply(args.ply, with_sh=True, device=device)
        rcfg = RenderConfig(width=args.width, height=args.height,
                            tiles_per_splat_cap=args.cap, aa_dilation=args.aa)
        print(f"loaded {splats['px'].shape[0]} splats from {args.ply}"
              + (" (with SH bands)" if sh is not None else ""))
        return SplatEngine(splats, rcfg, sh=sh, device=device), None

    scene = demo_scene()
    if args.surface:
        # the upstream's quads, at full size: cap 16 (r_cap 16 px at 16-px
        # tiles) clamps none of them at 1080p, where cap 8 halves most
        rcfg = surface_render_config(args.width, args.height, quad=True,
                                     tiles_per_splat_cap=16)
    else:
        rcfg = RenderConfig(width=args.width, height=args.height, base_radius=0.015,
                            tiles_per_splat_cap=8, aa_dilation=args.aa)
    eng = Engine(scene, PointConfig(), rcfg, n=args.points, device=device)
    return eng, lambda t: animate_demo(scene, t)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    eng, animate = build(args, resolve_device(args.device))
    serve(eng, port=args.port, animate=animate)


if __name__ == "__main__":
    main()
