"""Multi-view dataset generation: V orbit views of the animated demo scene
per step, written as PNGs plus a `manifest.json` of cameras, the layout
novel-view-synthesis training reads.  --gbuffer also writes per-view depth
(16-bit PNG, normalized per frame with depth_min/depth_max in the
manifest) and alpha coverage (16-bit PNG).

Counterpart of the JAX package's `datagen.py`, with the same options,
files and manifest, plus --device.  The views render through
`render_views` (the tile blend kernel) or `render_views_gbuffer` (its depth
form).  Run:

    python -m splat_renderer_tpu_torch.apps.datagen --out /tmp/ds --views 8 \\
        --steps 4 --points 200000 [--gbuffer] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..camera import camera_tensors, orbit_ring
from ..config import PointConfig, RenderConfig
from ..render.multiview import quantize_u8, render_views, render_views_gbuffer
from ..render.pipeline import animate_demo, demo_scene, model_points
from ..utils.image import unflatten_rows, write_png, write_png16
from . import add_device_option, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "splat_dataset"))
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument(
        "--base-radius", type=float, default=0.012,
        help="world-space splat radius scale (size to the output "
             "resolution: ~10/width keeps footprints at a few pixels)",
    )
    ap.add_argument(
        "--gbuffer", action="store_true",
        help="also write per-view depth (16-bit PNG, per-frame normalized "
             "with depth_min/depth_max in the manifest) and alpha coverage "
             "channels (render_views_gbuffer)",
    )
    add_device_option(ap)
    return ap.parse_args(argv)


def render_config(args: argparse.Namespace) -> RenderConfig:
    """The views' render configuration."""
    return RenderConfig(width=args.width, height=args.height,
                        base_radius=args.base_radius, tiles_per_splat_cap=8)


def step_splats(scene, step: int, args: argparse.Namespace, rcfg: RenderConfig, device):
    """The demo scene animated to step `step` (t = step / 30) and the
    splats every view of that step renders."""
    animate_demo(scene, step / 30.0)
    gen = torch.Generator(device=device).manual_seed(step)
    return model_points(scene, scene.params(device), gen, args.points, PointConfig(), rcfg,
                        device=device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Write the dataset; returns the manifest."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    scene = demo_scene()
    rcfg = render_config(args)

    manifest = {"frames": [], "width": args.width, "height": args.height, "fov_deg": 45.0}
    for step in range(args.steps):
        t = step / 30.0
        splats = step_splats(scene, step, args, rcfg, device)
        cam_arrays = orbit_ring(args.views, aspect=args.width / args.height,
                                elevation=0.4 + 0.1 * math.sin(t))
        cameras = camera_tensors(cam_arrays, device)
        if args.gbuffer:
            gb = render_views_gbuffer(splats, cameras, rcfg, device=device)
            imgs = quantize_u8(gb["rgb"]).cpu().numpy()
            depth, alpha = gb["depth"].cpu().numpy(), gb["alpha"].cpu().numpy()
        else:
            # quantized on the device, flat rows: a quarter of the copy
            flat = render_views(splats, cameras, rcfg, flat=True, as_uint8=True, device=device)
            imgs = unflatten_rows(flat.cpu().numpy(), args.width)
            depth = alpha = None
        # zlib releases the GIL, so the V encodes overlap
        with ThreadPoolExecutor(max_workers=min(args.views, 8)) as pool:
            futs = []
            for v in range(args.views):
                name = f"step{step:03d}_view{v:02d}.png"
                futs.append(pool.submit(write_png, os.path.join(args.out, name), imgs[v]))
                frame = {
                    "file": name,
                    "step": step,
                    "time": t,
                    "view_proj": np.asarray(cam_arrays["view_proj"][v]).tolist(),
                    "cam_pos": np.asarray(cam_arrays["cam_pos"][v]).tolist(),
                }
                if args.gbuffer:
                    # d16 = (d - min) / (max - min) over hit pixels, background
                    # 0; the manifest keeps the affine, so readers recover the
                    # camera distance up to u16 rounding
                    hit = alpha[v] > 1e-6
                    dmin = float(depth[v][hit].min()) if hit.any() else 0.0
                    dmax = float(depth[v][hit].max()) if hit.any() else 0.0
                    dn = np.where(hit, (depth[v] - dmin) / max(dmax - dmin, 1e-9), 0.0)
                    dname = f"step{step:03d}_view{v:02d}_depth.png"
                    aname = f"step{step:03d}_view{v:02d}_alpha.png"
                    futs.append(pool.submit(write_png16, os.path.join(args.out, dname), dn))
                    futs.append(pool.submit(write_png16, os.path.join(args.out, aname),
                                            alpha[v]))
                    frame.update({"depth_file": dname, "alpha_file": aname,
                                  "depth_min": dmin, "depth_max": dmax})
                manifest["frames"].append(frame)
            for fu in futs:
                fu.result()
        print(f"step {step}: wrote {args.views} views")

    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    print(f"dataset: {len(manifest['frames'])} frames in {args.out}")
    return manifest


if __name__ == "__main__":
    main()
