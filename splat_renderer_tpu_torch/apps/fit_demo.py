"""Inverse-rendering demo: recover splat fields by gradient descent.

Renders targets from the demo scene's modeled splats (or a `.ply` scene),
restarts the chosen fields from flat gray (appearance) or a perturbed truth
(geometry), and fits them back with Adam through the differentiable render.
With --dataset it trains from a `datagen --gbuffer` directory instead:
geometry from the backprojected depth and alpha, targets from its images.

Counterpart of the JAX package's `fit_demo.py`, with the same options and
refusals plus --device.  --method takes "oracle", "tiles" or "kernel"; the
JAX package's "pallas" is the port's "kernel", the hand-written forward and
backward blend kernels.  Run:

    python -m splat_renderer_tpu_torch.apps.fit_demo [--steps 150] [--n 2000]
        [--size 128] [--method tiles|kernel|oracle] [--views 4]
        [--fields cr,cg,cb,opacity,px,py,pz,radius] [--ply-in scene.ply]
        [--ply-out fitted.ply] [--sh] [--checkpoint fit_state.npz]
        [--device cuda]
    python -m splat_renderer_tpu_torch.apps.fit_demo --dataset DIR \\
        [--depth-weight 0.2]

It prints the loss curve and the final PSNR; --out writes
<out>_target/init/fit.png.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from .. import fit
from ..camera import Camera, camera_tensors
from ..config import PointConfig, RenderConfig
from ..data import backproject_gbuffer, load_dataset
from ..render.diff import render_diff
from ..render.pipeline import model_points
from ..render.sh import apply_sh, sh_degree
from ..sdf import Box, SDFScene, Sphere, smooth_union
from ..utils.image import write_png
from ..utils.ply import load_ply, save_ply
from . import add_device_option, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--method", choices=("oracle", "tiles", "kernel"), default="tiles",
                    help="'kernel' = the hand-written forward and backward blend "
                         "kernels (ops/tile_blend_diff.py): the fast path on the card")
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--views", type=int, default=1,
                    help="fit against this many orbit-ring views jointly")
    ap.add_argument("--fields", type=str, default="cr,cg,cb,opacity",
                    help="comma-separated splat fields to optimize "
                         "(any of cr,cg,cb,opacity,px,py,pz,radius)")
    ap.add_argument("--out", type=str, default=None,
                    help="write <out>_target/init/fit.png")
    ap.add_argument("--ply-in", type=str, default=None,
                    help="fit THIS 3DGS .ply scene instead of the demo "
                         "scene's modeled splats (utils/ply.py)")
    ap.add_argument("--ply-out", type=str, default=None,
                    help="export the fitted splats as a 3DGS .ply")
    ap.add_argument("--sh", action="store_true",
                    help="view-dependent color (render/sh.py): keep a "
                         "--ply-in scene's f_rest bands lighting every view, "
                         "or (without --ply-in) FIT degree-1 coefficients "
                         "from zero alongside --fields")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="checkpoint the training state here every 25 "
                         "steps and resume from it if it exists")
    ap.add_argument("--dataset", type=str, default=None,
                    help="train from a datagen --gbuffer dataset directory "
                         "instead of synthesizing targets: geometry "
                         "initializes by backprojecting the depth/alpha "
                         "channels (data.backproject_gbuffer), targets are "
                         "the dataset images, all views are used "
                         "(--views/--size/--ply-in ignored)")
    ap.add_argument("--depth-weight", type=float, default=0.0,
                    help="dataset mode: add depth_weight * masked-L1 between "
                         "the rendered expected-depth channel and the "
                         "dataset's depth maps (RGB-D supervision through "
                         "render_diff_gbuffer)")
    add_device_option(ap)
    return ap.parse_args(argv)


def _fields(args):
    return tuple(f.strip() for f in args.fields.split(",") if f.strip())


def _write_pngs(out: str, images) -> None:
    for tag, img in images:
        path = f"{out}_{tag}.png"
        write_png(path, torch.clamp(img, 0, 1))
        print("wrote", path)


def dataset_config(ds: dict) -> RenderConfig:
    """--dataset mode's render configuration for a loaded dataset."""
    return RenderConfig(width=ds["width"], height=ds["height"], tiles_per_splat_cap=8)


def _fit_dataset(args, device):
    """--dataset mode: load a datagen --gbuffer dataset, lift its depth and
    alpha channels into a splat cloud (data.backproject_gbuffer) and fit
    the requested fields against its images: geometry, colours and cameras
    all come from disk."""
    ds = load_dataset(args.dataset, gbuffer=True, device=device)
    cfg = dataset_config(ds)
    splats = backproject_gbuffer(ds, n_max=args.n if args.n else None, device=device)
    n = splats["px"].shape[0]
    print(f"backprojected {n} splats from {len(ds['cameras'])} views of {args.dataset}")

    fit_fields = _fields(args)
    appearance = set(fit.FIT_FIELDS_APPEARANCE)
    init = {k: torch.full_like(splats[k], 0.5) for k in fit_fields if k in appearance}

    depth_targets = None
    if args.depth_weight > 0:
        if ds.get("depth") is None:
            raise SystemExit("--depth-weight needs a --gbuffer dataset "
                             "(no depth channel in the manifest)")
        if args.method == "oracle":
            raise SystemExit("--depth-weight requires --method tiles or kernel "
                             "(the oracle renders no depth channel)")
        depth_targets = ds["depth"]
        print(f"RGB-D fitting: depth L1 weight {args.depth_weight}")

    t0 = time.perf_counter()
    fitted, losses = fit.fit_splats(
        splats, ds["cameras"], ds["images"], cfg, fields=fit_fields,
        steps=args.steps, lr=args.lr, method=args.method, init=init,
        log_every=10, checkpoint_path=args.checkpoint,
        checkpoint_every=25 if args.checkpoint else 0,
        resume=bool(args.checkpoint),
        depth_targets=depth_targets, depth_weight=args.depth_weight,
    )
    dt = time.perf_counter() - t0
    print(f"{args.steps} optimization steps in {dt:.1f} s "
          f"({1e3 * dt / args.steps:.1f} ms/step, {n} splats, "
          f"{len(ds['cameras'])} views, fields={','.join(fit_fields)}, "
          f"final psnr {float(fit.psnr(losses[-1])):.1f} dB)")
    if args.out:
        cam = ds["cameras"][0]
        with torch.no_grad():
            _write_pngs(args.out, (
                ("target", ds["images"][0]),
                ("init", render_diff(dict(splats, **init), cam, cfg, method=args.method)),
                ("fit", render_diff(fitted, cam, cfg, method=args.method)),
            ))
    if args.ply_out:
        save_ply(args.ply_out, fitted)
        print("wrote", args.ply_out)
    return fitted, losses


def main(argv: Optional[Sequence[str]] = None):
    """Run the fit; returns (fitted splats, (steps,) losses)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.dataset:
        return _fit_dataset(args, device)

    scene = SDFScene(smooth_union(0.15, Sphere(id="s1", radius=0.5),
                                  Box(id="b1", position=(0.6, 0, 0), size=(0.3, 0.3, 0.3))))
    cfg = RenderConfig(width=args.size, height=args.size, base_radius=0.05,
                       tiles_per_splat_cap=16)
    cameras = [
        camera_tensors(Camera(azimuth=0.5 + 2.0 * 3.14159265 * v / max(args.views, 1),
                              elevation=0.3, aspect=1.0).arrays(), device)
        for v in range(args.views)
    ]
    gen = torch.Generator(device=device).manual_seed(0)
    sh = None
    fit_sh = False
    if args.ply_in:
        if args.sh:
            splats, sh = load_ply(args.ply_in, with_sh=True, device=device)
            print(f"loaded SH degree {sh_degree(sh)}" if sh is not None
                  else "no f_rest bands in file")
        else:
            splats = load_ply(args.ply_in, device=device)
        print(f"loaded {splats['px'].shape[0]} splats from {args.ply_in}")
    else:
        splats = model_points(scene, scene.params(device), gen, args.n, PointConfig(), cfg,
                              device=device)
        if args.sh:  # no file bands: fit degree-1 coefficients from zero
            n_s = splats["px"].shape[0]
            sh = {c: 0.25 * torch.randn((3, n_s), generator=gen, device=device)
                  for c in ("r", "g", "b")}
            fit_sh = True

    targets = fit.render_targets(splats, cameras, cfg, method=args.method, sh=sh)
    if fit_sh:  # targets carry the synthetic truth; the fit starts from zero
        sh = {c: torch.zeros_like(v) for c, v in sh.items()}
    camera, target = cameras[0], targets[0]

    fit_fields = _fields(args)
    appearance = set(fit.FIT_FIELDS_APPEARANCE)
    init = {}
    for k in fit_fields:
        if k in appearance:  # gray/flat start: recover appearance
            init[k] = torch.full_like(splats[k], 0.5)
        else:  # geometry: perturb the truth, recover shape
            init[k] = splats[k] + 0.02 * torch.randn(splats[k].shape, generator=gen,
                                                     device=device)

    t0 = time.perf_counter()
    res = fit.fit_splats(
        splats, cameras, targets, cfg, fields=fit_fields, steps=args.steps,
        lr=args.lr, method=args.method, init=init, log_every=10,
        checkpoint_path=args.checkpoint,
        checkpoint_every=25 if args.checkpoint else 0,
        resume=bool(args.checkpoint),
        sh=sh, fit_sh=fit_sh,
    )
    fitted, losses = res[0], res[1]
    sh_fitted = res[2] if fit_sh else sh
    dt = time.perf_counter() - t0
    print(f"{args.steps} optimization steps in {dt:.1f} s "
          f"({1e3 * dt / args.steps:.1f} ms/step, {args.n} splats, "
          f"{args.size}x{args.size}, {args.views} view(s), "
          f"fields={','.join(fit_fields)}, method={args.method}, "
          f"final psnr {float(fit.psnr(losses[-1])):.1f} dB)")

    if args.out:
        def lit(s, sh_):
            return apply_sh(s, sh_, camera["cam_pos"]) if sh_ is not None else s

        with torch.no_grad():
            _write_pngs(args.out, (
                ("target", target),
                ("init", render_diff(lit(dict(splats, **init), sh), camera, cfg,
                                     method=args.method)),
                ("fit", render_diff(lit(fitted, sh_fitted), camera, cfg, method=args.method)),
            ))
    if args.ply_out:
        save_ply(args.ply_out, fitted, sh=sh_fitted)
        print("wrote", args.ply_out)
    return fitted, losses


if __name__ == "__main__":
    main()
