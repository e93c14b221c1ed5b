#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (nvcc).  It builds the hand-written kernels from the sources in the
checkout, holds each against its plain PyTorch twin, drives the main path
(`Engine.frame`) at the bench headline size, and checks the images.  Phases:

  1. device name and power limit; build or load the kernels
  2. tile-blend kernel vs its plain twin on random record streams, every
     profile, 16x16 and 32x16 tiles: max-abs <= 2e-5 at eps = 0, and
     eps = 0.01 within 0.0101 of eps = 0
  3. Engine.frame, 1M splats at 1920x1080 on 32x16 tiles (cap 4), 5
     animated frames: finite images, coverage above a floor, and the
     kernel's launch count; per-stage CUDA-event times
  4. the same Engine on the opaque oriented surface preset, 2 frames
  5. one 1280x720 frame through the kernel and through the twin, and a
     small frame against the exact oracle
  6. the differentiable blend's forward (K4) and backward (K5) kernels vs
     their plain twin on random plane streams, 20k splats at 256x256,
     isotropic and oriented, 16x16 and 32x16 tiles: forward max-abs
     <= 2e-5, every field's gradient within max-relative 1e-4 (isotropic)
     / 1e-3 (oriented), two backward runs bit-identical
  7. the training path at the repo's training metric: 200k splats at
     512x512 (cap 4), one MSE value-and-grad step over colour and opacity
     (CUDA-event forward/backward/step times), then `fit_splats`, 5 Adam
     steps over 8 fields, whose loss must fall; K4/K5 launch counts; the
     kernels alone at that stream vs the twin
  8. the quality fit: 10k splats at 256x256, 6 views, half the splats
     killed, 60 steps with density control; held-out PSNR in (0, 80) and
     above the degraded start + 3 dB

It prints one JSON line describing the kernels (each with its time, the
twin's time and the least time the card could take for the same work),
then, as its last line,
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code is
non-zero and the last line is never printed; without a CUDA device it exits
non-zero at once.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

EPS_TOL = 2e-5  # kernel vs plain twin / oracle at eps = 0
EARLY_EXIT_TOL = 0.0101  # eps = 0.01 vs eps = 0 (transmittance floor + rounding)
COVERAGE_FLOOR = 0.05  # share of pixels off the background in a demo frame
BG_TOL = 1e-3
DIFF_GRAD_TOL = {"isotropic": 1e-4, "oriented": 1e-3}  # tests/test_diff.py's gates
FIT8 = ("px", "py", "pz", "radius", "opacity", "cr", "cg", "cb")
APPEARANCE = ("cr", "cg", "cb", "opacity")

# Peak rates of one H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s,
# FP32 FLOP/s outside the tensor cores, and the special-function units
# (16 results per SM per clock for exp2/rcp on compute capability 9.0, CUDA
# C++ Programming Guide throughput table, x 132 SMs x 1.98 GHz boost).
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SFU_OP_S = 132 * 16 * 1.98e9
# Operations per (record, pixel) evaluation that the function needs,
# isotropic Gaussian profile, whatever a kernel recomputes: every
# evaluation runs the support test once (dx, dy, dx^2 + dy^2, compare: 6
# flops); evaluations inside the support do the rest (flops, and SFU ops:
# expf).
OPS = {  # kernel -> (support-test flops, flops inside, SFU ops inside)
    "tile_blend": (6, 12, 1),
    "tile_blend_diff_fwd": (6, 14, 1),
    # one pass, reading the forward's C, A, D: alpha recompute 4,
    # transmittance 2, w = gC.c + gD.d 7, dL/da from the prefix and the
    # totals 8, its chain to op, r, cx, cy 14, colour and depth 8
    "tile_blend_diff_bwd": (6, 43, 1),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def elapsed_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of `reps` calls of fn, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def support_evals(cx, cy, cut2, binned, cfg, chunk: int = 8192):
    """(all, inside): the (pair, pixel) evaluations of a tile-sorted pair
    stream, and those inside their record's support (dist2 <= cut2;
    isotropic), counted on the device in chunks of pairs."""
    import torch

    n_pairs = int(binned["offsets"][-1])
    tp, tw = cfg.tile_pixels, cfg.tile_w
    lane = torch.arange(tp, device=cx.device)
    lx = (lane % tw).to(torch.float32) + 0.5
    ly = (lane // tw).to(torch.float32) + 0.5
    inside = 0
    for lo in range(0, n_pairs, chunk):
        tiles = binned["pair_tile"][lo:lo + chunk].long()
        ranks = binned["pair_rank"][lo:lo + chunk].long()
        dx = ((tiles % cfg.tiles_x).float() * tw)[:, None] + lx[None, :] - cx[ranks][:, None]
        dy = ((tiles // cfg.tiles_x).float() * cfg.tile_h)[:, None] + ly[None, :] - cy[ranks][:, None]
        inside += int(((dx * dx + dy * dy) <= cut2[ranks][:, None]).sum())
    return n_pairs * tp, inside


def bound(name: str, n_bytes: float, evals: int, inside: int):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and the
    operations over their peak rates."""
    test, flops_in, sfu_in = OPS[name]
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max((evals * test + inside * flops_in) / FP32_FLOP_S,
                inside * sfu_in / SFU_OP_S)
    return (t_bytes * 1e3, "bytes") if t_bytes > t_ops else (t_ops * 1e3, "operations")


def random_planes(dev, cfg, n: int, seed: int):
    """Random continuous record planes in blend_planes' argument order, over
    (and just beyond) the viewport: repeated depths, some culled records,
    and a third of the opacities exactly 1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 10.0, n)
    depth[n // 2: n // 2 + 50] = depth[:50]
    depth[-20:] = np.inf
    cols = [
        rng.uniform(-10, cfg.width + 10, n), rng.uniform(-10, cfg.height + 10, n),
        rng.uniform(0.3, 6.0, n), np.minimum(rng.uniform(0.3, 1.2, n), 1.0),
        rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
        rng.uniform(-np.pi, np.pi, n), rng.uniform(0.05, 1.0, n), depth,
    ]
    return [torch.tensor(c, dtype=torch.float32, device=dev).requires_grad_(True) for c in cols]


def blend_and_grads(fn, cfg, planes, cots):
    """Outputs of fn(cfg, *planes) and the gradients of sum(out * cot)."""
    import torch

    outs = fn(cfg, *planes)
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    grads = torch.autograd.grad(loss, planes, allow_unused=True, materialize_grads=True)
    return [o.detach() for o in outs], grads


def phase6_diff_kernels(dev, card: str, n: int = 20_000, size: int = 256):
    """K4/K5 vs the twin on random plane streams; returns (forward max-abs,
    gradient max-abs, gradient max-relative)."""
    import torch

    from splat_renderer_tpu_torch import RenderConfig
    from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_planes, blend_planes_plain

    names = ("cx", "cy", "radius", "opacity", "r", "g", "b", "angle", "ratio", "depth")
    errs = [0.0, 0.0, 0.0]
    for seed, (prof, extra) in enumerate((("isotropic", {}), ("oriented", dict(oriented=True)))):
        for tiles in (dict(tile_size=16), dict(tile_size=32, tile_height=16)):
            cfg = RenderConfig(width=size, height=size, tiles_per_splat_cap=8, **extra, **tiles)
            planes = random_planes(dev, cfg, n, seed)
            g = torch.Generator(device=dev).manual_seed(seed)
            t, tp = cfg.num_tiles, cfg.tile_pixels
            cots = [torch.rand(s, generator=g, device=dev) - 0.5
                    for s in ((t, tp, 3), (t, tp), (t, tp))]
            k_out, k_grads = blend_and_grads(blend_planes, cfg, planes, cots)
            p_out, p_grads = blend_and_grads(blend_planes_plain, cfg, planes, cots)
            _, k_grads2 = blend_and_grads(blend_planes, cfg, planes, cots)
            torch.cuda.synchronize()
            d_fwd = max(float((a - b).abs().max()) for a, b in zip(k_out, p_out))
            check(d_fwd <= EPS_TOL, f"{prof}: K4 vs twin {d_fwd}")
            rel, d_abs = {}, 0.0
            for name, kg, pg in zip(names, k_grads, p_grads):
                if not cfg.oriented and name in ("angle", "ratio"):
                    check(float(kg.abs().max()) == 0.0, f"isotropic {name} gradient")
                    continue
                diff = float((kg - pg).abs().max())
                d_abs = max(d_abs, diff)
                rel[name] = diff / (float(pg.abs().max()) + 1e-12)
                check(rel[name] < DIFF_GRAD_TOL[prof], f"{prof}: K5 {name} max-rel {rel[name]}")
            same = all(torch.equal(a, b) for a, b in zip(k_grads, k_grads2))
            check(same, f"{prof}: two backward runs differ")
            errs = [max(errs[0], d_fwd), max(errs[1], d_abs), max(errs[2], max(rel.values()))]
            log(f"phase 6: {prof:9s} {cfg.tile_w}x{cfg.tile_h} n={n} @{size}x{size}: K4 vs twin "
                f"max-abs {d_fwd:.3g} (<= {EPS_TOL}); K5 gradient max-rel "
                f"{max(rel.values()):.3g} (< {DIFF_GRAD_TOL[prof]}, worst {max(rel, key=rel.get)}); "
                f"backward bit-identical on rerun: {same}; {card}")
    return errs


def phase7_training_step(dev, card: str, n: int = 200_000, size: int = 512, fit_steps: int = 5):
    """The repo's training metric and the trainer's main path on the card."""
    import statistics

    import torch

    from splat_renderer_tpu_torch import Camera, PointConfig, RenderConfig
    from splat_renderer_tpu_torch._torch_util import clip
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.fit import fit_splats
    from splat_renderer_tpu_torch.ops.tile_blend_diff import (
        blend_binned_plain, diff_backward, diff_forward,
    )
    from splat_renderer_tpu_torch.render.binning import bin_planes_diff
    from splat_renderer_tpu_torch.render.compositor import tiles_to_image
    from splat_renderer_tpu_torch.render.diff import render_diff
    from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points
    from splat_renderer_tpu_torch.render.projector import shade_planes

    cfg = RenderConfig(width=size, height=size, base_radius=0.008, tiles_per_splat_cap=4)
    scene = demo_scene()
    spl = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(7),
                       n, PointConfig(), cfg, device=dev)
    cam = camera_tensors(Camera(aspect=1.0).arrays(), dev)
    with torch.no_grad():
        target = render_diff(spl, cam, cfg, method="kernel")

    def value_and_grad():
        theta = {k: torch.full_like(spl[k], 0.5).requires_grad_(True) for k in APPEARANCE}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        img = render_diff(dict(spl, **theta), cam, cfg, method="kernel")
        loss = torch.mean((img - target) ** 2)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(theta.values()))
        ev[2].record()
        return loss, grads, ev

    value_and_grad()  # warm-up
    times = {"forward": [], "backward": [], "step": []}
    for _ in range(7):
        loss, grads, ev = value_and_grad()
        torch.cuda.synchronize()
        times["forward"].append(ev[0].elapsed_time(ev[1]))
        times["backward"].append(ev[1].elapsed_time(ev[2]))
        times["step"].append(ev[0].elapsed_time(ev[2]))
    for k, gk in zip(APPEARANCE, grads):
        check(bool(torch.isfinite(gk).all()), f"non-finite {k} gradient")
        check(float(gk.abs().max()) > 0, f"zero {k} gradient")
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"phase 7: training step {n // 1000}k @{size}x{size} cap 4, MSE over "
        f"{'/'.join(APPEARANCE)}: loss {float(loss.detach()):.4g}, gradients finite and "
        "non-zero; median of 7 ms (CUDA events) "
        + " ".join(f"{k} {v:.3f}" for k, v in med.items()) + f"; {card}")

    # the step's forward by stage (no autograd), median of 5
    def planes_of(s):
        c = shade_planes(s, cam["view_proj"], cam["cam_pos"], cfg)
        out = {k: c[k] for k in ("cx", "cy", "radius", "angle", "ratio", "depth")}
        out.update({k: clip(c[k], 0.0, 1.0) for k in ("opacity", "r", "g", "b")})
        return out

    stage_names = ("project", "bin", "K4", "image+loss")
    stages = {k: [] for k in stage_names}
    theta = {k: torch.full_like(spl[k], 0.5) for k in APPEARANCE}
    with torch.no_grad():
        for _ in range(6):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            planes = planes_of(dict(spl, **theta))
            ev[1].record()
            binned = bin_planes_diff(planes, cfg)
            ev[2].record()
            outs = diff_forward(binned, cfg)
            ev[3].record()
            torch.mean((tiles_to_image(outs[0], outs[1], cfg) - target) ** 2)
            ev[4].record()
            torch.cuda.synchronize()
            for k, (a, b) in zip(stage_names, zip(ev[:-1], ev[1:])):
                stages[k].append(a.elapsed_time(b))
    stage_med = {k: statistics.median(v[1:]) for k, v in stages.items()}
    # device busy share over 3 steps, from the profiler's kernel times
    from torch.profiler import ProfilerActivity, profile

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0.record()
        for _ in range(3):
            value_and_grad()
        e1.record()
        torch.cuda.synchronize()
    wall = e0.elapsed_time(e1) / 3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    n_kernels = sum(e.count for e in kernels) / 3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    log(f"phase 7: step forward by stage, median of 5 ms (CUDA events, no autograd) "
        + " ".join(f"{k} {v:.3f}" for k, v in stage_med.items())
        + f"; profiled step {wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.3f}), "
        f"{n_kernels:.0f} kernels/step; top: "
        + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / 3:.3f} ms x{e.count // 3}"
                    for e in top) + f"; {card}")

    # the trainer's main path: these launches are the ones reported
    diff_forward.launches = diff_backward.launches = 0
    e0.record()
    _, losses = fit_splats(spl, [cam], [target], cfg, fields=FIT8, steps=fit_steps, lr=1e-3,
                           init={k: torch.full_like(spl[k], 0.5) for k in APPEARANCE})
    e1.record()
    torch.cuda.synchronize()
    launches = (diff_forward.launches, diff_backward.launches)
    check(launches == (fit_steps, fit_steps), f"fit_splats launched K4/K5 {launches} times")
    curve = [float(v) for v in losses]
    check(all(map(lambda v: v == v and abs(v) < float("inf"), curve)), "non-finite fit loss")
    check(curve[-1] < curve[0], f"fit loss did not fall: {curve}")
    log(f"phase 7: fit_splats {fit_steps} Adam steps over {len(FIT8)} fields: loss "
        + " ".join(f"{v:.4g}" for v in curve)
        + f"; K4/K5 launches {launches[0]}/{launches[1]}; {e0.elapsed_time(e1) / fit_steps:.3f} "
        f"ms/step (CUDA events); {card}")

    # the kernels alone at this stream, against the twin
    binned = bin_planes_diff(planes_of(spl), cfg)
    outs = diff_forward(binned, cfg)
    g = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.rand(o.shape, generator=g, device=dev) - 0.5 for o in outs]
    k_grads = diff_backward(binned, cfg, cots)
    k_ms = elapsed_ms(lambda: diff_forward(binned, cfg), 20)
    b_ms = elapsed_ms(lambda: diff_backward(binned, cfg, cots), 20)
    with torch.no_grad():
        p_out = blend_binned_plain(binned, cfg)
        p_ms = elapsed_ms(lambda: blend_binned_plain(binned, cfg), 2)
    d_fwd = max(float((a - b).abs().max()) for a, b in zip(outs, p_out))
    check(d_fwd <= EPS_TOL, f"200k stream: K4 vs twin {d_fwd}")
    twin = dict(binned, planes=binned["planes"].detach().clone().requires_grad_(True))
    torch.cuda.reset_peak_memory_stats()
    p_outs = blend_binned_plain(twin, cfg)
    loss = sum((o * ct).sum() for o, ct in zip(p_outs, cots))
    torch.cuda.synchronize()
    e0.record()
    (p_grad,) = torch.autograd.grad(loss, twin["planes"])
    e1.record()
    torch.cuda.synchronize()
    pb_ms = e0.elapsed_time(e1)
    twin_gib = torch.cuda.max_memory_allocated() / 2**30
    k_rank = k_grads[binned["src"]]  # input order -> rank order, as the twin's
    d_bwd = float((k_rank - p_grad).abs().max())
    rel = float(((k_rank - p_grad).abs().amax(0) / (p_grad.abs().amax(0) + 1e-12)).max())
    check(rel < DIFF_GRAD_TOL["isotropic"], f"200k stream: K5 vs twin max-rel {rel}")

    pl = binned["planes"]
    r = pl[:, 2]
    cut2 = torch.where(r >= cfg.min_screen_radius, cfg.bounds_margin ** 2 * (r * r), -1.0)
    evals, inside = support_evals(pl[:, 0], pl[:, 1], cut2, binned, cfg)
    n_pairs = int(binned["offsets"][-1])
    t, tp, nf = cfg.num_tiles, cfg.tile_pixels, pl.shape[1]
    head = (t + 1) * 4 + n_pairs * 4 + pl.shape[0] * nf * 4  # offsets, ranks, planes
    fwd_bytes = head + t * tp * 5 * 4
    # + slots, cotangents, the forward's residuals, rows
    bwd_bytes = head + n_pairs * 4 + 2 * t * tp * 5 * 4 + n_pairs * nf * 4
    fb = bound("tile_blend_diff_fwd", fwd_bytes, evals, inside)
    bb = bound("tile_blend_diff_bwd", bwd_bytes, evals, inside)
    log(f"phase 7: kernels at the {n // 1000}k @{size}x{size} stream ({n_pairs} pairs, "
        f"{inside} of {evals} evaluations inside the support): K4 {k_ms:.3f} ms (bound "
        f"{fb[0]:.4f} ms, {fb[1]}), twin {p_ms:.3f} ms, max-abs {d_fwd:.3g}; K5 {b_ms:.3f} ms "
        f"(bound {bb[0]:.4f} ms, {bb[1]}), twin backward {pb_ms:.3f} ms (peak {twin_gib:.2f} "
        f"GiB), max-rel {rel:.3g}; {card}")
    return dict(launches=launches, fwd=(k_ms, p_ms, fb, d_fwd), bwd=(b_ms, pb_ms, bb, d_bwd))


def phase8_quality_fit(dev, card: str, qn: int = 10_000, qres: int = 256, qsteps: int = 60):
    """bench.py's training-quality check: a multi-view re-fit of a degraded
    splat set with density control, scored by held-out PSNR on the host."""
    import math

    import numpy as np
    import torch

    from splat_renderer_tpu_torch import Camera, PointConfig, RenderConfig
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.fit import fit_splats
    from splat_renderer_tpu_torch.render.diff import render_diff
    from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points

    cfg = RenderConfig(width=qres, height=qres, base_radius=0.03, tiles_per_splat_cap=9)
    scene = demo_scene()
    spl = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(8),
                       qn, PointConfig(), cfg, device=dev)

    def cam_at(az, el=0.3):
        return camera_tensors(Camera(azimuth=az, elevation=el, aspect=1.0).arrays(), dev)

    cams = [cam_at(0.4 + 2 * math.pi * v / 6, 0.3 if v % 2 == 0 else 0.7) for v in range(6)]
    held_out = cam_at(0.4 + math.pi / 6, 0.5)

    def render(s, c):
        with torch.no_grad():
            return render_diff(s, c, cfg, method="kernel")

    targets = [render(spl, c) for c in cams]
    truth = render(spl, held_out).cpu().numpy()
    kill = np.zeros(qn, bool)
    kill[np.random.default_rng(7).choice(qn, qn // 2, replace=False)] = True
    kt = torch.as_tensor(kill, device=dev)
    degraded = dict(spl, radius=torch.where(kt, 0.0, spl["radius"]),
                    opacity=torch.where(kt, 0.0, spl["opacity"]))
    t0 = time.perf_counter()
    fitted, losses = fit_splats(degraded, cams, targets, cfg, fields=FIT8, steps=qsteps,
                                lr=2e-3, densify_every=qsteps // 3, densify_threshold=1e-7)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    img = render(fitted, held_out).cpu().numpy()
    img0 = render(degraded, held_out).cpu().numpy()
    psnr = -10.0 * np.log10(max(float(np.mean((img - truth) ** 2)), 1e-12))
    psnr0 = -10.0 * np.log10(max(float(np.mean((img0 - truth) ** 2)), 1e-12))
    check(0.0 < psnr < 80.0, f"fit PSNR out of range: {psnr}")
    check(psnr > psnr0 + 3.0, f"fit did not improve held-out PSNR: {psnr0:.2f} -> {psnr:.2f}")
    log(f"phase 8: quality fit {qn // 1000}k @{qres}x{qres}, 6 views, {qsteps} steps with "
        f"density control: held-out PSNR {psnr0:.2f} -> {psnr:.2f} dB (> +3); train loss "
        f"{float(losses[0]):.4g} -> {float(losses[-1]):.4g}; {fit_s:.1f} s host clock; {card}")
    return psnr0, psnr


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    import numpy as np

    import splat_renderer_tpu_torch as spt
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.convert import splats_from_numpy
    from splat_renderer_tpu_torch.ops import build
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
    from splat_renderer_tpu_torch.points import point_count
    from splat_renderer_tpu_torch.render.binning import bin_packed_words
    from splat_renderer_tpu_torch.render.compositor import tiles_to_image
    from splat_renderer_tpu_torch.render.pipeline import (
        Engine, animate_demo, demo_scene, model_points, render_splats,
    )
    from splat_renderer_tpu_torch.render.packing import U32_MASK, unpack_words
    from splat_renderer_tpu_torch.render.projector import splat_screen_words

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # ---- phase 1: device, kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = smi  # name and power limit, beside every time
    t0 = time.perf_counter()
    sources = ("tile_blend", "tile_blend_diff")
    build.build_all(sources)  # one nvcc per source, in parallel
    for name in sources:
        build.load_library(name)
    log(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; kernels built/loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{k} {build.build_seconds[k]:.2f} s" for k in sources) + ")")

    def words_and_bins(splats, cam, cfg):
        w = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], cfg)
        return bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], cfg)

    def max_diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    max_err = 0.0

    # ---- phase 2: kernel vs plain twin on random record streams ----
    rng = np.random.default_rng(0)
    n = 60_000
    pos = rng.uniform(-1, 1, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
        "radius": rng.uniform(0.002, 0.03, n), "cr": rng.uniform(0, 1, n),
        "cg": rng.uniform(0, 1, n), "cb": rng.uniform(0, 1, n),
        "opacity": rng.uniform(0.2, 1.0, n),
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    }
    rand_splats = splats_from_numpy(planes, dev)
    profiles = {
        "isotropic": {}, "oriented": dict(oriented=True),
        "ewa": dict(oriented=True, ellipse="ewa"),
        "opaque": dict(opaque=True, oriented=True),
        "quad": dict(opaque=True, oriented=True, quad=True),
    }
    for tiles in (dict(tile_size=16), dict(tile_size=32, tile_height=16)):
        cfg0 = spt.RenderConfig(width=960, height=540, tiles_per_splat_cap=8, **tiles)
        cam = camera_tensors(spt.Camera(aspect=960 / 540).arrays(), dev)
        for name, prof in profiles.items():
            cfg = cfg0.replace(**prof)
            binned = words_and_bins(rand_splats, cam, cfg)
            exact = blend_tiles(binned, cfg, eps=0.0)
            plain = blend_tiles_plain(binned, cfg, eps=0.0)
            early = blend_tiles(binned, cfg, eps=0.01)
            sync()
            d0, de = max_diff(exact, plain), max_diff(early, exact)
            max_err = max(max_err, d0)
            log(f"phase 2: {name:9s} {cfg.tile_w}x{cfg.tile_h} pairs "
                f"{int(binned['offsets'][-1])}: kernel vs twin max-abs {d0:.3g} "
                f"(<= {EPS_TOL}), eps 0.01 vs 0 {de:.3g} (<= {EARLY_EXIT_TOL})")
            check(d0 <= EPS_TOL, f"{name}: kernel vs twin {d0}")
            check(de <= EARLY_EXIT_TOL, f"{name}: early exit {de}")

    # ---- phase 3: the main path, 1M splats at 1080p ----
    scene = demo_scene()
    pcfg = spt.PointConfig()
    rcfg = spt.RenderConfig(width=1920, height=1080, base_radius=0.008,
                            tiles_per_splat_cap=4, tile_size=32, tile_height=16)
    cam = camera_tensors(spt.Camera(aspect=1920 / 1080).arrays(), dev)
    bg = torch.tensor(rcfg.background, device=dev)
    eng = Engine(scene, pcfg, rcfg, n=1_000_000, device=dev)
    eng.frame(cam, torch.Generator(device=dev).manual_seed(99))  # warm-up
    sync()

    def run_frames(engine, count, t_offset, seed0):
        frame_ms, shares = [], []
        for i in range(count):
            animate_demo(engine.scene, t_offset + 0.25 * i)
            g = torch.Generator(device=dev).manual_seed(seed0 + i)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            img = engine.frame(cam, g)
            e1.record()
            sync()
            frame_ms.append(e0.elapsed_time(e1))
            check(img.shape == (engine.rcfg.height, engine.rcfg.width, 3), "image shape")
            check(bool(torch.isfinite(img).all()), "non-finite pixels")
            share = float(((img - bg).abs().sum(-1) > BG_TOL).float().mean())
            check(share > COVERAGE_FLOOR, f"coverage {share} <= {COVERAGE_FLOOR}")
            shares.append(share)
        return frame_ms, shares

    blend_tiles.launches = 0
    frame_ms, shares = run_frames(eng, 5, 0.0, 0)
    main_launches = blend_tiles.launches
    check(main_launches >= 5, f"tile_blend launched {main_launches} times in 5 frames")
    log(f"phase 3: Engine 1M @1920x1080 32x16 cap 4, 5 frames: tile_blend launches "
        f"{main_launches}; coverage {min(shares):.3f}..{max(shares):.3f} "
        f"(> {COVERAGE_FLOOR}); frame ms (CUDA events) "
        + " ".join(f"{t:.2f}" for t in frame_ms))

    # per-stage CUDA-event times at the same shape
    stages = {k: [] for k in ("model", "project", "bin", "blend", "image", "frame")}
    params = scene.params(dev)
    for i in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        g = torch.Generator(device=dev).manual_seed(i)
        ev[0].record()
        splats = model_points(scene, params, g, 1_000_000, pcfg, rcfg, device=dev)
        ev[1].record()
        w = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], rcfg)
        ev[2].record()
        binned = bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], rcfg)
        ev[3].record()
        tiles_out = blend_tiles(binned, rcfg)
        ev[4].record()
        img = tiles_to_image(*tiles_out, rcfg)
        ev[5].record()
        sync()
        for k, (a, b) in zip(("model", "project", "bin", "blend", "image"),
                             zip(ev[:-1], ev[1:])):
            stages[k].append(a.elapsed_time(b))
        stages["frame"].append(ev[0].elapsed_time(ev[5]))
    med = {k: statistics.median(v) for k, v in stages.items()}
    log(f"phase 3: stage ms, median of 5 (CUDA events; {card}): "
        + " ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f"; pairs {int(binned['offsets'][-1])}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel alone vs its plain twin at the main path's shape
    exact = blend_tiles(binned, rcfg, eps=0.0)
    plain = blend_tiles_plain(binned, rcfg, eps=0.0, pair_chunk=8192)
    sync()
    d_main = max_diff(exact, plain)
    max_err = max(max_err, d_main)
    check(d_main <= EPS_TOL, f"1M frame: kernel vs twin {d_main}")

    kernel_ms = elapsed_ms(lambda: blend_tiles(binned, rcfg), 20)
    plain_ms = elapsed_ms(lambda: blend_tiles_plain(binned, rcfg, pair_chunk=8192), 3)
    kernel_ms_2 = elapsed_ms(lambda: blend_tiles(binned, rcfg), 20)
    # eps = 0 (no early exit): the work is every pair against every pixel
    # of its tile, which the bound counts
    exact_ms = elapsed_ms(lambda: blend_tiles(binned, rcfg, eps=0.0), 20)
    plain_exact_ms = elapsed_ms(
        lambda: blend_tiles_plain(binned, rcfg, eps=0.0, pair_chunk=8192), 3)
    u32 = lambda w: w.to(torch.int64) & U32_MASK  # noqa: E731
    cx, cy, r = unpack_words(u32(binned["rec_pos"]), u32(binned["rec_ro"]),
                             u32(binned["rec_rgb"]), rcfg)[:3]
    cut2 = torch.where(r >= rcfg.min_screen_radius, rcfg.bounds_margin ** 2 * (r * r), -1.0)
    evals, inside = support_evals(cx, cy, cut2, binned, rcfg)
    n_main = int(binned["offsets"][-1])
    k1_bytes = ((rcfg.num_tiles + 1) * 4 + n_main * 4 + cx.shape[0] * 12
                + rcfg.num_tiles * rcfg.tile_pixels * 16)
    k1_bound = bound("tile_blend", k1_bytes, evals, inside)
    log(f"phase 3: tile_blend at the 1M @1080p stream: kernel {kernel_ms:.3f} / "
        f"{kernel_ms_2:.3f} ms at eps {rcfg.transmittance_eps}, plain twin (pair_chunk 8192) "
        f"{plain_ms:.3f} ms; at eps 0: kernel {exact_ms:.3f} ms, twin {plain_exact_ms:.3f} ms, "
        f"bound {k1_bound[0]:.4f} ms ({k1_bound[1]}; {inside} of {evals} evaluations inside "
        f"the support), max-abs {d_main:.3g}; {card}")

    # ---- phase 4: opaque oriented surface preset, 2 frames ----
    scene4 = demo_scene()
    eng4 = Engine(scene4, pcfg, spt.surface_render_config(1920, 1080, tiles_per_splat_cap=8),
                  n=1_000_000, device=dev)
    before = blend_tiles.launches
    frame_ms4, shares4 = run_frames(eng4, 2, 0.5, 10)
    check(blend_tiles.launches - before == 2, "surface frames did not launch the kernel")
    log(f"phase 4: surface preset Engine n={eng4.n} @1920x1080, 2 frames: coverage "
        f"{min(shares4):.3f}..{max(shares4):.3f}; frame ms "
        + " ".join(f"{t:.2f}" for t in frame_ms4))

    # ---- phase 5: mid-size frame, kernel vs twin; small frame vs oracle ----
    scene5 = demo_scene()
    cfg5 = spt.RenderConfig(width=1280, height=720, base_radius=0.015, tiles_per_splat_cap=8)
    cam5 = camera_tensors(spt.Camera(aspect=1280 / 720).arrays(), dev)
    n5 = point_count(scene5, pcfg)
    spl5 = model_points(scene5, scene5.params(dev), torch.Generator(device=dev).manual_seed(5),
                        n5, pcfg, cfg5, device=dev)
    b5 = words_and_bins(spl5, cam5, cfg5)
    img_k = tiles_to_image(*blend_tiles(b5, cfg5, eps=0.0), cfg5)
    img_p = tiles_to_image(*blend_tiles_plain(b5, cfg5, eps=0.0), cfg5)
    sync()
    d5 = float((img_k - img_p).abs().max())
    max_err = max(max_err, d5)
    check(d5 <= EPS_TOL, f"1280x720 frame: kernel vs twin {d5}")
    cfg_o = spt.RenderConfig(width=256, height=256, base_radius=0.02, tiles_per_splat_cap=8)
    cam_o = camera_tensors(spt.Camera().arrays(), dev)
    spl_o = model_points(scene5, scene5.params(dev), torch.Generator(device=dev).manual_seed(6),
                         10_000, pcfg, cfg_o, device=dev)
    img_o = render_splats(spl_o, cam_o, cfg_o, "oracle", device=dev)
    img_ko = render_splats(spl_o, cam_o, cfg_o, blend_eps=0.0, device=dev)
    sync()
    d_o = float((img_o - img_ko).abs().max())
    max_err = max(max_err, d_o)
    check(d_o <= EPS_TOL, f"256x256 frame: kernel vs oracle {d_o}")
    log(f"phase 5: 1280x720 demo frame (n={n5}, pairs {int(b5['offsets'][-1])}) kernel vs "
        f"twin max-abs {d5:.3g}; 256x256 10k-splat frame kernel vs oracle max-abs "
        f"{d_o:.3g} (both <= {EPS_TOL})")

    # ---- phase 6: the differentiable blend's kernels vs their twin ----
    k4_err, k5_err, _ = phase6_diff_kernels(dev, card)

    # ---- phase 7: the training step and fit_splats at 200k @512x512 ----
    p7 = phase7_training_step(dev, card)

    # ---- phase 8: the quality fit ----
    phase8_quality_fit(dev, card)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "splat_renderer_tpu"
                    or m.startswith("splat_renderer_tpu."))
    check(not leaked, f"JAX modules imported: {leaked}")

    def entry(name, source, replaces, launches, err, ms, plain, bnd):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    diff_src = "splat_renderer_tpu_torch/csrc/tile_blend_diff.cu"
    k4_ms, k4_plain, k4_bound, k4_main_err = p7["fwd"]
    k5_ms, k5_plain, k5_bound, k5_main_err = p7["bwd"]
    print(json.dumps({"kernels": [
        entry("tile_blend", "splat_renderer_tpu_torch/csrc/tile_blend.cu",
              "splat_renderer_tpu/ops/tile_blend.py:337", main_launches, max_err,
              exact_ms, plain_exact_ms, k1_bound),
        entry("tile_blend_diff_fwd", diff_src, "splat_renderer_tpu/ops/tile_blend_diff.py:136",
              p7["launches"][0], max(k4_err, k4_main_err), k4_ms, k4_plain, k4_bound),
        entry("tile_blend_diff_bwd", diff_src, "splat_renderer_tpu/ops/tile_blend_diff.py:199",
              p7["launches"][1], max(k5_err, k5_main_err), k5_ms, k5_plain, k5_bound),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
