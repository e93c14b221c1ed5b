#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (nvcc).  It builds the hand-written kernels from the sources in the
checkout, holds each against its plain PyTorch twin, drives the main path
(`Engine.frame`) at the bench headline size, the training path, and the
static-scene serving and datagen paths, and checks the images.  Phases:

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
  9. (inside phase 2's loop, on its streams) the depth-carrying kernel vs
     the twin: colour and alpha <= 2e-5, the premultiplied depth <= 2e-5 of
     the stream's largest depth; the cross-tile-prefetch kernel equal to the
     per-tile kernel bit for bit at eps 0 and 0.01, with and without depth
 10. static-scene serving at full width: 1M demo-scene splats with SH
     degree 3 written to a 3DGS .ply, read back, served by
     `SplatEngine(blend_kernel="tile_xp")` through the HTTP viewer (raw,
     PNG and half-size frames fetched from localhost); then CUDA-event
     times of `SplatEngine.frame` with "tile" and "tile_xp", interleaved,
     by stage, and the two kernels alone at that stream
 11. datagen: `render_gbuffer` at the 1M @1080p headline stream (and kernel
     vs method="tiles" on a 100k @512x512 cut: the plain tile compositor
     walks the pair stream 1024 pairs at a time), the depth kernel alone vs
     its twin, and `render_views`, 8 views x 2M splats @1080p as uint8
 12. the arithmetic-rate probe: float32 and bfloat16 multiply-add chains,
     kernel vs twin, and its entry point's rates

It prints one JSON line describing the six kernels (each with its launches
on its path, its time, the twin's time and the least time the card could
take for the same work),
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
# bfloat16 outside the tensor cores: two values per FP32 lane (__hfma2), the
# Hopper white paper's 133.8 TFLOP/s non-tensor BF16 peak
BF16_FLOP_S = 2 * FP32_FLOP_S
DEPTH_TOL = 2e-5  # premultiplied depth vs twin, relative to the stream's largest depth
GBUFFER_DEPTH_TOL = 1e-3  # normalized depth, kernel path vs the plain tile compositor
# Operations per (record, pixel) evaluation that the function needs,
# isotropic Gaussian profile, whatever a kernel recomputes: every
# evaluation runs the support test once (dx, dy, dx^2 + dy^2, compare: 6
# flops); evaluations inside the support do the rest (flops, and SFU ops:
# expf).
OPS = {  # kernel -> (support-test flops, flops inside, SFU ops inside)
    "tile_blend": (6, 12, 1),
    "tile_blend_xp": (6, 12, 1),  # the same function on another schedule
    "tile_blend_depth": (6, 14, 1),  # + depth * w, += per evaluation inside
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


def words_and_bins(splats, cam, cfg, with_depth=False):
    from splat_renderer_tpu_torch.render.binning import bin_packed_words
    from splat_renderer_tpu_torch.render.projector import splat_screen_words

    w = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], cfg)
    return bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], cfg,
                            with_depth=with_depth)


def max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def depth_range(binned) -> float:
    """The largest finite record depth of a depth-carrying stream."""
    import torch

    d = binned["rec_depth"].view(torch.float32)
    return float(d[torch.isfinite(d)].max())


def stream_bound(name: str, binned, cfg, with_depth: bool):
    """(bound, pairs, evaluations, inside) of a packed-word stream: the
    blend's bytes (offsets, ranks, the word planes once, the outputs once)
    and its operations on this stream's data."""
    import torch

    from splat_renderer_tpu_torch.render.packing import U32_MASK, unpack_words

    u32 = lambda w: w.to(torch.int64) & U32_MASK  # noqa: E731
    cx, cy, r = unpack_words(u32(binned["rec_pos"]), u32(binned["rec_ro"]),
                             u32(binned["rec_rgb"]), cfg)[:3]
    cut2 = torch.where(r >= cfg.min_screen_radius, cfg.bounds_margin ** 2 * (r * r), -1.0)
    evals, inside = support_evals(cx, cy, cut2, binned, cfg)
    n_pairs = int(binned["offsets"][-1])
    words, outs = (4, 5) if with_depth else (3, 4)  # planes per record; floats per pixel
    n_bytes = ((cfg.num_tiles + 1) * 4 + n_pairs * 4 + cx.shape[0] * 4 * words
               + cfg.num_tiles * cfg.tile_pixels * 4 * outs)
    return bound(name, n_bytes, evals, inside), n_pairs, evals, inside


def coverage_u8(frame, background) -> float:
    """Share of a uint8 (H, W, 3) host frame's pixels off the background."""
    import numpy as np

    bg = np.round(np.asarray(background, np.float32) * 255.0)
    return float((np.abs(frame.astype(np.float32) - bg).sum(-1) > 255.0 * BG_TOL).mean())


def phase10_static_scene(dev, card: str, n: int = 1_000_000):
    """Static-scene serving at full width: .ply with SH degree 3 -> SplatEngine
    (tile_xp) -> the HTTP viewer; then frame and stage times, tile vs tile_xp."""
    import os
    import statistics
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from splat_renderer_tpu_torch import Camera, PointConfig, RenderConfig
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.ops.tile_blend import (
        blend_tiles, blend_tiles_plain, reset_launches,
    )
    from splat_renderer_tpu_torch.render.pipeline import SplatEngine, demo_scene, model_points
    from splat_renderer_tpu_torch.render.sh import apply_sh
    from splat_renderer_tpu_torch.utils.image import read_png
    from splat_renderer_tpu_torch.utils.ply import load_ply, save_ply
    from splat_renderer_tpu_torch.viewer.serve import make_server

    width, height = 1920, 1080
    rcfg = RenderConfig(width=width, height=height, base_radius=0.008, tiles_per_splat_cap=4)
    scene = demo_scene()
    made = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(21),
                        n, PointConfig(), rcfg, device=dev)
    sh_rng = np.random.default_rng(5)
    made_sh = {c: torch.as_tensor(sh_rng.normal(scale=0.1, size=(15, n)).astype(np.float32),
                                  device=dev) for c in ("r", "g", "b")}

    # the "pre-trained scene": written as a 3DGS .ply and read back
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.ply")
        save_ply(path, made, made_sh)
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        splats, sh = load_ply(path, with_sh=True, device=dev)
    t2 = time.perf_counter()
    check(splats["px"].shape == (n,) and sh["r"].shape == (15, n), "loaded scene's shapes")
    for k in ("px", "py", "pz"):
        check(torch.equal(splats[k], made[k]), f"ply round trip: {k}")
    for c in ("r", "g", "b"):
        check(torch.equal(sh[c], made_sh[c]), f"ply round trip: sh[{c}]")
    trip = {k: float((splats[k] - made[k]).abs().max())
            for k in ("radius", "opacity", "cr", "cg", "cb", "nx", "ny", "nz")}
    check(max(trip.values()) <= 1e-4, f"ply round trip: {trip}")
    log(f"phase 10: {n} splats + SH degree 3 -> .ply ({size / 2**20:.1f} MiB, written in "
        f"{t1 - t0:.2f} s, read in {t2 - t1:.2f} s host clock): positions and SH bit-equal, "
        f"other planes within {max(trip.values()):.3g} (<= 1e-4)")

    eng_xp = SplatEngine(splats, rcfg, sh=sh, blend_kernel="tile_xp", device=dev)
    eng_tile = SplatEngine(splats, rcfg, sh=sh, blend_kernel="tile", device=dev)
    eng_flat = SplatEngine(splats, rcfg, blend_kernel="tile_xp", device=dev)  # no SH

    def cam_at(az):
        return camera_tensors(Camera(aspect=width / height, azimuth=az).arrays(), dev)

    # ---- the main path of this slice: the viewer's frames over HTTP ----
    server = make_server(eng_xp, port=0, profile_stages=False)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    reset_launches()
    try:
        def fetch(query):
            t = time.perf_counter()
            r = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame?{query}", timeout=120)
            body = r.read()
            check(r.status == 200, f"/frame?{query}: status {r.status}")
            return r, body, (time.perf_counter() - t) * 1e3

        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30).read()
        check(b"<canvas" in page, "viewer page")
        r1, raw1, ms1 = fetch("az=0.5&el=0.5&d=3.0&raw=1")
        seq = int(r1.headers["x-seq"])
        r2, raw2, ms2 = fetch(f"az=2.0&el=0.5&d=3.0&raw=1&seq={seq}")
        seq = int(r2.headers["x-seq"])
        r3, png, ms3 = fetch(f"az=2.0&el=0.3&d=2.5&seq={seq}")
        seq = int(r3.headers["x-seq"])
        r4, half, ms4 = fetch(f"az=2.0&el=0.3&d=2.5&raw=1&half=1&seq={seq}")
        served = int(r4.headers["x-seq"])
    finally:
        server.shutdown()
        server.render_loop.stop()
        server.server_close()
    check(server.render_loop.error is None,
          f"the viewer's render loop failed: {server.render_loop.error!r}")
    xp_launches = blend_tiles.launches_by_kernel["tile_blend_xp"]
    check(xp_launches >= served >= 4,
          f"tile_blend_xp launched {xp_launches} times for {served} served frames")
    check(len(raw1) == len(raw2) == width * height * 3, f"raw frame bytes {len(raw1)}")
    check(len(half) == (width // 2) * (height // 2) * 3, f"half frame bytes {len(half)}")
    check((int(r4.headers["x-w"]), int(r4.headers["x-h"])) == (width // 2, height // 2),
          "half frame geometry")
    check(png[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "f.png")
        with open(p, "wb") as f:
            f.write(png)
        png_img = read_png(p)
    check(png_img.shape == (height, width, 3), f"PNG frame shape {png_img.shape}")
    f1 = np.frombuffer(raw1, np.uint8).reshape(height, width, 3)
    f2 = np.frombuffer(raw2, np.uint8).reshape(height, width, 3)
    cov = [coverage_u8(f, rcfg.background) for f in (f1, f2, png_img)]
    check(min(cov) > COVERAGE_FLOOR, f"served coverage {cov}")
    moved = float(np.abs(f1.astype(np.int16) - f2.astype(np.int16)).mean())
    check(moved > 1.0, f"a moved camera changed the served frame by {moved} levels")
    # the served frame is the engine's own frame for that camera
    own = eng_xp.frame(cam_at(0.5))
    own_u8 = torch.clamp(own * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()
    check(np.array_equal(own_u8, f1), "served frame differs from SplatEngine.frame")
    # SH: a splat's colour depends on the viewing direction, and the lit
    # frame differs from the unlit one
    lit_a = apply_sh(splats, sh, cam_at(0.5)["cam_pos"])
    lit_b = apply_sh(splats, sh, cam_at(2.0)["cam_pos"])
    sh_shift = float(torch.stack([(lit_a[c] - lit_b[c]).abs().mean()
                                  for c in ("cr", "cg", "cb")]).mean())
    check(sh_shift > 0.01, f"SH moved the colours by {sh_shift} between two azimuths")
    unlit = float((eng_flat.frame(cam_at(0.5)) - own).abs().mean())
    check(unlit > 1e-3, f"SH changed the frame by {unlit}")
    log(f"phase 10: viewer served {served} frames of SplatEngine(sh degree 3, tile_xp) over "
        f"HTTP: raw {len(raw1)} B in {ms1:.1f} / {ms2:.1f} ms, PNG {len(png)} B in {ms3:.1f} ms, "
        f"half raw {len(half)} B in {ms4:.1f} ms (host clock, first request warms up; "
        f"X-Render-Ms {r1.headers['x-render-ms']} / {r2.headers['x-render-ms']} / "
        f"{r3.headers['x-render-ms']} / {r4.headers['x-render-ms']}); tile_blend_xp launches "
        f"{xp_launches}; coverage {min(cov):.3f}..{max(cov):.3f} (> {COVERAGE_FLOOR}); moved "
        f"camera changed the frame by {moved:.2f} levels mean; SH shifts colours by "
        f"{sh_shift:.4f} between azimuths 0.5 and 2.0, lit vs unlit frame {unlit:.4f}; {card}")

    # ---- frame and stage times, tile and tile_xp in turns ----
    cam = cam_at(0.5)
    frames = {"tile": [], "tile_xp": []}
    for e in (eng_tile, eng_xp):
        e.frame(cam)  # warm-up
    torch.cuda.synchronize()
    imgs = {}
    for _ in range(5):
        for name, e in (("tile", eng_tile), ("tile_xp", eng_xp)):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            imgs[name] = e.frame(cam)
            e1.record()
            torch.cuda.synchronize()
            frames[name].append(e0.elapsed_time(e1))
    check(torch.equal(imgs["tile"], imgs["tile_xp"]), "tile and tile_xp frames differ")
    check(bool(torch.isfinite(imgs["tile"]).all()), "non-finite static-scene frame")
    log(f"phase 10: SplatEngine.frame {n} splats + SH deg 3 @1920x1080 16x16 cap 4, 5 frames each in "
        "turns, ms (CUDA events): "
        + "; ".join(f"{k} " + " ".join(f"{t:.3f}" for t in v)
                    + f" (median {statistics.median(v):.3f})" for k, v in frames.items())
        + f"; frames bit-equal; {card}")
    # stage_profile called here so that a failure in it is seen (the
    # viewer's HUD tolerates one)
    profiles = {}
    for rep in range(2):
        for name, e in (("tile", eng_tile), ("tile_xp", eng_xp)):
            prof = e.stage_profile(cam, None, iters=5)
            check(set(prof) == {"splats_ms", "project_ms", "bin_ms", "blend_ms", "image_ms"},
                  f"stage_profile keys {sorted(prof)}")
            check(all(v > 0 for v in prof.values()), f"stage_profile {prof}")
            profiles[f"{name} run {rep + 1}"] = prof
    log("phase 10: stage_profile (median of 5, ms, CUDA events; splats = SH lighting): "
        + "; ".join(f"{k}: " + " ".join(f"{s[:-3]} {v:.3f}" for s, v in prof.items())
                    + f" sum {sum(prof.values()):.3f}" for k, prof in profiles.items())
        + f"; {card}")

    # ---- the two kernels alone at this stream ----
    binned = words_and_bins(apply_sh(splats, sh, cam["cam_pos"]), cam, rcfg)
    k1 = blend_tiles(binned, rcfg, eps=0.0)
    k3 = blend_tiles(binned, rcfg, eps=0.0, schedule="tile_xp")
    plain = blend_tiles_plain(binned, rcfg, eps=0.0, pair_chunk=8192)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k1, k3)), "static stream: tile_xp != tile")
    err = max_diff(k3, plain)
    check(err <= EPS_TOL, f"static stream: tile_xp vs twin {err}")
    eps = rcfg.transmittance_eps
    t = {"tile eps 0": [], "tile_xp eps 0": [], f"tile eps {eps}": [], f"tile_xp eps {eps}": []}
    for order in (("tile", "tile_xp"), ("tile_xp", "tile")):  # tile, xp, xp, tile
        for sched in order:
            t[f"{sched} eps 0"].append(
                elapsed_ms(lambda: blend_tiles(binned, rcfg, eps=0.0, schedule=sched), 20))
            t[f"{sched} eps {eps}"].append(
                elapsed_ms(lambda: blend_tiles(binned, rcfg, schedule=sched), 20))
    plain_ms = elapsed_ms(lambda: blend_tiles_plain(binned, rcfg, eps=0.0, pair_chunk=8192), 2)
    bnd, n_pairs, evals, inside = stream_bound("tile_blend_xp", binned, rcfg, False)
    nonempty = int((binned["counts"] > 0).sum())
    log(f"phase 10: kernels at the static-scene stream ({n_pairs} pairs, {nonempty} of "
        f"{rcfg.num_tiles} tiles nonempty, {inside} of {evals} evaluations inside the support), "
        "ms in the order tile, tile_xp, tile_xp, tile: "
        + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in vs) for k, vs in t.items())
        + f"; plain twin (eps 0) {plain_ms:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); tile_xp "
        f"vs tile bit-equal, vs twin max-abs {err:.3g}; {card}")
    return dict(launches=xp_launches, err=err, ms=statistics.mean(t["tile_xp eps 0"]),
                plain_ms=plain_ms, bound=bnd)


def phase11_datagen(dev, card: str, headline_cfg, headline_cam, n: int = 1_000_000,
                    n_cut: int = 100_000, n_views: int = 2_000_000):
    """The G-buffer at the headline stream, the depth kernel vs its twin and
    the plain tile compositor, and 8 views x 2M splats as uint8."""
    import statistics

    import torch

    from splat_renderer_tpu_torch import Camera, PointConfig, RenderConfig, orbit_ring
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.ops.tile_blend import (
        blend_tiles, blend_tiles_plain, reset_launches,
    )
    from splat_renderer_tpu_torch.render.multiview import render_views
    from splat_renderer_tpu_torch.render.pipeline import (
        demo_scene, model_points, render_gbuffer, render_splats,
    )
    from splat_renderer_tpu_torch.render.projector import splat_screen_words

    scene = demo_scene()
    pcfg = PointConfig()
    rcfg, cam = headline_cfg, headline_cam
    spl = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(31),
                       n, pcfg, rcfg, device=dev)
    reset_launches()
    render_gbuffer(spl, cam, rcfg, device=dev)  # warm-up
    torch.cuda.synchronize()
    gb_ms = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        gb = render_gbuffer(spl, cam, rcfg, device=dev)
        e1.record()
        torch.cuda.synchronize()
        gb_ms.append(e0.elapsed_time(e1))
    # this path's launches: the warm-up and the 5 timed G-buffers
    depth_launches = blend_tiles.launches_by_kernel["tile_blend_depth"]
    check(depth_launches == 6, f"tile_blend_depth launched {depth_launches} times in 6 G-buffers")
    h, w = rcfg.height, rcfg.width
    check(gb["rgb"].shape == (h, w, 3) and gb["depth"].shape == (h, w)
          and gb["alpha"].shape == (h, w), "G-buffer shapes")
    check(all(bool(torch.isfinite(v).all()) for v in gb.values()), "non-finite G-buffer")
    alpha, depth = gb["alpha"], gb["depth"]
    cov = float((alpha > BG_TOL).float().mean())
    check(cov > COVERAGE_FLOOR, f"G-buffer coverage {cov}")
    check(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0 + 1e-6, "alpha out of [0, 1]")
    check(float(depth[alpha <= 1e-6].abs().max()) == 0.0, "depth off the splats is not 0")
    d_all = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], rcfg)["depth"]
    d_all = d_all[torch.isfinite(d_all)]
    lo, hi = float(d_all.min()), float(d_all.max())
    hit = alpha > 0.5
    check(float(depth[hit].min()) >= lo - 1e-3 and float(depth[hit].max()) <= hi + 1e-3,
          f"hit depths outside the splats' range [{lo}, {hi}]")
    img = render_splats(spl, cam, rcfg, device=dev)
    check(torch.equal(img, gb["rgb"]), "G-buffer colour differs from the frame's")
    log(f"phase 11: render_gbuffer {n} splats @{w}x{h} {rcfg.tile_w}x{rcfg.tile_h} cap "
        f"{rcfg.tiles_per_splat_cap}: ms (CUDA events) " + " ".join(f"{t:.3f}" for t in gb_ms)
        + f" (median {statistics.median(gb_ms):.3f}); coverage {cov:.3f}; hit depth "
        f"{float(depth[hit].min()):.3f}..{float(depth[hit].max()):.3f} inside the splats' "
        f"{lo:.3f}..{hi:.3f}; colour equal to render_splats'; {card}")

    # kernel path vs the plain tile compositor: a 100k @512x512 cut (the
    # compositor walks the stream 1024 pairs at a time, too slow at 1M)
    cfg_c = RenderConfig(width=512, height=512, base_radius=0.008, tiles_per_splat_cap=4)
    cam_c = camera_tensors(Camera(aspect=1.0).arrays(), dev)
    spl_c = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(32),
                         n_cut, pcfg, cfg_c, device=dev)
    g_k = render_gbuffer(spl_c, cam_c, cfg_c, method="kernel", eps=0.0, device=dev)
    g_t = render_gbuffer(spl_c, cam_c, cfg_c, method="tiles", device=dev)
    torch.cuda.synchronize()
    cut = {k: float((g_k[k] - g_t[k]).abs().max()) for k in ("rgb", "alpha", "depth")}
    check(cut["rgb"] <= EPS_TOL and cut["alpha"] <= EPS_TOL, f"G-buffer vs tiles {cut}")
    check(cut["depth"] <= GBUFFER_DEPTH_TOL, f"G-buffer depth vs tiles {cut}")
    log(f"phase 11: render_gbuffer kernel vs method=\"tiles\" at {n_cut} splats @512x512: max-abs rgb "
        f"{cut['rgb']:.3g}, alpha {cut['alpha']:.3g} (<= {EPS_TOL}), depth {cut['depth']:.3g} "
        f"(<= {GBUFFER_DEPTH_TOL})")

    # ---- 8 views x 2M splats, uint8 ----
    cfg_v = RenderConfig(width=1920, height=1080, base_radius=0.008, tiles_per_splat_cap=4)
    spl_v = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(33),
                         n_views, pcfg, cfg_v, device=dev)
    cams = camera_tensors(orbit_ring(8, aspect=1920 / 1080), dev)
    render_views(spl_v, {k: v[:1] for k, v in cams.items()}, cfg_v, as_uint8=True, device=dev)
    torch.cuda.synchronize()
    mv_ms = []
    for _ in range(2):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        views = render_views(spl_v, cams, cfg_v, as_uint8=True, device=dev)
        e1.record()
        torch.cuda.synchronize()
        mv_ms.append(e0.elapsed_time(e1))
    check(views.shape == (8, 1080, 1920, 3) and views.dtype == torch.uint8, "views shape")
    bg8 = torch.round(torch.tensor(cfg_v.background, device=dev) * 255.0)
    off = (views.float() - bg8).abs().sum(-1) > 255.0 * BG_TOL
    cov_v = [float(x) for x in off.float().mean(dim=(1, 2))]
    check(min(cov_v) > COVERAGE_FLOOR, f"view coverage {cov_v}")
    check(float((views[0].float() - views[2].float()).abs().mean()) > 1.0, "views do not differ")
    flat = render_views(spl_v, {k: v[:2] for k, v in cams.items()}, cfg_v, flat=True,
                        as_uint8=True, device=dev)
    check(flat.shape == (2, 1080, 1920 * 3) and torch.equal(flat.reshape(2, 1080, 1920, 3),
                                                             views[:2]), "flat layout")
    log(f"phase 11: render_views 8 views x {n_views} splats @1920x1080 16x16 cap 4, uint8: ms (CUDA events) "
        + " ".join(f"{t:.3f}" for t in mv_ms)
        + f" = {min(mv_ms) / 8:.3f}..{max(mv_ms) / 8:.3f} ms/view; coverage "
        f"{min(cov_v):.3f}..{max(cov_v):.3f}; {card}")

    # ---- the depth kernel alone at the headline stream ----
    binned = words_and_bins(spl, cam, rcfg, with_depth=True)
    k = blend_tiles(binned, rcfg, eps=0.0, with_depth=True)
    plain = blend_tiles_plain(binned, rcfg, eps=0.0, pair_chunk=8192, with_depth=True)
    torch.cuda.synchronize()
    d_hi = depth_range(binned)
    err_ca, err_d = max_diff(k[:2], plain[:2]), float((k[2] - plain[2]).abs().max())
    check(err_ca <= EPS_TOL, f"1M stream: depth kernel colour/alpha vs twin {err_ca}")
    check(err_d <= DEPTH_TOL * d_hi, f"1M stream: depth vs twin {err_d} (range {d_hi})")
    k_ms = [elapsed_ms(lambda: blend_tiles(binned, rcfg, eps=0.0, with_depth=True), 20)]
    k1_ms = elapsed_ms(lambda: blend_tiles(binned, rcfg, eps=0.0), 20)
    k_ms.append(elapsed_ms(lambda: blend_tiles(binned, rcfg, eps=0.0, with_depth=True), 20))
    e_ms = elapsed_ms(lambda: blend_tiles(binned, rcfg, with_depth=True), 20)
    plain_ms = elapsed_ms(
        lambda: blend_tiles_plain(binned, rcfg, eps=0.0, pair_chunk=8192, with_depth=True), 2)
    bnd, n_pairs, evals, inside = stream_bound("tile_blend_depth", binned, rcfg, True)
    log(f"phase 11: tile_blend_depth at the {n}-splat @1080p stream ({n_pairs} pairs): kernel "
        f"{k_ms[0]:.3f} / {k_ms[1]:.3f} ms at eps 0 (without depth, between them: {k1_ms:.3f}), "
        f"{e_ms:.3f} ms at eps {rcfg.transmittance_eps}; plain twin {plain_ms:.3f} ms; bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}); max-abs colour/alpha {err_ca:.3g} (<= {EPS_TOL}), depth "
        f"{err_d:.3g} (<= {DEPTH_TOL} x {d_hi:.3f}); launches by the 6 render_gbuffer calls "
        f"{depth_launches}; {card}")
    return dict(launches=depth_launches, err=max(err_ca, err_d / d_hi),
                ms=statistics.mean(k_ms), plain_ms=plain_ms, bound=bnd)


def phase12_rate_probe(dev, card: str):
    """K6: the probe's kernels vs their twin, then its entry point."""
    import torch

    from splat_renderer_tpu_torch.ops import probe_rate as pr

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(pr.PANEL, generator=g, device=dev)
    errs = {}
    for dtype, tol in (("f32", 0.0), ("bf16", 2.0 ** -6)):
        # float32: mul by 0.5 is exact, so mul-then-add rounds once like the
        # fused chain and the results are equal; bfloat16: held to one ulp
        # at the chain's fixed point 2.0
        errs[dtype] = 0.0
        for repeats in (1, 5, pr.REPEATS):
            got = pr.probe_rate(x, dtype, repeats=repeats, steps=4)
            want = pr.probe_rate_plain(x, dtype, repeats=repeats, steps=1)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            check(e <= tol, f"probe {dtype} repeats {repeats}: kernel vs twin {e} (> {tol})")
            check(bool(torch.isfinite(got).all()), f"probe {dtype}: non-finite")
            errs[dtype] = max(errs[dtype], e)
    # the probe's own entry point: these launches are the ones reported
    pr.probe_rate.launches = 0
    rates = pr.measure(dev)
    launches = pr.probe_rate.launches
    check(launches >= 2, f"probe_rate launched {launches} times")
    fmas = pr.fma_count(x.numel())
    out = {}
    for dtype, peak in (("f32", FP32_FLOP_S), ("bf16", BF16_FLOP_S)):
        work = torch.float32 if dtype == "f32" else torch.bfloat16
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        pr.probe_rate_plain(x, dtype)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        # one PyTorch call computes one round of the chain: torch.addcmul
        acc, half, one = x.to(work), torch.full_like(x, 0.5, dtype=work), \
            torch.ones_like(x, dtype=work)
        e0.record()
        for _ in range(pr.REPEATS * pr.STEPS):
            torch.addcmul(one, acc, half, out=acc)
        e1.record()
        torch.cuda.synchronize()
        lib_ms = e0.elapsed_time(e1)
        t_bytes = 2 * x.numel() * 4 / HBM_BYTES_S
        t_ops = 2 * fmas / peak
        bnd = (t_bytes * 1e3, "bytes") if t_bytes > t_ops else (t_ops * 1e3, "operations")
        out[dtype] = dict(ms=rates[dtype]["ms"], plain_ms=plain_ms, lib_ms=lib_ms, bound=bnd,
                          err=errs[dtype])
        log(f"phase 12: probe_rate {dtype}: {pr.REPEATS} x {pr.STEPS} rounds on "
            f"{pr.PANEL[0]}x{pr.PANEL[1]} = {fmas} multiply-adds in {rates[dtype]['ms']:.4f} ms "
            f"({rates[dtype]['tfma_s']:.3f} Tfma/s; bound {bnd[0]:.4f} ms, {bnd[1]}, peak "
            f"{peak / 2e12:.1f} Tfma/s); plain twin {plain_ms:.1f} ms; torch.addcmul loop "
            f"{lib_ms:.1f} ms; kernel vs twin max-abs {errs[dtype]:.3g} (<= "
            f"{0.0 if dtype == 'f32' else 2.0 ** -6}); {card}")
    log(f"phase 12: bf16 / f32 rate {rates['bf16']['tfma_s'] / rates['f32']['tfma_s']:.3f}; "
        f"launches by the entry point {launches}; {card}")
    out["launches"] = launches
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    import numpy as np

    import splat_renderer_tpu_torch as spt
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.convert import splats_from_numpy
    from splat_renderer_tpu_torch.ops import build
    from splat_renderer_tpu_torch.ops.tile_blend import (
        blend_tiles, blend_tiles_plain, reset_launches,
    )
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
    sources = ("tile_blend", "tile_blend_diff", "probe_rate")
    build.build_all(sources)  # one nvcc per source, in parallel
    for name in sources:
        build.load_library(name)
    log(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; kernels built/loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{k} {build.build_seconds[k]:.2f} s" for k in sources) + ")")

    max_err = 0.0
    depth_err = xp_err = 0.0  # phase 9: worst kernel-vs-twin error by kernel

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
            # the depth plane rides along for phase 9; the stream is the same
            binned = words_and_bins(rand_splats, cam, cfg, with_depth=True)
            exact = blend_tiles(binned, cfg, eps=0.0)
            # the twin with depth: its colour and alpha are those without
            plain_d = blend_tiles_plain(binned, cfg, eps=0.0, with_depth=True)
            plain = plain_d[:2]
            early = blend_tiles(binned, cfg, eps=0.01)
            sync()
            d0, de = max_diff(exact, plain), max_diff(early, exact)
            max_err = max(max_err, d0)
            log(f"phase 2: {name:9s} {cfg.tile_w}x{cfg.tile_h} pairs "
                f"{int(binned['offsets'][-1])}: kernel vs twin max-abs {d0:.3g} "
                f"(<= {EPS_TOL}), eps 0.01 vs 0 {de:.3g} (<= {EARLY_EXIT_TOL})")
            check(d0 <= EPS_TOL, f"{name}: kernel vs twin {d0}")
            check(de <= EARLY_EXIT_TOL, f"{name}: early exit {de}")

            # ---- phase 9: the depth kernel vs twin; tile_xp vs tile ----
            exact_d = blend_tiles(binned, cfg, eps=0.0, with_depth=True)
            early_d = blend_tiles(binned, cfg, eps=0.01, with_depth=True)
            sync()
            d_hi = depth_range(binned)
            dca = max_diff(exact_d[:2], plain)
            dd = float((exact_d[2] - plain_d[2]).abs().max())
            check(dca <= EPS_TOL, f"{name}: depth kernel colour/alpha vs twin {dca}")
            check(dd <= DEPTH_TOL * d_hi, f"{name}: depth vs twin {dd} (largest depth {d_hi})")
            depth_err = max(depth_err, dca, dd / d_hi)
            for eps, want, want_d in ((0.0, exact, exact_d), (0.01, early, early_d)):
                got = blend_tiles(binned, cfg, eps=eps, schedule="tile_xp")
                got_d = blend_tiles(binned, cfg, eps=eps, schedule="tile_xp", with_depth=True)
                sync()
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{name}: tile_xp != tile at eps {eps}")
                check(all(torch.equal(a, b) for a, b in zip(got_d, want_d)),
                      f"{name}: tile_xp != tile with depth at eps {eps}")
            xp_err = max(xp_err, d0)  # bit-equal to the kernel phase 2 just held
            log(f"phase 9: {name:9s} {cfg.tile_w}x{cfg.tile_h}: depth kernel vs twin max-abs "
                f"colour/alpha {dca:.3g} (<= {EPS_TOL}), premultiplied depth {dd:.3g} "
                f"(<= {DEPTH_TOL} x largest depth {d_hi:.3f}); tile_xp equal to tile bit for "
                f"bit at eps 0 and 0.01, with and without depth")

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

    reset_launches()
    frame_ms, shares = run_frames(eng, 5, 0.0, 0)
    main_launches = blend_tiles.launches_by_kernel["tile_blend"]
    check(main_launches == blend_tiles.launches, "Engine frames launched another kernel")
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

    # ---- phase 10: static-scene serving ----
    p10 = phase10_static_scene(dev, card)

    # ---- phase 11: datagen ----
    p11 = phase11_datagen(dev, card, rcfg, cam)

    # ---- phase 12: the rate probe ----
    p12 = phase12_rate_probe(dev, card)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "splat_renderer_tpu"
                    or m.startswith("splat_renderer_tpu."))
    check(not leaked, f"JAX modules imported: {leaked}")

    def entry(name, source, replaces, launches, err, ms, plain, bnd, library=None, **more):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library, **more}

    blend_src = "splat_renderer_tpu_torch/csrc/tile_blend.cu"
    diff_src = "splat_renderer_tpu_torch/csrc/tile_blend_diff.cu"
    jax_blend = "splat_renderer_tpu/ops/tile_blend.py"
    k4_ms, k4_plain, k4_bound, k4_main_err = p7["fwd"]
    k5_ms, k5_plain, k5_bound, k5_main_err = p7["bwd"]
    f32, bf16 = p12["f32"], p12["bf16"]
    print(json.dumps({"kernels": [
        # one kernel is the port of both TPU schedules that compute its image
        entry("tile_blend", blend_src, f"{jax_blend}:337, {jax_blend}:570", main_launches,
              max_err, exact_ms, plain_exact_ms, k1_bound),
        # the same two TPU kernels' with_depth form (body at :96-113, :271-278)
        entry("tile_blend_depth", blend_src, f"{jax_blend}:337, {jax_blend}:570",
              p11["launches"], max(depth_err, p11["err"]), p11["ms"], p11["plain_ms"],
              p11["bound"]),
        entry("tile_blend_xp", blend_src, f"{jax_blend}:422", p10["launches"],
              max(xp_err, p10["err"]), p10["ms"], p10["plain_ms"], p10["bound"]),
        entry("tile_blend_diff_fwd", diff_src, "splat_renderer_tpu/ops/tile_blend_diff.py:136",
              p7["launches"][0], max(k4_err, k4_main_err), k4_ms, k4_plain, k4_bound),
        entry("tile_blend_diff_bwd", diff_src, "splat_renderer_tpu/ops/tile_blend_diff.py:199",
              p7["launches"][1], max(k5_err, k5_main_err), k5_ms, k5_plain, k5_bound),
        # the float32 chain in the common keys, the bfloat16 chain beside it
        entry("probe_rate", "splat_renderer_tpu_torch/csrc/probe_rate.cu",
              "benchmarks/probe_bf16.py:24", p12["launches"], f32["err"], f32["ms"],
              f32["plain_ms"], f32["bound"], library=f32["lib_ms"],
              bf16_ms=bf16["ms"], bf16_plain_ms=bf16["plain_ms"],
              bf16_bound_ms=bf16["bound"][0], bf16_library_ms=bf16["lib_ms"],
              bf16_max_abs_err=bf16["err"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
