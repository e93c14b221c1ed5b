#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (nvcc).  It builds the hand-written kernels from the sources in the
checkout, holds each against its plain PyTorch twin, drives the main path
(`Engine.frame`) at the bench headline size, the training path, and the
static-scene serving and datagen paths, and checks the images.  Phases:

  1. device name and power limit; build or load the kernels; registers,
     shared memory and resident CTAs per SM (the occupancy query) of the
     instantiations timed below, and the persistent schedule's grid
  2. tile-blend kernel vs its plain twin on random record streams, every
     profile, 16x16 and 32x16 tiles: max-abs <= 2e-5 at eps = 0, and
     eps = 0.01 within 0.0101 of eps = 0
  3. Engine.frame, 1M splats at 1920x1080 on 32x16 tiles (cap 4), 5
     animated frames: finite images, coverage above a floor, and the
     kernel's launch count; per-stage CUDA-event times
  4. the same Engine on the opaque oriented surface preset with quads at
     cap 16 (the benchmark cell `surface_1m_1080p`'s settings), 2 frames,
     then a third with the recorder on: its pairs and K1's walk
  5. one 1280x720 frame through the kernel and through the twin, and a
     small frame against the exact oracle
  6. the differentiable blend's forward (K4) and backward (K5) kernels vs
     their plain twin on random plane streams, 20k splats at 256x256,
     isotropic and oriented, 16x16 and 32x16 tiles: forward max-abs
     <= 2e-5, K4's residual (the chunk-start T it leaves for K5) within
     2e-5 of its plain mirror, every field's gradient within max-relative
     1e-4 (isotropic) / 1e-3 (oriented), two backward runs bit-identical
  7. the training path at the repo's training metric: 200k splats at
     512x512 (cap 4), one MSE value-and-grad step over colour and opacity
     (CUDA-event forward/backward/step times), then `fit_splats`, 5 Adam
     steps over 8 fields, whose loss must fall; K4/K5 launch counts; the
     kernels alone at that stream vs the twin (K4 with and without the
     residuals it leaves for K5, the residual vs its mirror; two K5 runs
     bit-equal), and the heaviest tile as K4's warps walk it
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
     PNG and half-size frames fetched from localhost), the SH kernel
     (csrc/sh_colors.cu, S1) launched once a served frame; then CUDA-event
     times of `SplatEngine.frame` with "tile" and "tile_xp", interleaved,
     by stage, and the two kernels alone at that stream; S1 alone on the
     scene's 1M splats and on 2M in the benchmark's layout (the
     coefficients rows of one (3, 15, N) tensor, the camera a row of a
     (V, 3) tensor): its lit colours bit-equal to the plain path, its
     device time (the profiler's, L2 written over before each launch, and
     warm), the call's and the plain path's, beside its bound (216 bytes a
     splat over HBM bandwidth)
 11. datagen: `render_gbuffer` at the 1M @1080p headline stream (and kernel
     vs method="tiles" on a 100k @512x512 cut: the plain tile compositor
     walks the pair stream 1024 pairs at a time), the depth kernel alone vs
     its twin, and `render_views`, 8 views x 2M splats @1080p as uint8
 12. the arithmetic-rate probe: float32 and bfloat16 multiply-add chains,
     kernel vs twin bit for bit, and its entry point's rates
 13. the front ends at the JAX scripts' defaults, in process: `apps.datagen
     --gbuffer` (8 views x 2 steps, 200k points, 800x800; its manifest and
     files read back by `load_dataset`), `apps.fit_demo --dataset` on it
     with `--method kernel` (2000 splats, 150 steps; the loss must fall),
     and `apps.demo`'s SDF engine at 1280x720 and its `--ply` engine on
     phase 10's file, 3 frames each over HTTP; launch counts of K1, the
     depth form, K4 and K5; then, on each front end's own configuration,
     splats and camera, its kernels vs the twin: the depth form on
     datagen's last view, K4/K5 (forward and gradients, as in phase 6) on
     the fitted splats' first view, K1 on a frame of each demo engine
 14. mesh export of the demo scene at resolutions 96 and 256: vertex and
     face counts, Euler characteristic 2, watertight, vertices on the
     surface
 15. the turbo profile at the headline shape against the exact profile:
     SSIM > 0.985, the depth_key_order frame equal to the exact frame bit
     for bit, K1 vs its twin on the turbo stream, the exact stream's runs
     equal to those of the same records sorted before binning (K1 and the
     depth form bit-equal on the two), and the times of the bin stage
     (exact, turbo, after a record sort), the frame (exact, turbo), K1 and
     the depth form (on the exact and the record-sorted stream), 5 of
     each, interleaved
 16. multi-device rendering and training (`parallel/`, `fit_splats_dp`)
     under an NCCL process group of world size 1 on cuda:0 (NCCL refuses
     two ranks on one GPU).  16a: `band_frame_fn` at the headline (slack
     1.5) equal to `render_splats` bit for bit, with its stats;
     `multichip_frame_fn(dp=1, sp=1)` over 8 orbit views, each equal to
     `render_splats`; `render_views_data_parallel` over 8 views x 100k
     splats at 512x512 equal to the per-view loop; 3 steps of
     `fit_splats_dp(method="kernel")` over 8 views at 200k @512x512, losses
     and theta equal to `fit_splats`' bit for bit, and K4/K5 vs the twin on
     one of its views; CUDA-event times of each beside the single-device
     path; the band frame's stages from its profiler spans; one step of
     `fit_splats_dp` and of `fit_splats` under torch.profiler, side by
     side.  16b: the depth bands of sp = 2 and 4, one after another on the
     card: `depth_band` on the headline words, each band's records as its
     rank would receive them, `bin_packed_words(compact_to=)` and K1's
     partials folded by `over_merge`: within 3e-5 of the frame at eps 0 and
     0.0101 at eps 0.01; each band's records, pairs, bin and K1 times
     beside the frame's, and K1 vs the twin on a band stream.  Then the
     tile bands of sp = 2 and 4 (`render_band`), stacked and equal to
     `render_splats` bit for bit; each band's records and pairs, and its
     record selection, bin and `render_band` times beside the frame's
 17. the projector kernel (csrc/project_words.cu) at the headline shape:
     the demo scene's 1M splats at 1920x1080 as `model_points` hands them
     to the frame (rows of M1's one (11, N) tensor) on the isotropic, the
     surface (foreshortened, opaque) and an EWA config with the dilation:
     its five outputs bit-equal to the plain path, on those rows and,
     untimed, on the plain modeler's stride-3 columns; its device time (the profiler's, L2 written over before each
     launch, and warm) and its call time beside its bound (bytes over HBM
     bandwidth) and the plain path's call time
 18. the binner's kernels (csrc/bin_words.cu, B1) on the demo scene's 1M
     splats at 1920x1080 on 16x16 tiles, cap 4, and on one view of
     `gs3d_aniso_2m_1080p`'s 2M Gaussians (cap 8, oriented): offsets,
     counts, the live pairs and the record planes bit-equal to the plain
     path; the device time of the call's kernels (the profiler's, L2
     written over before each call), the call's time and the
     plain path's, beside the bytes of the design's passes over HBM
     bandwidth
 19. the modeler's kernels (csrc/sdf_model.cu, M1) on the demo scene's 1M
     points, on the headline config and the surface preset of
     `surface_1m_1080p`: `model_points`' eleven planes bit-equal to the
     plain path's, one launch of each kernel a call; the descent's and the
     probe's device times (the profiler's, L2 written over before each
     call, and warm), the call's and the plain path's, beside the bound:
     the bytes once, the FP32 operations and the SFU results a point
     (`model_work`), whichever takes longest

Beside each blend kernel's time at its stream it prints the share of the
(record, warp) pairs that the kernels' warp-level culling removes there
(computed with the culling test's plain mirror).

It prints one JSON line describing the ten kernels (each with its launches
on its path, its time, the twin's time and the least time the card could
take for the same work),
then, as its last line,
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code is
non-zero and the last line is never printed; without a CUDA device it exits
non-zero at once.  It imports nothing of JAX.

    python3 chip_smoke.py --save-k4 PATH | --check-k4 PATH

runs only the differentiable blend's kernels on phase 6's and phase 7's
streams and saves their outputs, or holds this tree's kernels to saved
outputs bit for bit (`k4_parity`): the check that a redesigned kernel
computes the same bits as the one it replaces.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

EPS_TOL = 2e-5  # kernel vs plain twin / oracle at eps = 0
EARLY_EXIT_TOL = 0.0101  # eps = 0.01 vs eps = 0 (transmittance floor + rounding)
COVERAGE_FLOOR = 0.05  # share of pixels off the background in a demo frame
BG_TOL = 1e-3
DIFF_GRAD_TOL = {"isotropic": 1e-4, "oriented": 1e-3}  # tests/test_diff.py's gates
# blend_planes' plane arguments, in order
DIFF_PLANES = ("cx", "cy", "radius", "opacity", "r", "g", "b", "angle", "ratio", "depth")
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


# Operations per SDF evaluation of one node that the modeler needs (M1,
# csrc/sdf_model.cu), by node kind: (FP32 flops, SFU results).  A divide or
# a square root counts as one flop and one SFU result (its reciprocal or
# reciprocal square root); a branch the node does not take counts nothing,
# and a node whose work depends on the branch counts its cheaper branch,
# so the bound stays a floor: the box (and the round box) inside, where
# its gradient is a face's axis and it divides nothing (outside: 3
# divides more).
MODEL_OPS = {
    "sphere": (14, 4), "box": (33, 1), "torus": (23, 6), "capsule": (20, 4),
    "cylinder": (32, 5), "ellipsoid": (52, 24), "round_box": (40, 1),
    "union": (1, 0), "intersection": (1, 0), "subtraction": (5, 0),
    "smooth_union": (24, 2), "smooth_intersection": (32, 2), "smooth_subtraction": (32, 2),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def k1_launches() -> int:
    """K1's launches in the port's launch counter, all schedules and forms."""
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.ops.tile_blend import KERNELS

    return sum(launches[k] for k in KERNELS)


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


def cull_share(cx, cy, cut2, rr, binned, cfg, chunk: int = 32768):
    """Share of a tile-sorted pair stream's (record, warp) pairs that the
    kernels' warp-level culling removes: its plain mirror, on the device."""
    import torch

    from splat_renderer_tpu_torch.ops.tile_blend import cull_live_plain, warp_rects

    n_pairs = int(binned["offsets"][-1])
    rect = warp_rects(cfg).to(cx.device)
    live = 0
    for lo in range(0, n_pairs, chunk):
        tiles = binned["pair_tile"][lo:lo + chunk].long()
        ranks = binned["pair_rank"][lo:lo + chunk].long()
        ox = ((tiles % cfg.tiles_x).float() * cfg.tile_w)[:, None]
        oy = ((tiles // cfg.tiles_x).float() * cfg.tile_h)[:, None]
        col = lambda v: v[ranks][:, None]  # noqa: E731
        live += int(cull_live_plain(
            col(cx), col(cy), col(cut2), col(rr), ox + rect[None, :, 0], ox + rect[None, :, 1],
            oy + rect[None, :, 2], oy + rect[None, :, 3], cfg.oriented,
            cfg.opaque and cfg.quad).sum())
    return 1.0 - live / max(n_pairs * rect.shape[0], 1)


def packed_cull_share(binned, cfg) -> float:
    """`cull_share` of a packed-word stream."""
    import torch

    from splat_renderer_tpu_torch.ops.tile_blend import staged_cut2
    from splat_renderer_tpu_torch.render.packing import U32_MASK, unpack_words

    u32 = lambda w: w.to(torch.int64) & U32_MASK  # noqa: E731
    cx, cy, r, op, _, _, _, _, ratio = unpack_words(
        u32(binned["rec_pos"]), u32(binned["rec_ro"]), u32(binned["rec_rgb"]), cfg)
    cut2, rr = staged_cut2(r, op, ratio, cfg)
    return cull_share(cx, cy, cut2, rr, binned, cfg)


def tile_load(binned) -> str:
    """How a stream's records spread over its tiles: the kernels' time is
    the walk of the heaviest tile, not the mean one."""
    import torch

    counts = binned["counts"]
    ne = counts[counts > 0].float()
    return (f"{ne.numel()} of {counts.numel()} tiles nonempty, records per nonempty tile mean "
            f"{float(ne.mean()):.0f}, p99 {float(torch.quantile(ne, 0.99)):.0f}, heaviest "
            f"{int(ne.max())}")


def heaviest_tile(binned, cfg) -> str:
    """The heaviest tile of a packed-word stream as the kernels' warps see
    it: the share of its records each warp's 8x4 pixel block keeps after
    culling (the busiest warp's walk bounds the kernel), and the share of
    its pixels whose transmittance is exactly 0 after the run (they stop
    even at eps 0)."""
    import torch

    from splat_renderer_tpu_torch.ops.tile_blend import cull_live_plain, staged_cut2, warp_rects
    from splat_renderer_tpu_torch.render.blend import splat_alpha_planes
    from splat_renderer_tpu_torch.render.packing import U32_MASK, unpack_words

    dev = binned["offsets"].device
    t = int(torch.argmax(binned["counts"]))
    lo, hi = int(binned["offsets"][t]), int(binned["offsets"][t + 1])
    ranks = binned["pair_rank"][lo:hi].long()
    u32 = lambda w: w[ranks].to(torch.int64) & U32_MASK  # noqa: E731
    cx, cy, r, op, _, _, _, ang, ratio = unpack_words(
        u32(binned["rec_pos"]), u32(binned["rec_ro"]), u32(binned["rec_rgb"]), cfg)
    cut2, rr = staged_cut2(r, op, ratio, cfg)
    ox = float((t % cfg.tiles_x) * cfg.tile_w)
    oy = float((t // cfg.tiles_x) * cfg.tile_h)
    rect = warp_rects(cfg).to(dev)
    col = lambda v: v[:, None]  # noqa: E731
    live = cull_live_plain(col(cx), col(cy), col(cut2), col(rr), ox + rect[None, :, 0],
                           ox + rect[None, :, 1], oy + rect[None, :, 2], oy + rect[None, :, 3],
                           cfg.oriented, cfg.opaque and cfg.quad).float().mean(0)
    pix = torch.arange(cfg.tile_pixels, device=dev)
    px = (ox + pix % cfg.tile_w).float() + 0.5
    py = (oy + pix // cfg.tile_w).float() + 0.5
    alpha = splat_alpha_planes(col(cx), col(cy), col(r), col(op), col(ang), col(ratio),
                               px[None], py[None], cfg)
    trans = torch.cumprod(1.0 - alpha, 0)[-1]
    return (f"tile {t} ({hi - lo} records): its warps keep {float(live.min()):.2f} to "
            f"{float(live.max()):.2f} of them (all warps {float(live.mean()):.3f}); "
            f"{float((trans == 0).float().mean()):.3f} of its pixels end at T = 0")


def launch_lines(dev) -> None:
    """Registers, shared memory and resident CTAs per SM (the occupancy
    query) of the instantiations the phases below time, and K3's grid."""
    from splat_renderer_tpu_torch import RenderConfig, surface_render_config
    from splat_renderer_tpu_torch.ops import tile_blend, tile_blend_diff

    head = RenderConfig(width=1920, height=1080, tile_size=32, tile_height=16)
    static = RenderConfig(width=1920, height=1080)
    rows = []
    for label, cfg, sched, depth in (
        ("tile_blend isotropic 32x16", head, "tile", False),
        ("tile_blend_depth isotropic 32x16", head, "tile", True),
        ("tile_blend isotropic 16x16", static, "tile", False),
        ("tile_blend_xp isotropic 16x16", static, "tile_xp", False),
        ("tile_blend_xp_depth isotropic 16x16", static, "tile_xp", True),
        ("tile_blend oriented 16x16", static.replace(oriented=True), "tile", False),
        ("tile_blend opaque oriented 16x16", surface_render_config(1920, 1080), "tile", False),
    ):
        i = tile_blend.launch_info(cfg, sched, depth)
        rows.append(f"{label}: {i['registers']} registers, {i['smem_bytes']} B shared, "
                    f"{i['ctas_per_sm']} CTAs/SM"
                    + (f", grid {i['xp_grid']}" if sched == "tile_xp" else ""))
    for label, cfg in (("isotropic 16x16", RenderConfig(width=512, height=512)),
                       ("oriented 16x16", RenderConfig(width=512, height=512, oriented=True)),
                       ("isotropic 32x16",
                        RenderConfig(width=512, height=512, tile_size=32, tile_height=16)),
                       ("oriented 32x16",
                        RenderConfig(width=512, height=512, oriented=True, tile_size=32,
                                     tile_height=16))):
        for kernel, fwd in (("diff_bwd", False), ("diff_fwd", True)):
            i = tile_blend_diff.launch_info(cfg, forward=fwd)
            rows.append(f"{kernel} {label}: chunk {i['bwd_chunk']}, {i['registers']} registers, "
                        f"{i['smem_bytes']} B shared, {i['ctas_per_sm']} CTAs/SM")
    log(f"phase 1: occupancy on {i['sms']} SMs: " + "; ".join(rows))


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


def diff_streams(dev, n: int = 20_000, size: int = 256):
    """Phase 6's random plane streams: (seed, profile, cfg, planes) for the
    isotropic and oriented profiles on 16x16 and 32x16 tiles."""
    from splat_renderer_tpu_torch import RenderConfig

    for seed, (prof, extra) in enumerate((("isotropic", {}), ("oriented", dict(oriented=True)))):
        for tiles in (dict(tile_size=16), dict(tile_size=32, tile_height=16)):
            cfg = RenderConfig(width=size, height=size, tiles_per_splat_cap=8, **extra, **tiles)
            yield seed, prof, cfg, random_planes(dev, cfg, n, seed)


def residual_error(binned, cfg) -> float:
    """Max-abs of K4's residual (every row a tile uses) against its plain
    mirror `diff_residuals_plain`."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import (
        bwd_chunk, diff_forward, diff_residuals_plain, residual_rows_used,
    )

    bc = bwd_chunk(cfg)
    *_, t_start = diff_forward(binned, cfg, residuals=True)
    used = residual_rows_used(binned, bc)
    return float((t_start[used] - diff_residuals_plain(binned, cfg, bc)[used]).abs().max())


def phase6_diff_kernels(dev, card: str, n: int = 20_000, size: int = 256):
    """K4/K5 vs the twin on random plane streams, and K4's residual vs its
    plain mirror; returns (forward max-abs, gradient max-abs, gradient
    max-relative)."""
    from splat_renderer_tpu_torch.render.binning import bin_planes_diff

    errs = [0.0, 0.0, 0.0]
    for seed, prof, cfg, planes in diff_streams(dev, n, size):
        d_fwd, d_abs, rel, same = diff_vs_twin(cfg, planes, seed)
        binned = bin_planes_diff({k: p.detach() for k, p in zip(DIFF_PLANES, planes)}, cfg)
        d_res = residual_error(binned, cfg)
        check(d_res <= EPS_TOL, f"{prof}: K4's residual vs its mirror {d_res}")
        errs = [max(errs[0], d_fwd, d_res), max(errs[1], d_abs), max(errs[2], max(rel.values()))]
        log(f"phase 6: {prof:9s} {cfg.tile_w}x{cfg.tile_h} n={n} @{size}x{size}: K4 vs twin "
            f"max-abs {d_fwd:.3g}, its residual vs diff_residuals_plain {d_res:.3g} (both <= "
            f"{EPS_TOL}); K5 gradient max-rel "
            f"{max(rel.values()):.3g} (< {DIFF_GRAD_TOL[prof]}, worst {max(rel, key=rel.get)}); "
            f"backward bit-identical on rerun: {same}; {card}")
    return errs


def training_scene(dev, n: int = 200_000, size: int = 512):
    """The training metric's scene: (cfg, splats, camera), 200k demo-scene
    splats at 512x512, cap 4, from seed 7."""
    import torch

    from splat_renderer_tpu_torch import Camera, PointConfig, RenderConfig
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points

    cfg = RenderConfig(width=size, height=size, base_radius=0.008, tiles_per_splat_cap=4)
    scene = demo_scene()
    spl = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(7),
                       n, PointConfig(), cfg, device=dev)
    return cfg, spl, camera_tensors(Camera(aspect=1.0).arrays(), dev)


def training_planes(s, cam, cfg):
    """The training step's record planes, as `render_diff` makes them."""
    from splat_renderer_tpu_torch._torch_util import clip
    from splat_renderer_tpu_torch.render.projector import shade_planes

    c = shade_planes(s, cam["view_proj"], cam["cam_pos"], cfg)
    out = {k: c[k] for k in ("cx", "cy", "radius", "angle", "ratio", "depth")}
    out.update({k: clip(c[k], 0.0, 1.0) for k in ("opacity", "r", "g", "b")})
    return out


def diff_heaviest_tile(binned, cfg) -> str:
    """The heaviest tile of a `bin_planes_diff` stream as K4's warps walk
    it: the share of its records each warp's pixels can reach (the culling
    test against all its pixels), the records each warp evaluates when, as
    the kernel does, it culls each 32 records against the pixels still
    alive and leaves once all 32 are at T = 0, where in the run it leaves,
    and the share of the tile's pixels that end at T = 0."""
    import torch

    from splat_renderer_tpu_torch.ops.tile_blend import cull_live_plain, warp_pixels, warp_rects
    from splat_renderer_tpu_torch.ops.tile_blend_diff import _pair_alpha, diff_cut2

    dev = binned["offsets"].device
    t = int(torch.argmax(binned["counts"]))
    lo, hi = int(binned["offsets"][t]), int(binned["offsets"][t + 1])
    rec = binned["planes"].detach().index_select(0, binned["pair_rank"][lo:hi].long())
    ox = float((t % cfg.tiles_x) * cfg.tile_w)
    oy = float((t // cfg.tiles_x) * cfg.tile_h)
    pix = torch.arange(cfg.tile_pixels, device=dev)
    px = (ox + pix % cfg.tile_w).float() + 0.5
    py = (oy + pix // cfg.tile_w).float() + 0.5
    _, a = _pair_alpha(cfg, rec, px[None], py[None])  # (records, tile pixels)
    before = torch.empty_like(a)  # each pixel's T before each record
    trans = torch.ones_like(px)
    for i in range(a.shape[0]):
        before[i] = trans
        trans = trans * (1.0 - a[i])
    cut2, rr = diff_cut2(rec, cfg)
    col = lambda v: v[:, None]  # noqa: E731
    rect = warp_rects(cfg).to(dev)
    live = cull_live_plain(col(rec[:, 0]), col(rec[:, 1]), col(cut2), col(rr),
                           ox + rect[None, :, 0], ox + rect[None, :, 1], oy + rect[None, :, 2],
                           oy + rect[None, :, 3], cfg.oriented, False).float().mean(0)
    # the kernel's walk: 32 records at a time against the rectangle of the
    # warp's pixels alive when they start
    lanes = warp_pixels(cfg).to(dev)  # (warps, 32)
    alive = before[::32][:, lanes] > 0.0  # (words, warps, 32)
    lx, ly = px[lanes][None], py[lanes][None]
    big = 3.0e38
    x0, x1 = torch.where(alive, lx, big).amin(-1), torch.where(alive, lx, -big).amax(-1)
    y0, y1 = torch.where(alive, ly, big).amin(-1), torch.where(alive, ly, -big).amax(-1)
    word = torch.arange(a.shape[0], device=dev) // 32
    walked = (cull_live_plain(col(rec[:, 0]), col(rec[:, 1]), col(cut2), col(rr),
                              x0[word], x1[word], y0[word], y1[word], cfg.oriented, False)
              & alive.any(-1)[word]).sum(0)  # records each warp evaluates
    # the share of the run each warp walks before all its pixels stop
    share = (alive.any(-1).sum(0) * 32).clamp(max=a.shape[0]).float() / a.shape[0]
    return (f"tile {t} ({hi - lo} records): its warps' pixels can reach {float(live.min()):.2f} "
            f"to {float(live.max()):.2f} of them (all warps {float(live.mean()):.3f}); culling "
            f"against the pixels still alive, its warps evaluate {int(walked.min())} to "
            f"{int(walked.max())} records and leave after {float(share.min()):.2f} to "
            f"{float(share.max()):.2f} of the run; {float((trans == 0).float().mean()):.3f} of "
            "its pixels end at T = 0")


def phase7_training_step(dev, card: str, n: int = 200_000, size: int = 512, fit_steps: int = 5):
    """The repo's training metric and the trainer's main path on the card."""
    import statistics

    import torch

    from splat_renderer_tpu_torch.fit import fit_splats
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.ops.tile_blend_diff import (
        blend_binned_plain, bwd_chunk, diff_backward, diff_cut2, diff_forward,
    )
    from splat_renderer_tpu_torch.render.binning import bin_planes_diff
    from splat_renderer_tpu_torch.render.compositor import tiles_to_image
    from splat_renderer_tpu_torch.render.diff import render_diff

    cfg, spl, cam = training_scene(dev, n, size)
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

    stage_names = ("project", "bin", "K4", "image+loss")
    stages = {k: [] for k in stage_names}
    theta = {k: torch.full_like(spl[k], 0.5) for k in APPEARANCE}
    with torch.no_grad():
        for _ in range(6):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            planes = training_planes(dict(spl, **theta), cam, cfg)
            ev[1].record()
            binned = bin_planes_diff(planes, cfg)
            ev[2].record()
            outs = diff_forward(binned, cfg, residuals=True)  # as the step runs it
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
    launches.clear()
    e0.record()
    _, losses = fit_splats(spl, [cam], [target], cfg, fields=FIT8, steps=fit_steps, lr=1e-3,
                           init={k: torch.full_like(spl[k], 0.5) for k in APPEARANCE})
    e1.record()
    torch.cuda.synchronize()
    k45 = (launches["tile_blend_diff_forward"], launches["tile_blend_diff_backward"])
    check(k45 == (fit_steps, fit_steps), f"fit_splats launched K4/K5 {k45} times")
    curve = [float(v) for v in losses]
    check(all(map(lambda v: v == v and abs(v) < float("inf"), curve)), "non-finite fit loss")
    check(curve[-1] < curve[0], f"fit loss did not fall: {curve}")
    log(f"phase 7: fit_splats {fit_steps} Adam steps over {len(FIT8)} fields: loss "
        + " ".join(f"{v:.4g}" for v in curve)
        + f"; K4/K5 launches {k45[0]}/{k45[1]}; {e0.elapsed_time(e1) / fit_steps:.3f} "
        f"ms/step (CUDA events); {card}")

    # the kernels alone at this stream, against the twin
    binned = bin_planes_diff(training_planes(spl, cam, cfg), cfg)
    # the training step's form of K4: it also leaves K5's residuals
    *outs, t_start = diff_forward(binned, cfg, residuals=True)
    g = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.rand(o.shape, generator=g, device=dev) - 0.5 for o in outs]
    k_grads = diff_backward(binned, cfg, cots, t_start)
    k_grads2 = diff_backward(binned, cfg, cots, t_start)
    torch.cuda.synchronize()
    check(torch.equal(k_grads, k_grads2), "200k stream: two K5 runs differ")
    k_ms = elapsed_ms(lambda: diff_forward(binned, cfg, residuals=True), 20)
    k_bare_ms = elapsed_ms(lambda: diff_forward(binned, cfg), 20)
    b_ms = elapsed_ms(lambda: diff_backward(binned, cfg, cots, t_start), 20)
    with torch.no_grad():
        p_out = blend_binned_plain(binned, cfg)
        p_ms = elapsed_ms(lambda: blend_binned_plain(binned, cfg), 2)
    d_fwd = max(float((a - b).abs().max()) for a, b in zip(outs, p_out))
    check(d_fwd <= EPS_TOL, f"200k stream: K4 vs twin {d_fwd}")
    d_res = residual_error(binned, cfg)
    check(d_res <= EPS_TOL, f"200k stream: K4's residual vs its mirror {d_res}")
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
    cut2, rr = diff_cut2(pl, cfg)
    evals, inside = support_evals(pl[:, 0], pl[:, 1], cut2, binned, cfg)
    n_pairs = int(binned["offsets"][-1])
    t, tp, nf = cfg.num_tiles, cfg.tile_pixels, pl.shape[1]
    head = (t + 1) * 4 + n_pairs * 4 + pl.shape[0] * nf * 4  # offsets, ranks, planes
    # the chunk-start transmittances K4 writes: an output of the forward as
    # the step runs it.  They are this design's way to one backward pass,
    # not bytes the adjoint needs, so the backward's bound does not count them
    bc = bwd_chunk(cfg)
    resid = int(((binned["counts"] + (bc - 1)) // bc).sum()) * tp * 4
    fwd_bytes = head + t * tp * 5 * 4 + resid
    # + slots, cotangents, rows
    bwd_bytes = head + n_pairs * 4 + 2 * t * tp * 5 * 4 + n_pairs * nf * 4
    culled = cull_share(pl[:, 0], pl[:, 1], cut2, rr, binned, cfg)
    log(f"phase 7: the {n // 1000}k @{size}x{size} stream's tiles: {tile_load(binned)}; "
        f"{diff_heaviest_tile(binned, cfg)}")
    fb = bound("tile_blend_diff_fwd", fwd_bytes, evals, inside)
    bb = bound("tile_blend_diff_bwd", bwd_bytes, evals, inside)
    log(f"phase 7: kernels at the {n // 1000}k @{size}x{size} stream ({n_pairs} pairs, "
        f"{inside} of {evals} evaluations inside the support; culling removes {culled:.3f} of "
        f"the (record, warp) pairs): K4 {k_ms:.3f} ms with K5's residuals ({resid} B), "
        f"{k_bare_ms:.3f} ms without (bound {fb[0]:.4f} ms, {fb[1]}), twin {p_ms:.3f} ms, "
        f"max-abs {d_fwd:.3g}, residual vs its mirror {d_res:.3g}; K5 {b_ms:.3f} ms (bound "
        f"{bb[0]:.4f} ms, {bb[1]}), two runs bit-equal, twin backward {pb_ms:.3f} ms (peak "
        f"{twin_gib:.2f} GiB), max-rel {rel:.3g}; {card}")
    return dict(launches=k45, fwd=(k_ms, p_ms, fb, max(d_fwd, d_res)),
                bwd=(b_ms, pb_ms, bb, d_bwd))


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


def sh_kernel_alone(splats, sh, cam_pos, reps: int = 20) -> dict:
    """S1 (`ops/sh_colors.py`) alone at these inputs: `apply_sh` one
    launch a call and bit-equal to `apply_sh_plain` on the card; the
    kernel's device time (the profiler's, with the 50 MB L2 written over
    before each launch, and warm), the call's and the plain path's time
    (CUDA events over calls back to back), beside the bound: 216 bytes a
    splat once (6 planes and 45 coefficient rows read, 3 colour planes
    written) over HBM bandwidth."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.render.sh import apply_sh, apply_sh_plain

    n = splats["px"].shape[0]
    call = lambda: apply_sh(splats, sh, cam_pos)  # noqa: E731
    plain = lambda: apply_sh_plain(splats, sh, cam_pos)  # noqa: E731
    before = launches["sh_colors"]
    got, want = call(), plain()
    torch.cuda.synchronize()
    check(launches["sh_colors"] == before + 1, f"SH at {n} splats: not one launch a call")
    differ = {c: int((got[c].view(torch.int32) != want[c].view(torch.int32)).sum())
              for c in ("cr", "cg", "cb")}
    check(not any(differ.values()), f"SH at {n} splats: kernel vs plain path differ {differ}")
    del got, want
    call_ms = elapsed_ms(call, reps)
    plain_ms = elapsed_ms(plain, 5)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=splats["px"].device)
    kernel_ms = {}
    for cold in (True, False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush.fill_(0)
                call()
            torch.cuda.synchronize()
        kernel_ms[cold] = sum(e.self_device_time_total for e in prof.key_averages()
                              if "sh_colors_kernel" in e.key) / 1e3 / reps
        check(kernel_ms[cold] > 0, f"SH at {n} splats: the profiler saw no sh_colors_kernel")
    del flush
    return dict(ms=kernel_ms[True], warm_ms=kernel_ms[False], call_ms=call_ms,
                plain_ms=plain_ms, bound=(n * 216 / HBM_BYTES_S * 1e3, "bytes"))


def phase10_static_scene(dev, card: str, workdir: str, n: int = 1_000_000):
    """Static-scene serving at full width: .ply with SH degree 3 (kept in
    `workdir` for phase 13) -> SplatEngine (tile_xp) -> the HTTP viewer;
    then frame and stage times, tile vs tile_xp."""
    import os
    import statistics
    import tempfile

    import numpy as np
    import torch

    from splat_renderer_tpu_torch import Camera, PointConfig, RenderConfig
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.ops.sh_colors import PLANES
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
    from splat_renderer_tpu_torch.render.pipeline import SplatEngine, demo_scene, model_points
    from splat_renderer_tpu_torch.render.sh import apply_sh
    from splat_renderer_tpu_torch.utils.image import read_png
    from splat_renderer_tpu_torch.utils.ply import load_ply, save_ply

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
    path = os.path.join(workdir, "scene.ply")
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
    launches.clear()
    (h1, raw1, ms1), (h2, raw2, ms2), (h3, png, ms3), (h4, half, ms4) = serve_frames(
        eng_xp, ("az=0.5&el=0.5&d=3.0&raw=1", "az=2.0&el=0.5&d=3.0&raw=1",
                 "az=2.0&el=0.3&d=2.5", "az=2.0&el=0.3&d=2.5&raw=1&half=1"), timeout=120)
    served = int(h4["x-seq"])
    xp_launches = launches["tile_blend_xp"]
    check(xp_launches >= served >= 4,
          f"tile_blend_xp launched {xp_launches} times for {served} served frames")
    sh_launches = launches["sh_colors"]
    check(sh_launches >= served, f"the SH kernel launched {sh_launches} times for {served} "
          "served frames")
    check(len(raw1) == len(raw2) == width * height * 3, f"raw frame bytes {len(raw1)}")
    check(len(half) == (width // 2) * (height // 2) * 3, f"half frame bytes {len(half)}")
    check((int(h4["x-w"]), int(h4["x-h"])) == (width // 2, height // 2),
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
        f"X-Render-Ms {h1['x-render-ms']} / {h2['x-render-ms']} / "
        f"{h3['x-render-ms']} / {h4['x-render-ms']}); tile_blend_xp launches "
        f"{xp_launches}, sh_colors launches {sh_launches}; coverage {min(cov):.3f}..{max(cov):.3f} (> {COVERAGE_FLOOR}); moved "
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
    log(f"phase 10: the static-scene stream's tiles: {tile_load(binned)}; "
        f"{heaviest_tile(binned, rcfg)}")
    log(f"phase 10: kernels at the static-scene stream ({n_pairs} pairs, {nonempty} of "
        f"{rcfg.num_tiles} tiles nonempty, "
        f"{inside} of {evals} evaluations inside the support; culling removes "
        f"{packed_cull_share(binned, rcfg):.3f} of the (record, warp) pairs), "
        "ms in the order tile, tile_xp, tile_xp, tile: "
        + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in vs) for k, vs in t.items())
        + f"; plain twin (eps 0) {plain_ms:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); tile_xp "
        f"vs tile bit-equal, vs twin max-abs {err:.3g}; {card}")

    # ---- the SH kernel alone: this scene's 1M, and 2M in the benchmark's layout ----
    del binned, k1, k3, plain
    coef = torch.stack([sh[c] for c in ("r", "g", "b")])
    wide = {k: torch.cat([splats[k], splats[k]]) for k in PLANES}
    coef = torch.cat([coef, coef], dim=2)
    cams = torch.stack([cam_at(0.5)["cam_pos"], cam_at(2.0)["cam_pos"]])
    s1 = {"1M": sh_kernel_alone(splats, sh, cam["cam_pos"]),
          "2M": sh_kernel_alone(wide, dict(zip(("r", "g", "b"), coef)), cams[1])}
    del wide, coef
    log("phase 10: sh_colors (S1) alone, degree 3: lit colours bit-equal to the plain path, "
        "one launch a call; " + "; ".join(
            f"{k}: kernel {v['ms']:.4f} ms (device, profiler, L2 written over before each "
            f"launch; warm {v['warm_ms']:.4f}), call {v['call_ms']:.4f} ms (CUDA events, 20 "
            f"calls), plain path {v['plain_ms']:.3f} ms; bound {v['bound'][0]:.4f} ms, "
            f"{100 * v['bound'][0] / v['ms']:.1f}% of it" for k, v in s1.items()) + f"; {card}")
    return dict(launches=xp_launches, err=err, ms=statistics.mean(t["tile_xp eps 0"]),
                plain_ms=plain_ms, bound=bnd, ply=path, sh=dict(s1["1M"], launches=sh_launches))


def phase11_datagen(dev, card: str, headline_cfg, headline_cam, n: int = 1_000_000,
                    n_cut: int = 100_000, n_views: int = 2_000_000):
    """The G-buffer at the headline stream, the depth kernel vs its twin and
    the plain tile compositor, and 8 views x 2M splats as uint8."""
    import statistics

    import torch

    from splat_renderer_tpu_torch import Camera, PointConfig, RenderConfig, orbit_ring
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
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
    launches.clear()
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
    depth_launches = launches["tile_blend_depth"]
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
    log(f"phase 11: tile_blend_depth at the {n}-splat @1080p stream ({n_pairs} pairs; culling "
        f"removes {packed_cull_share(binned, rcfg):.3f} of the (record, warp) pairs): kernel "
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
    from splat_renderer_tpu_torch.ops.build import launches

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(pr.PANEL, generator=g, device=dev)
    errs = {}
    for dtype in ("f32", "bf16"):
        # mul by 0.5 is exact, so mul-then-add rounds once like the fused
        # chain: the results are equal bit for bit in both types
        errs[dtype] = 0.0
        for repeats in (1, 5, pr.REPEATS):
            got = pr.probe_rate(x, dtype, repeats=repeats, steps=4)
            want = pr.probe_rate_plain(x, dtype, repeats=repeats, steps=1)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            check(torch.equal(got, want), f"probe {dtype} repeats {repeats}: kernel vs twin {e}")
            check(bool(torch.isfinite(got).all()), f"probe {dtype}: non-finite")
            errs[dtype] = max(errs[dtype], e)
    # the probe's own entry point: these launches are the ones reported
    launches["probe_rate"] = 0
    rates = pr.measure(dev)
    n_launches = launches["probe_rate"]
    check(n_launches >= 2, f"probe_rate launched {n_launches} times")
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
            f"{lib_ms:.1f} ms; kernel vs twin max-abs {errs[dtype]:.3g} (bit-equal); {card}")
    log(f"phase 12: bf16 / f32 rate {rates['bf16']['tfma_s'] / rates['f32']['tfma_s']:.3f}; "
        f"launches by the entry point {n_launches}; {card}")
    out["launches"] = n_launches
    return out


def serve_frames(engine, queries, animate=None, timeout: float = 300):
    """Serve `engine` over HTTP on an ephemeral localhost port: check the
    viewer's page, then fetch `/frame?<query>` for each query, each chained
    on the previous frame's seq.  Returns [(headers, body, request ms on
    the host clock)]; the server and its render loop are stopped."""
    import threading
    import urllib.request

    from splat_renderer_tpu_torch.viewer import make_server

    server = make_server(engine, port=0, animate=animate, profile_stages=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out, seq = [], 0
    try:
        check(b"<canvas" in urllib.request.urlopen(f"{url}/", timeout=30).read(), "viewer page")
        for q in queries:
            t = time.perf_counter()
            r = urllib.request.urlopen(f"{url}/frame?{q}&seq={seq}", timeout=timeout)
            body = r.read()
            ms = (time.perf_counter() - t) * 1e3
            check(r.status == 200, f"/frame?{q}: status {r.status}")
            seq = int(r.headers["x-seq"])
            out.append((r.headers, body, ms))
    finally:
        server.shutdown()
        server.render_loop.stop()
        server.server_close()
        thread.join(timeout=30)
    check(server.render_loop.error is None,
          f"the viewer's render loop failed: {server.render_loop.error!r}")
    return out


def diff_vs_twin(cfg, planes, seed: int):
    """K4/K5 (`blend_planes`) against the twin and its autograd backward on
    one plane stream (cx, cy, radius, opacity, r, g, b, angle, ratio,
    depth; leaf tensors that require grad), under random cotangents made
    from `seed`: (forward max-abs, gradient max-abs, {field: gradient
    max-relative}, two backward runs bit-equal).  Checks every gate."""
    import torch

    from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_planes, blend_planes_plain

    prof = "oriented" if cfg.oriented else "isotropic"
    dev = planes[0].device
    g = torch.Generator(device=dev).manual_seed(seed)
    t, tp = cfg.num_tiles, cfg.tile_pixels
    cots = [torch.rand(s, generator=g, device=dev) - 0.5 for s in ((t, tp, 3), (t, tp), (t, tp))]
    k_out, k_grads = blend_and_grads(blend_planes, cfg, planes, cots)
    p_out, p_grads = blend_and_grads(blend_planes_plain, cfg, planes, cots)
    _, k_grads2 = blend_and_grads(blend_planes, cfg, planes, cots)
    torch.cuda.synchronize()
    d_fwd = max(float((a - b).abs().max()) for a, b in zip(k_out, p_out))
    check(d_fwd <= EPS_TOL, f"{prof}: K4 vs twin {d_fwd}")
    rel, d_abs = {}, 0.0
    for name, kg, pg in zip(DIFF_PLANES, k_grads, p_grads):
        if not cfg.oriented and name in ("angle", "ratio"):
            check(float(kg.abs().max()) == 0.0, f"isotropic {name} gradient")
            continue
        diff = float((kg - pg).abs().max())
        d_abs = max(d_abs, diff)
        rel[name] = diff / (float(pg.abs().max()) + 1e-12)
        check(rel[name] < DIFF_GRAD_TOL[prof], f"{prof}: K5 {name} max-rel {rel[name]}")
    same = all(torch.equal(a, b) for a, b in zip(k_grads, k_grads2))
    check(same, f"{prof}: two backward runs differ")
    return d_fwd, d_abs, rel, same


def phase13_front_ends(dev, card: str, workdir: str, ply_path: str, views: int = 8,
                       steps: int = 2, size: int = 800, points: int = 200_000):
    """The three front ends at the JAX scripts' defaults, in process:
    datagen --gbuffer (8 views x 2 steps, 200k points, 800x800), fit_demo on
    that dataset with the kernels, and demo's engines served over HTTP.
    After each front end's launches are counted, one of its streams goes
    through its kernels and their twin.  Returns the launch counts and the
    worst kernel-vs-twin errors."""
    import gc
    import json
    import os

    import numpy as np
    import torch

    from splat_renderer_tpu_torch import Camera, load_dataset
    from splat_renderer_tpu_torch.apps import datagen, demo, fit_demo
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
    from splat_renderer_tpu_torch.render.pipeline import demo_scene

    # a user starts each front end in a fresh process: release what the
    # earlier phases left in this one's heap and caching allocator
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(workdir, "dataset")
    dg_argv = ["--out", out, "--views", str(views), "--steps", str(steps), "--points", str(points),
               "--width", str(size), "--height", str(size), "--gbuffer", "--device", "cuda"]
    launches.clear()
    t0 = time.perf_counter()
    manifest = datagen.main(dg_argv)
    torch.cuda.synchronize()
    t_datagen = time.perf_counter() - t0
    depth_launches = launches["tile_blend_depth"]
    check(depth_launches == k1_launches() == views * steps,
          f"datagen launched {dict(launches)} for {views * steps} views")
    with open(os.path.join(out, "manifest.json")) as f:
        check(json.load(f) == manifest, "manifest.json differs from what datagen returned")
    check(len(manifest["frames"]) == views * steps, "manifest frames")
    for fr in manifest["frames"]:
        for k in ("file", "depth_file", "alpha_file"):
            check(os.path.exists(os.path.join(out, fr[k])), f"missing {fr[k]}")
        check(fr["depth_max"] >= fr["depth_min"] > 0.0, f"depth range of {fr['file']}")
    t0 = time.perf_counter()
    ds = load_dataset(out, gbuffer=True, device=dev)
    t_load = time.perf_counter() - t0
    check(len(ds["images"]) == views * steps and ds["images"][0].shape == (size, size, 3),
          "dataset images")
    cover = min(float((a > 0.5).float().mean()) for a in ds["alpha"])
    check(cover > COVERAGE_FLOOR, f"dataset alpha coverage {cover}")
    # the last view, binned with datagen's own configuration, splats and
    # camera: the depth form against its twin
    dargs = datagen.parse_args(dg_argv)
    dcfg = datagen.render_config(dargs)
    b_dg = words_and_bins(datagen.step_splats(demo_scene(), steps - 1, dargs, dcfg, dev),
                          ds["cameras"][-1], dcfg, with_depth=True)
    k = blend_tiles(b_dg, dcfg, eps=0.0, with_depth=True)
    p = blend_tiles_plain(b_dg, dcfg, eps=0.0, with_depth=True, pair_chunk=8192)
    torch.cuda.synchronize()
    d_rgba = max_diff(k[:2], p[:2])
    d_depth = float((k[2] - p[2]).abs().max()) / depth_range(b_dg)
    check(d_rgba <= EPS_TOL, f"datagen view: depth form vs twin, colour and alpha {d_rgba}")
    check(d_depth <= DEPTH_TOL, f"datagen view: depth form vs twin, depth {d_depth}")
    log(f"phase 13: datagen --gbuffer {views} views x {steps} steps, {points} points, "
        f"{size}x{size}: {t_datagen:.2f} s (host clock, PNG writes included), "
        f"{t_datagen / (views * steps) * 1e3:.1f} ms a view; depth-form launches "
        f"{depth_launches}; read back by load_dataset in {t_load:.2f} s, least alpha "
        f"coverage {cover:.3f}; its last view's stream ({int(b_dg['offsets'][-1])} pairs): "
        f"depth form vs twin at eps 0, colour and alpha max-abs {d_rgba:.3g} (<= {EPS_TOL}), "
        f"depth {d_depth:.3g} of the largest depth (<= {DEPTH_TOL}); {card}")

    launches.clear()
    t0 = time.perf_counter()
    fitted, losses = fit_demo.main(["--dataset", out, "--method", "kernel", "--device", "cuda"])
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    k4, k5 = launches["tile_blend_diff_forward"], launches["tile_blend_diff_backward"]
    n_steps, n_views = int(losses.shape[0]), views * steps
    check(k4 == k5 == n_steps * n_views, f"fit_demo launched K4 {k4}, K5 {k5} times for "
          f"{n_steps} steps of {n_views} views")
    check(k1_launches() == 0, "fit_demo launched the exact blend")
    check(bool(torch.isfinite(losses).all()), "fit_demo: non-finite loss")
    check(float(losses[-1]) < float(losses[0]), f"fit_demo: loss {float(losses[0]):.4g} -> "
          f"{float(losses[-1]):.4g} did not fall")
    psnr = float(-10.0 * torch.log10(losses[-1]))
    check(psnr == psnr and abs(psnr) != float("inf"), f"fit_demo PSNR {psnr}")
    # the fitted splats' first view, with fit_demo's configuration: K4 and
    # K5 against the twin and its autograd backward
    fcfg = fit_demo.dataset_config(ds)
    with torch.no_grad():
        fp = training_planes({k: v.detach() for k, v in fitted.items()}, ds["cameras"][0], fcfg)
    f_planes = [fp[k].detach().clone().requires_grad_(True) for k in DIFF_PLANES]
    d_k4, d_k5, rel, same = diff_vs_twin(fcfg, f_planes, 13)
    log(f"phase 13: fit_demo --dataset --method kernel (n {fitted['px'].shape[0]}, "
        f"{n_steps} steps x {n_views} views): {t_fit:.2f} s host clock, "
        f"{t_fit / n_steps * 1e3:.1f} ms a step; loss {float(losses[0]):.4g} -> "
        f"{float(losses[-1]):.4g}, PSNR {psnr:.2f} dB; K4 launches {k4}, K5 {k5}; the fitted "
        f"splats' first view: K4 vs twin max-abs {d_k4:.3g} (<= {EPS_TOL}), K5 gradient "
        f"max-rel {max(rel.values()):.3g} (< {DIFF_GRAD_TOL['isotropic']}, worst "
        f"{max(rel, key=rel.get)}), backward bit-identical on rerun: {same}; {card}")

    served, d_k1 = {}, 0.0
    for label, argv in (("sdf", ["--device", "cuda"]),
                        ("ply", ["--ply", ply_path, "--device", "cuda"])):
        args = demo.parse_args(argv)
        t0 = time.perf_counter()
        eng, animate = demo.build(args, dev)
        t_build = time.perf_counter() - t0
        launches.clear()
        got = serve_frames(eng, ("az=0.5&el=0.5&d=3.0&t=0.0&raw=1",
                                 "az=1.2&el=0.4&d=3.0&t=0.5&raw=1",
                                 "az=2.0&el=0.3&d=2.5&t=1.0&raw=1"), animate=animate)
        k1 = launches["tile_blend"]
        check(k1 == k1_launches() >= 3, f"demo {label}: K1 launched {k1} times for "
              f"3 frames ({dict(launches)})")
        for headers, body, _ in got:
            f = np.frombuffer(body, np.uint8).reshape(int(headers["x-h"]), int(headers["x-w"]), 3)
            check(f.shape == (args.height, args.width, 3), f"demo {label}: frame {f.shape}")
            check(coverage_u8(f, eng.rcfg.background) > COVERAGE_FLOOR,
                  f"demo {label}: coverage")
        served[label] = k1
        # the engine's own splats for a frame: K1 against its twin
        cam = camera_tensors(Camera(aspect=args.width / args.height).arrays(), dev)
        b = words_and_bins(eng._frame_splats(cam, torch.Generator(device=dev).manual_seed(0)),
                           cam, eng.rcfg)
        d = max_diff(blend_tiles(b, eng.rcfg, eps=0.0),
                     blend_tiles_plain(b, eng.rcfg, eps=0.0, pair_chunk=8192))
        check(d <= EPS_TOL, f"demo {label}: K1 vs twin {d}")
        d_k1 = max(d_k1, d)
        log(f"phase 13: demo {label} at {args.width}x{args.height} (n {eng.n}; built in "
            f"{t_build:.2f} s): 3 frames over HTTP, request ms "
            + " ".join(f"{ms:.1f}" for *_, ms in got) + ", X-Render-Ms "
            + " ".join(h["x-render-ms"] for h, *_ in got) + f"; K1 launches {k1}; a frame's "
            f"stream ({int(b['offsets'][-1])} pairs): K1 vs twin max-abs {d:.3g} (<= "
            f"{EPS_TOL}); {card}")
    return dict(depth=depth_launches, k4=k4, k5=k5, k1=served,
                err=dict(k1=d_k1, depth=max(d_rgba, d_depth), k4=d_k4, k5=d_k5))


def phase14_mesh(dev, card: str):
    """Mesh export of the demo scene at resolutions 96 and 256."""
    import numpy as np
    import torch

    from splat_renderer_tpu_torch.render.pipeline import demo_scene
    from splat_renderer_tpu_torch.sdf import extract_mesh

    scene = demo_scene()
    params = scene.params(dev)
    for res in (96, 256):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = extract_mesh(scene, params, resolution=res)
        t = time.perf_counter() - t0
        v, f = m["vertices"], m["faces"]
        e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        _, uses = np.unique(e[:, 0].astype(np.int64) * len(v) + e[:, 1], return_counts=True)
        chi = len(v) - len(uses) + len(f)
        watertight = bool((uses == 2).all())
        d = scene.sdf(torch.from_numpy(v).to(dev), params)[0].abs().max().item()
        check(len(f) > 0 and watertight and chi == 2,
              f"mesh at {res}: chi {chi}, watertight {watertight}")
        check(d < 1e-3, f"mesh at {res}: vertices {d} off the surface")
        log(f"phase 14: extract_mesh demo scene at {res}: {len(v)} vertices, {len(f)} faces, "
            f"Euler characteristic {chi}, watertight {watertight}, max |sdf| at the vertices "
            f"{d:.2e}; {t:.2f} s host clock; {card}")


def phase15_turbo(dev, card: str, headline_cfg, headline_cam, n: int = 1_000_000):
    """The turbo profile at the headline shape against the exact one: image
    quality, depth_key_order's bit-equality, K1 vs its twin on the turbo
    stream, and the bin stage's and the frame's times, interleaved.  The
    binner never sorts the records; a third bin time sorts them into
    canonical order first (`canonical_order` and a gather of the four word
    planes), which is the cost the binner's design leaves out."""
    import statistics

    import torch

    from splat_renderer_tpu_torch import PointConfig, turbo_render_config
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
    from splat_renderer_tpu_torch.render.binning import bin_packed_words, canonical_order
    from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points, render_splats
    from splat_renderer_tpu_torch.render.projector import splat_screen_words
    from splat_renderer_tpu_torch.utils.ssim import ssim_np

    exact, cam = headline_cfg, headline_cam
    geometry = {k: getattr(exact, k) for k in
                ("base_radius", "tiles_per_splat_cap", "tile_size", "tile_height")}
    turbo = turbo_render_config(exact.width, exact.height, **geometry)
    dko = exact.replace(depth_key_order=True)
    scene = demo_scene()
    splats = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(31),
                          n, PointConfig(), exact, device=dev)
    frames = {name: render_splats(splats, cam, cfg, device=dev)
              for name, cfg in (("exact", exact), ("turbo", turbo), ("dko", dko))}
    torch.cuda.synchronize()
    check(torch.equal(frames["dko"], frames["exact"]),
          "depth_key_order frame differs from the exact frame")
    quality = ssim_np(frames["turbo"].cpu().numpy(), frames["exact"].cpu().numpy())
    check(quality > 0.985, f"turbo vs exact SSIM {quality}")
    keys = ("dk", "w_pos", "w_ro", "w_rgb")
    words = {name: [w[k] for k in keys] for name, w in (
        (name, splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], cfg))
        for name, cfg in (("exact", exact), ("turbo", turbo)))}
    cfgs = {"exact": exact, "turbo": turbo}

    def bins(name, with_depth=False):
        return bin_packed_words(*words[name], cfgs[name], with_depth=with_depth)

    def bins_sorted(with_depth=False):
        order = canonical_order(words["exact"][0])
        return order, bin_packed_words(*(w[order] for w in words["exact"]), exact,
                                       with_depth=with_depth)

    b_turbo = bins("turbo")
    k = blend_tiles(b_turbo, turbo, eps=0.0)
    p = blend_tiles_plain(b_turbo, turbo, eps=0.0, pair_chunk=8192)
    torch.cuda.synchronize()
    err = max_diff(k, p)
    check(err <= EPS_TOL, f"K1 vs twin on the turbo stream: {err}")
    # the record-sorted stream holds the same records in the same order per
    # tile, so K1 and its depth form give the same bits on it; its words lie
    # in depth order, a tile's records near each other in memory
    streams = {"exact": bins("exact", True), "after a record sort": bins_sorted(True)[1]}
    b_exact, (order, b_sorted) = bins("exact"), bins_sorted()
    live = int(b_exact["offsets"][-1])
    check(torch.equal(b_exact["offsets"], b_sorted["offsets"])
          and torch.equal(b_exact["pair_rank"][:live].long(),
                          order[b_sorted["pair_rank"][:live].long()]),
          "the binner's runs differ from the record-sorted stream's")
    for with_depth in (False, True):
        a, b = (blend_tiles(v, exact, with_depth=with_depth) for v in streams.values())
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"with_depth={with_depth}: the record-sorted stream blends to other bits")

    def timed(fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    t = {key: [] for key in ("bin exact", "bin turbo", "bin after a record sort",
                             "frame exact", "frame turbo", "K1 exact", "K1 after a record sort",
                             "depth form exact", "depth form after a record sort")}
    for i in range(5):
        for name in (("exact", "turbo") if i % 2 == 0 else ("turbo", "exact")):
            t[f"bin {name}"].append(timed(lambda: bins(name)))
            t[f"frame {name}"].append(
                timed(lambda: render_splats(splats, cam, cfgs[name], device=dev)))
        t["bin after a record sort"].append(timed(bins_sorted))
        for name in (("exact", "after a record sort") if i % 2 == 0
                     else ("after a record sort", "exact")):
            t[f"K1 {name}"].append(timed(lambda: blend_tiles(streams[name], exact)))
            t[f"depth form {name}"].append(
                timed(lambda: blend_tiles(streams[name], exact, with_depth=True)))
    med = {key: statistics.median(v) for key, v in t.items()}
    log(f"phase 15: turbo profile at {exact.width}x{exact.height} {exact.tile_w}x{exact.tile_h} "
        f"cap {exact.tiles_per_splat_cap}, {n} splats: SSIM vs exact {quality:.5f} (> 0.985); "
        f"depth_key_order alone equal to the exact frame bit for bit; K1 vs twin on the turbo "
        f"stream ({int(b_turbo['offsets'][-1])} pairs) max-abs {err:.3g} (<= {EPS_TOL}); the "
        "exact stream's runs equal to those of the record-sorted stream, and K1's and the "
        f"depth form's outputs on the two bit-equal; CUDA-event ms at eps "
        f"{exact.transmittance_eps}, 5 of each interleaved: "
        + "; ".join(f"{key} " + " ".join(f"{x:.3f}" for x in v) + f" (median {med[key]:.3f})"
                    for key, v in t.items()) + f"; {card}")
    return med


def timed_ms(fn) -> float:
    """CUDA-event ms of one call of fn."""
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def interleaved(fns: dict, reps: int = 3) -> dict:
    """Median CUDA-event ms of each fn, `reps` rounds, the order of each
    round reversed from the last."""
    import statistics

    times = {k: [] for k in fns}
    keys = list(fns)
    for i in range(reps):
        for k in (keys if i % 2 == 0 else keys[::-1]):
            times[k].append(timed_ms(fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def span_times(prof, prefix: str, calls: int) -> dict:
    """{span: (host ms, device-kernel ms)} a call, for the program's spans
    named prefix... in a `utils.profiling.trace` of `calls` calls (where
    each span is a profiler range "splat/<name>"): the span's wall time on
    the host and the summed time of the kernels launched inside it."""
    import torch

    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(prefix):
            h, d = out.get(e.name[len(prefix):], (0.0, 0.0))
            out[e.name[len(prefix):]] = (h + e.cpu_time_total / 1e3 / calls,
                                         d + e.device_time_total / 1e3 / calls)
    return out


def profile_compare(fn_a, fn_b, warmup: int = 3, top: int = 6) -> str:
    """One call each of fn_a and fn_b under torch.profiler, after `warmup`
    untimed calls of each: their CUDA-event ms, device-kernel ms, kernel
    and CUDA-runtime call counts, and the ops whose self host time or self
    device time differs most between the two (a minus b)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn_a()
        fn_b()
    torch.cuda.synchronize()
    runs = []
    for fn in (fn_a, fn_b):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = timed_ms(fn)
        ops = {}
        for e in prof.key_averages():
            cuda = e.device_type == torch.autograd.DeviceType.CUDA
            ops[(e.key, cuda)] = (e.self_cpu_time_total / 1e3, e.self_device_time_total / 1e3,
                                  e.count)
        runs.append((wall, ops))
    (wa, a), (wb, b) = runs
    busy = [sum(v[1] for (k, cuda), v in ops.items() if cuda) for ops in (a, b)]
    count = [sum(v[2] for (k, cuda), v in ops.items() if cuda) for ops in (a, b)]
    api = [sum(v[2] for (k, cuda), v in ops.items() if not cuda and k.startswith("cuda"))
           for ops in (a, b)]
    zero = (0.0, 0.0, 0)
    keys = set(a) | set(b)
    host = sorted(keys, key=lambda k: -abs(a.get(k, zero)[0] - b.get(k, zero)[0]))[:top]
    dev = sorted(keys, key=lambda k: -abs(a.get(k, zero)[1] - b.get(k, zero)[1]))[:top // 2]
    fmt = lambda k, i: (f"{k[0][:48]} {a.get(k, zero)[i]:.3f} vs {b.get(k, zero)[i]:.3f} "  # noqa: E731
                        f"(x{a.get(k, zero)[2]} vs x{b.get(k, zero)[2]})")
    return (f"wall {wa:.3f} vs {wb:.3f} ms, device kernels {busy[0]:.3f} vs {busy[1]:.3f} ms "
            f"({count[0]} vs {count[1]} kernels, {api[0]} vs {api[1]} CUDA runtime calls); "
            "self host ms most apart: " + "; ".join(fmt(k, 0) for k in host)
            + "; self device ms most apart: " + "; ".join(fmt(k, 1) for k in dev))


def phase16_parallel(dev, card: str, headline_cfg, headline_cam, n: int = 1_000_000,
                     slack: float = 1.5):
    """Multi-device rendering and training (`parallel/`, `fit_splats_dp`)
    on the one card, under an NCCL process group of world size 1 that the
    phase creates and destroys.  NCCL refuses two ranks on one GPU, so the
    collectives run at one rank (16a) and the depth bands of sp = 2 and 4
    run one after another on the card (16b).  Returns the launches and
    kernel-vs-twin errors of K1, K4 and K5 on these paths."""
    import math

    import torch
    import torch.distributed as dist

    from splat_renderer_tpu_torch import PointConfig, RenderConfig, orbit_ring
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.fit import fit_splats, fit_splats_dp
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
    from splat_renderer_tpu_torch.parallel import (
        band_frame_fn, depth_band, make_mesh, multichip_frame_fn, rank_generator, render_band,
        render_views_data_parallel,
    )
    from splat_renderer_tpu_torch.parallel.band import INF_KEY, WORDS, band_words, fold_bands
    from splat_renderer_tpu_torch.parallel.sharding import _band_cfg, band_records
    from splat_renderer_tpu_torch.render.binning import (
        _compact_nearest, bin_packed_words, bin_splats, canonical_sort_data,
    )
    from splat_renderer_tpu_torch.render.compositor import render_tiles, tiles_to_image
    from splat_renderer_tpu_torch.render.diff import render_diff
    from splat_renderer_tpu_torch.render.multiview import camera_at
    from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points, render_splats
    from splat_renderer_tpu_torch.render.projector import splat_screen_records, splat_screen_words
    from splat_renderer_tpu_torch.utils.profiling import RANGE_PREFIX, trace

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh()  # dp = sp = 1 on the default device, cuda:0
        check(mesh.device == torch.device("cuda:0"), f"mesh device {mesh.device}")
        scene, pcfg, rcfg, cam = demo_scene(), PointConfig(), headline_cfg, headline_cam
        params = scene.params(dev)
        seed = 16
        out = {"k1_launches": 0}

        # ---- 16a: the depth-band frame at one rank against the frame ----
        band = band_frame_fn(scene, mesh, n, pcfg, rcfg, band_slack=slack)
        launches.clear()
        img, stats = band(params, cam, seed)
        torch.cuda.synchronize()
        out["k1_launches"] += k1_launches()
        check(k1_launches() == 1, f"band frame launched K1 {k1_launches()} times")
        splats = model_points(scene, params, rank_generator(seed, 0, dev), n, pcfg, rcfg,
                              device=dev)
        ref = render_splats(splats, cam, rcfg, device=dev)
        check(torch.equal(img, ref), "band frame (one rank) differs from render_splats")
        stats = {k: int(v) for k, v in stats.items()}
        check(stats["routed_records"] == 0 and not stats["band_overflow"],
              f"band frame stats {stats}")
        t_band = interleaved({"band frame": lambda: band.from_splats(splats, cam),
                              "render_splats": lambda: render_splats(splats, cam, rcfg,
                                                                     device=dev)})

        # the band frame's stages: its "band/..." spans in a profiler trace
        with tempfile.TemporaryDirectory() as tmp, trace(tmp) as prof:
            for _ in range(3):
                band.from_splats(splats, cam)
            torch.cuda.synchronize()
        t_stages = span_times(prof, RANGE_PREFIX + "band/", 3)
        check(len(t_stages) == 7, f"band frame spans {sorted(t_stages)}")
        # K1 is launched by its wrapper, outside any aten op, and the
        # profiler files its kernel under no span: read the kernel itself
        k1_span = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "tile_blend_kernel" in e.key) / 1e3 / 3

        # ---- 16a: tile bands at dp = sp = 1, 8 orbit views ----
        cams8 = camera_tensors(orbit_ring(8, aspect=rcfg.width / rcfg.height), dev)
        multi = multichip_frame_fn(scene, mesh, n, pcfg, rcfg)
        launches.clear()
        views = multi.gather(multi(params, cams8, seed))
        torch.cuda.synchronize()
        out["k1_launches"] += k1_launches()
        check(k1_launches() == 8, f"8 views launched K1 {k1_launches()} times")
        loop = lambda: torch.stack([render_splats(splats, camera_at(cams8, i), rcfg,  # noqa: E731
                                                  device=dev) for i in range(8)])
        check(torch.equal(views, loop()), "multichip views differ from render_splats")
        t_multi = interleaved({"multichip 8 views": lambda: multi.from_splats(splats, cams8),
                               "render_splats x 8": loop})

        # ---- 16a: view-DP records, 8 views x 100k at 512x512 ----
        vcfg = RenderConfig(width=512, height=512, base_radius=0.008, tiles_per_splat_cap=4)
        spl_v = model_points(scene, params, torch.Generator(device=dev).manual_seed(17), 100_000,
                             pcfg, vcfg, device=dev)
        cams_v = camera_tensors(orbit_ring(8), dev)
        records = torch.stack([splat_screen_records(spl_v, camera_at(cams_v, i)["view_proj"],
                                                    camera_at(cams_v, i)["cam_pos"], vcfg)
                               for i in range(8)])

        def views_loop():
            return torch.stack([render_tiles(canonical_sort_data(r), bin_splats(
                canonical_sort_data(r), vcfg), vcfg) for r in records])

        # render_tiles sums with index_add, whose CUDA form adds in any
        # order: compare in its deterministic form, time the usual one
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            dp_views = render_views_data_parallel(records, mesh, vcfg)
            check(torch.equal(dp_views, views_loop()), "render_views_data_parallel != loop")
        finally:
            torch.use_deterministic_algorithms(False)
        t_views = interleaved({"views DP": lambda: render_views_data_parallel(
            records, mesh, vcfg), "per-view loop": views_loop}, reps=2)

        # ---- 16a: fit_splats_dp, 3 steps over 8 views at 200k @512x512 ----
        cfg_t, spl_t, _ = training_scene(dev)
        cams_f = camera_tensors(orbit_ring(8), dev)
        cam_list = [camera_at(cams_f, i) for i in range(8)]
        with torch.no_grad():
            targets = torch.stack([render_diff(spl_t, c, cfg_t, method="kernel")
                                   for c in cam_list])
        init = {k: torch.full_like(spl_t[k], 0.5) for k in APPEARANCE}
        kw = dict(fields=APPEARANCE, steps=3, lr=1e-2, method="kernel", init=init)
        launches.clear()
        dp_fit, dp_losses = fit_splats_dp(spl_t, cams_f, targets, mesh, cfg_t, **kw)
        torch.cuda.synchronize()
        k45 = (launches["tile_blend_diff_forward"], launches["tile_blend_diff_backward"])
        out["k4_launches"], out["k5_launches"] = k45
        check(k45 == (24, 24), f"fit_splats_dp launched K4/K5 {k45[0]}/{k45[1]}")
        one_fit, one_losses = fit_splats(spl_t, cam_list, list(targets), cfg_t, **kw)
        check(torch.equal(dp_losses, one_losses), f"fit_splats_dp losses {dp_losses.tolist()} "
              f"!= fit_splats {one_losses.tolist()}")
        check(all(torch.equal(dp_fit[k], one_fit[k]) for k in APPEARANCE),
              "fit_splats_dp theta differs from fit_splats")
        t_fit = interleaved({
            "fit_splats_dp 3 steps": lambda: fit_splats_dp(spl_t, cams_f, targets, mesh, cfg_t,
                                                           **kw),
            "fit_splats 3 steps": lambda: fit_splats(spl_t, cam_list, list(targets), cfg_t,
                                                     **kw)}, reps=5)
        fit_dp = lambda: fit_splats_dp(spl_t, cams_f, targets, mesh, cfg_t,  # noqa: E731
                                       **dict(kw, steps=1))
        fit_one = lambda: fit_splats(spl_t, cam_list, list(targets), cfg_t,  # noqa: E731
                                     **dict(kw, steps=1))
        fit_profile = ["fit_splats_dp first, against fit_splats: "
                       + profile_compare(fit_dp, fit_one),
                       "fit_splats first, against fit_splats_dp: "
                       + profile_compare(fit_one, fit_dp)]
        with torch.no_grad():
            fp = training_planes(spl_t, cam_list[1], cfg_t)
        f_planes = [fp[k].detach().clone().requires_grad_(True) for k in DIFF_PLANES]
        out["k4_err"], out["k5_err"], rel, _ = diff_vs_twin(cfg_t, f_planes, 16)
        log(f"phase 16a: NCCL world size 1 on {mesh.device}: band_frame_fn {n} splats "
            f"@{rcfg.width}x{rcfg.height} {rcfg.tile_w}x{rcfg.tile_h} cap "
            f"{rcfg.tiles_per_splat_cap} slack {slack}: image equal to render_splats bit for "
            f"bit, stats {stats}; multichip_frame_fn(dp=1, sp=1) 8 orbit views each equal to "
            f"render_splats; render_views_data_parallel 8 views x {spl_v['px'].shape[0]} "
            f"@{vcfg.width}x{vcfg.height} equal to the per-view loop; fit_splats_dp 3 steps x 8 "
            f"views {spl_t['px'].shape[0]} @{cfg_t.width}x{cfg_t.height}: losses "
            + " ".join(f"{v:.6g}" for v in dp_losses.tolist())
            + " equal to fit_splats' bit for bit, theta equal; K4/K5 launches 24/24, vs twin on "
            f"view 1 K4 max-abs {out['k4_err']:.3g}, K5 gradient max-abs {out['k5_err']:.3g} "
            f"(max-rel {max(rel.values()):.3g}); CUDA-event "
            f"medians ms: " + "; ".join(f"{k} {v:.3f}" for t in (t_band, t_multi, t_views, t_fit)
                                       for k, v in t.items())
            + "; band frame stages (profiler spans, mean of 3, host / device-kernel ms) "
            + " ".join(f"{k} {h:.3f}/{d:.3f}" for k, (h, d) in t_stages.items())
            + f" (blend's K1 kernel {k1_span:.3f}, filed under no span); {card}")
        for line in fit_profile:
            log("phase 16a: one fit step under torch.profiler (after 3 untimed), " + line
                + f"; {card}")

        # ---- 16b: depth bands of sp = 2 and 4, one after another ----
        w = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], rcfg)
        words = torch.stack([w[k] for k in WORDS])
        ref0 = render_splats(splats, cam, rcfg, blend_eps=0.0, device=dev)
        full = bin_packed_words(*words, rcfg)
        t_one = interleaved({"bin": lambda: bin_packed_words(*words, rcfg),
                             "K1": lambda: blend_tiles(full, rcfg)})
        out["k1_err"] = 0.0
        rows = []
        for sp in (2, 4):
            capacity = math.ceil(slack * n / sp)
            bands = depth_band(words[0], mesh.group, sp)
            launches.clear()
            parts = {0.0: ([], []), None: ([], [])}
            streams = []
            for b in range(sp):
                received = band_words(words, bands, b)  # what rank b would receive, flattened
                binned = bin_packed_words(*received, rcfg, compact_to=capacity)
                for eps, (cs, als) in parts.items():
                    c, a = blend_tiles(binned, rcfg, eps)
                    cs.append(c)
                    als.append(a)
                streams.append((received, binned))
            torch.cuda.synchronize()
            out["k1_launches"] += k1_launches()
            check(k1_launches() == 2 * sp, f"sp={sp}: K1 launches {k1_launches()}")
            img0 = tiles_to_image(*fold_bands(*parts[0.0]), rcfg)
            img = tiles_to_image(*fold_bands(*parts[None]), rcfg)
            d0 = float((img0 - ref0).abs().max())
            de = float((img - ref0).abs().max())
            check(d0 <= 3e-5, f"sp={sp}: band frame at eps 0 vs the frame {d0}")
            check(de <= EARLY_EXIT_TOL, f"sp={sp}: band frame at eps 0.01 vs the frame {de}")
            per_band = []
            for b, (received, binned) in enumerate(streams):
                n_valid = int((received[0] < INF_KEY).sum())
                check(n_valid <= capacity, f"sp={sp} band {b}: {n_valid} records > {capacity}")
                tb = interleaved({
                    "bin": lambda: bin_packed_words(*received, rcfg, compact_to=capacity),
                    "compaction": lambda: _compact_nearest(capacity, *received),
                    "K1": lambda: blend_tiles(binned, rcfg)})
                per_band.append(f"band {b}: {n_valid} records, {int(binned['offsets'][-1])} "
                                f"pairs, bin {tb['bin']:.3f} ms (its compaction "
                                f"{tb['compaction']:.3f}), K1 {tb['K1']:.3f} ms")
            if sp == 2:  # K1 against its twin on a compacted band stream
                binned = streams[0][1]
                k = blend_tiles(binned, rcfg, eps=0.0)
                p = blend_tiles_plain(binned, rcfg, eps=0.0, pair_chunk=8192)
                torch.cuda.synchronize()
                out["k1_err"] = max_diff(k, p)
                check(out["k1_err"] <= EPS_TOL, f"K1 vs twin on band 0: {out['k1_err']}")
            rows.append(f"sp={sp} (capacity {capacity}): eps 0 max-abs {d0:.3g} (<= 3e-05), "
                        f"eps {rcfg.transmittance_eps} {de:.3g} (<= {EARLY_EXIT_TOL}); "
                        + "; ".join(per_band))
        log(f"phase 16b: depth bands one after another on the card, {n} splats "
            f"@{rcfg.width}x{rcfg.height}: the frame's stream {int(full['offsets'][-1])} pairs, "
            f"bin {t_one['bin']:.3f} ms, K1 {t_one['K1']:.3f} ms; " + "; ".join(rows)
            + f"; K1 vs twin on sp=2 band 0 max-abs {out['k1_err']:.3g}; CUDA-event medians "
            f"of 3; {card}")

        # ---- 16b: tile bands of sp = 2 and 4, one after another ----
        t_frame = interleaved({"frame render_band": lambda: render_band(w, 0, rcfg, 1)})
        rows = []
        for sp in (2, 4):
            band_cfg = _band_cfg(rcfg, sp)
            launches.clear()
            img = torch.cat([render_band(w, b, rcfg, sp) for b in range(sp)])[:rcfg.height]
            torch.cuda.synchronize()
            out["k1_launches"] += k1_launches()
            check(k1_launches() == sp, f"sp={sp}: tile bands launched K1 "
                  f"{k1_launches()} times")
            check(torch.equal(img, ref), f"sp={sp}: tile bands differ from render_splats")
            per_band = []
            for b in range(sp):
                recs = band_records(w, b, rcfg, band_cfg)
                binned = bin_packed_words(recs["dk"], recs["w_pos"], recs["w_ro"],
                                          recs["w_rgb"], rcfg)
                t0, t1 = b * band_cfg.num_tiles, (b + 1) * band_cfg.num_tiles
                pairs = int(binned["offsets"][t1] - binned["offsets"][t0])
                tb = interleaved({
                    "select": lambda: band_records(w, b, rcfg, band_cfg),
                    "bin": lambda: bin_packed_words(recs["dk"], recs["w_pos"], recs["w_ro"],
                                                    recs["w_rgb"], rcfg),
                    "render_band": lambda: render_band(w, b, rcfg, sp)})
                per_band.append(f"band {b}: {recs['dk'].shape[0]} records, {pairs} pairs, "
                                f"select {tb['select']:.3f} ms, bin {tb['bin']:.3f} ms, "
                                f"render_band {tb['render_band']:.3f} ms")
            rows.append(f"sp={sp}: equal to render_splats bit for bit; " + "; ".join(per_band))
        log(f"phase 16b: tile bands one after another on the card, {n} splats "
            f"@{rcfg.width}x{rcfg.height}: the frame's bin {t_one['bin']:.3f} ms, render_band "
            f"of the whole frame {t_frame['frame render_band']:.3f} ms; " + "; ".join(rows)
            + f"; CUDA-event medians of 3; {card}")
        return out
    finally:
        dist.destroy_process_group()


def phase17_projector(dev, card: str, headline_cfg, headline_cam, n: int = 1_000_000,
                      reps: int = 20) -> dict:
    """The projector kernel at the headline shape: the demo scene's splats
    as `model_points` returns them on the card (each plane a row of one
    (11, N) tensor, as Engine frames hand them to P1), at headline_cfg's
    1920x1080, on three configs (isotropic, the surface preset's
    foreshortened ellipses, EWA with the dilation).  Each: the kernel's
    five outputs bit-equal to `splat_screen_words_plain`, on those rows and
    (untimed) on position and normal as the plain modeler's stride-3
    columns; on the rows, the
    kernel's device time (the profiler's, a launch, with the L2 cache
    written over before each launch, and warm), the call's time (CUDA
    events over `reps` calls back to back, so the host's issuing counts)
    and the plain path's call time, beside the bound: the bytes once
    (11 float32 planes in, four int64 words and the float32 depth out) over
    HBM bandwidth.  Returns the isotropic config's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import splat_renderer_tpu_torch as spt
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points
    from splat_renderer_tpu_torch.render.projector import (
        splat_screen_words, splat_screen_words_plain,
    )

    scene = demo_scene()
    splats = model_points(scene, scene.params(dev), torch.Generator(device=dev).manual_seed(17),
                          n, spt.PointConfig(), headline_cfg, device=dev)
    check(splats["px"].stride(0) == 1 and splats["nz"].stride(0) == 1,
          "the modeler's planes are no longer rows")
    # the plain modeler's layout: position and normal as stride-3 columns
    columns = dict(splats)
    for keys in (("px", "py", "pz"), ("nx", "ny", "nz")):
        cols = torch.stack([splats[k] for k in keys], dim=1)
        columns.update({k: cols[:, j] for j, k in enumerate(keys)})
    check(columns["px"].stride(0) == 3, "the positions are not stride-3 columns")
    vp, cp = headline_cam["view_proj"], headline_cam["cam_pos"]
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    n_bytes = n * (11 * 4 + 4 * 8 + 4)
    bnd = (n_bytes / HBM_BYTES_S * 1e3, "bytes")
    cfgs = {
        "isotropic": headline_cfg,
        "surface": spt.surface_render_config(headline_cfg.width, headline_cfg.height,
                                             tiles_per_splat_cap=8),
        "ewa_aa": headline_cfg.replace(oriented=True, ellipse="ewa", aa_dilation=0.3),
    }
    out = {}
    for name, cfg in cfgs.items():
        call = lambda: splat_screen_words(splats, vp, cp, cfg)  # noqa: E731
        plain = lambda: splat_screen_words_plain(splats, vp, cp, cfg)  # noqa: E731
        before = launches["project_words"]
        got, want = call(), plain()
        torch.cuda.synchronize()
        check(launches["project_words"] == before + 1, f"{name}: not one launch a call")
        differ = {k: int((bits(got[k]) != bits(want[k])).sum()) for k in want}
        check(not any(differ.values()), f"{name}: kernel vs plain path differ {differ}")
        got_c = splat_screen_words(columns, vp, cp, cfg)
        want_c = splat_screen_words_plain(columns, vp, cp, cfg)
        torch.cuda.synchronize()
        check(launches["project_words"] == before + 2, f"{name}: not one launch a call")
        differ = {k: int((bits(got_c[k]) != bits(want_c[k])).sum()) for k in want_c}
        check(not any(differ.values()),
              f"{name}: kernel vs plain path differ on stride-3 columns {differ}")
        del got_c, want_c
        call_ms = elapsed_ms(call, reps)
        plain_ms = elapsed_ms(plain, 5)
        call_ms_2 = elapsed_ms(call, reps)
        # the kernel's device time with the 50 MB L2 written over before each
        # launch (its inputs and outputs are 80 MB: read back warm from L2 it
        # beat HBM's bound), and warm, launch after launch
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
        kernel_ms = {}
        for cold in (True, False):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    if cold:
                        flush.fill_(0)
                    call()
                torch.cuda.synchronize()
            kernel_ms[cold] = sum(e.self_device_time_total for e in prof.key_averages()
                                  if "project_words_kernel" in e.key) / 1e3 / reps
            check(kernel_ms[cold] > 0, f"{name}: the profiler saw no project_words_kernel")
        del flush
        ms = kernel_ms[True]
        valid = int(torch.isfinite(got["depth"]).sum())
        log(f"phase 17: project_words {name} at {n} splats @{cfg.width}x{cfg.height} ({valid} "
            f"in front, M1's rows): five outputs bit-equal to the plain path, and on "
            f"stride-3 columns; kernel {ms:.4f} ms (device, "
            f"profiler, L2 written over before each launch; warm {kernel_ms[False]:.4f}), call {call_ms:.4f} / {call_ms_2:.4f} ms (CUDA events, {reps} calls), "
            f"plain path {plain_ms:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}: {n_bytes / 1e6:.0f} "
            f"MB), {100 * bnd[0] / ms:.1f}% of it; {card}")
        out[name] = dict(ms=ms, call_ms=min(call_ms, call_ms_2), plain_ms=plain_ms, bound=bnd)
    return out["isotropic"]


def bin_bound_bytes(n: int, cfg, with_depth: bool = False) -> int:
    """The bytes `bin_packed_words` has to move, each once: the four int64
    words read, the int32 record planes written (three, four with the
    depth plane), pair_rank and pair_tile written over all N*cap slots,
    offsets and counts."""
    return (n * (4 * 8 + 4 * (3 + with_depth)) + n * cfg.tiles_per_splat_cap * 8
            + (2 * cfg.num_tiles + 1) * 4)


def bin_design_bytes(n: int, pairs: int, cfg) -> int:
    """The bytes B1's own passes move at least: `bin_bound_bytes` and the
    live pairs written (int64 key, int32 value) and sorted (each 8-bit
    radix pass reads and writes both)."""
    passes = -(-(32 + cfg.num_tiles.bit_length()) // 8)
    return bin_bound_bytes(n, cfg) + pairs * 12 * (1 + 2 * passes)


def phase18_binner(dev, card: str, headline_cfg, headline_cam, reps: int = 10) -> dict:
    """The binner's kernels (B1) at three shapes: the demo scene's 1M
    splats at headline_cfg (1920x1080, 32x16 tiles, cap 4, isotropic) from
    headline_cam, as phase 3's Engine frames bin them; the same scene on
    16x16 tiles; and view 0 of `gs3d_aniso_2m_1080p`'s 2M Gaussians (the
    benchmark's scene from seed 7; cap 8, oriented `cov3d`).  Each:
    `bin_packed_words`' outputs bit-equal to `bin_packed_words_plain` over
    the live pairs, the tail the sentinel; the device time of the call's
    kernels (the profiler's sum over its footprint, scan, emit, sort,
    ranges and counts kernels, with the 50 MB L2 written over before each
    call), the call's time (CUDA events over `reps` calls back to back:
    the host's issuing and the read-back of P count) and the plain
    path's, beside two bounds over HBM bandwidth: the function's bytes
    (`bin_bound_bytes`) and those of the design's passes
    (`bin_design_bytes`, the sort's included).  Returns the headline
    shape's numbers, bound by the function's bytes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import splat_renderer_tpu_torch as spt
    from gpubench.bench import cell_parts
    from gpubench.drivers.views import gaussian_scene
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.render.binning import bin_packed_words, bin_packed_words_plain
    from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points
    from splat_renderer_tpu_torch.render.projector import splat_screen_words

    demo_cfg = headline_cfg.replace(tile_size=16, tile_height=16)
    scene = demo_scene()
    demo = lambda cfg: model_points(  # noqa: E731
        scene, scene.params(dev), torch.Generator(device=dev).manual_seed(18), 1_000_000,
        spt.PointConfig(), cfg, device=dev)
    shapes = {"demo_1m_32x16_cap4": (demo(headline_cfg), headline_cfg, headline_cam),
              "demo_1m_16x16_cap4": (demo(demo_cfg), demo_cfg, None)}
    with open("BENCHMARK.json") as f:
        gs3d = cell_parts(json.load(f), "views8_2m_1080p")[0]
    shapes["gs3d_2m_cap8"] = (gaussian_scene(gs3d, 7, dev)[0], spt.RenderConfig(**gs3d["render"]),
                              None)
    view0 = camera_tensors(spt.Camera(azimuth=0.0, elevation=0.4, distance=3.0,
                                      aspect=1920 / 1080).arrays(), dev)
    out = {}
    for name, (splats, cfg, cam) in shapes.items():
        cam = view0 if cam is None else cam
        w = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], cfg)
        words = [w[k] for k in ("dk", "w_pos", "w_ro", "w_rgb")]
        del w
        n = words[0].shape[0]
        call = lambda: bin_packed_words(*words, cfg)  # noqa: E731
        plain = lambda: bin_packed_words_plain(*words, cfg)  # noqa: E731
        before = launches["bin_words"]
        got, want = call(), plain()
        torch.cuda.synchronize()
        check(launches["bin_words"] == before + 1, f"{name}: not one binner call")
        p = int(want["offsets"][-1])
        differ = {k: int((got[k][:p] != want[k][:p]).sum()) if k.startswith("pair_")
                  else int((got[k] != want[k]).sum()) for k in want}
        check(not any(differ.values()), f"{name}: kernel vs plain path differ {differ}")
        check(bool((got["pair_tile"][p:] == cfg.num_tiles).all()), f"{name}: tail not sentinel")
        del got, want
        call_ms = elapsed_ms(call, reps)
        plain_ms = elapsed_ms(plain, 3)
        call_ms_2 = elapsed_ms(call, reps)
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
        ops, tries = [], 0
        # late in this long process a profiling session has come back
        # empty: try the session again, up to three times
        while not ops and tries < 3:
            tries += 1
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.fill_(0)
                    call()
                torch.cuda.synchronize()
            # every device operation of the calls but the flush's fill
            ops = [e for e in prof.key_averages() if e.self_device_time_total > 0
                   and "fill" not in e.key.lower()]
        check(bool(ops), f"{name}: {tries} profiling sessions saw no binner kernel")
        del flush
        ms = sum(e.self_device_time_total for e in ops) / 1e3 / reps
        ops.sort(key=lambda e: -e.self_device_time_total)
        top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / reps:.4f}"
                        for e in ops[:6])
        n_bytes, design_bytes = bin_bound_bytes(n, cfg), bin_design_bytes(n, p, cfg)
        bnd = (n_bytes / HBM_BYTES_S * 1e3, "bytes")
        design_ms = design_bytes / HBM_BYTES_S * 1e3
        log(f"phase 18: bin_words {name}: {n} records, {p} live pairs of {n * cfg.tiles_per_splat_cap} "
            f"slots, {cfg.num_tiles} tiles of {cfg.tile_w}x{cfg.tile_h}: outputs bit-equal to the "
            f"plain path; kernels {ms:.4f} ms (device, profiler, L2 written over before each call; "
            f"session {tries}; by operation: {top}), call {call_ms:.4f} / {call_ms_2:.4f} ms (CUDA "
            f"events, {reps} calls), plain path {plain_ms:.3f} ms; bound {bnd[0]:.4f} ms "
            f"({bnd[1]}: {n_bytes / 1e6:.0f} MB the function moves), {100 * bnd[0] / ms:.1f}% of "
            f"it; the design's passes {design_ms:.4f} ms ({design_bytes / 1e6:.0f} MB, the sort's "
            f"included), {100 * design_ms / ms:.1f}% of it; {card}")
        out[name] = dict(ms=ms, call_ms=min(call_ms, call_ms_2), plain_ms=plain_ms, bound=bnd)
    return out["demo_1m_32x16_cap4"]


def model_work(program, steps: int):
    """(flops, SFU results) a point of the modeler needs with this program
    (`sdf/program.py`) and `steps` descent steps: the seed's face choice
    and mapping (11 flops), each step's evaluation and move (length, clamp,
    three divides, three multiplies and subtractions: 17 flops, 4 SFU), the
    probe's 7 evaluations each with its tap's offset and normal (11, 4), the
    6 taps' variations (6 each) and the mean, smoothstep, scale and colour
    (24)."""
    from splat_renderer_tpu_torch.sdf.program import CODES

    kind = {code: cls.kind for cls, code in CODES.items()}
    ev_f = sum(MODEL_OPS[kind[c]][0] for c, _ in program.code)
    ev_s = sum(MODEL_OPS[kind[c]][1] for c, _ in program.code)
    flops = 11 + steps * (ev_f + 17) + 7 * (ev_f + 11) + 6 * 6 + 24
    sfu = steps * (ev_s + 4) + 7 * (ev_s + 4)
    return flops, sfu


def phase19_modeler(dev, card: str, headline_cfg, n: int = 1_000_000, reps: int = 20) -> dict:
    """The modeler's kernels (M1, csrc/sdf_model.cu) on the demo scene at n
    points, animated, on the headline config (Gaussian splats) and on the
    surface preset of `surface_1m_1080p`: `model_points`' splat planes
    bit-equal to the plain path's (`seed_scene_points`, then the plain
    descent, probe and derivation), one launch each of "sdf_descent" and
    "sdf_probe" a call in the launch counter; each kernel's device time (the
    profiler's, the 50 MB L2 written over before each call, and warm), the
    call's time (CUDA events over `reps` calls back to back: the
    generator's draws and the host's issuing count) and the plain path's,
    beside the bound: the larger of the bytes once (uniforms 12 a point in,
    positions 12 out and back, 32 of the other planes out) over HBM
    bandwidth and the operations (`model_work`) over the FP32 and SFU
    rates.  Returns the headline config's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import splat_renderer_tpu_torch as spt
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.points import seed_scene_points
    from splat_renderer_tpu_torch.render import pipeline
    from splat_renderer_tpu_torch.render.pipeline import animate_demo, demo_scene, model_points
    from splat_renderer_tpu_torch.sdf.program import program_for

    scene, pcfg = demo_scene(), spt.PointConfig()
    animate_demo(scene, 0.7)
    params = scene.params(dev)
    flops, sfu = model_work(program_for(scene), pcfg.descent_steps)
    n_bytes = n * (12 + 12 + 12 + 32)
    bounds = {"bytes": n_bytes / HBM_BYTES_S * 1e3, "flops": n * flops / FP32_FLOP_S * 1e3,
              "SFU": n * sfu / SFU_OP_S * 1e3}
    by = max(bounds, key=bounds.get)
    bnd = (bounds[by], by)
    cfgs = {"gaussian": headline_cfg,
            "surface": spt.surface_render_config(headline_cfg.width, headline_cfg.height,
                                                 quad=True, tile_size=16,
                                                 tiles_per_splat_cap=16)}
    out = {}
    for name, cfg in cfgs.items():
        gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
        call = lambda: model_points(scene, params, gen(19), n, pcfg, cfg, device=dev)  # noqa: E731

        def plain():
            pts = seed_scene_points(gen(19), scene, params, n, pcfg)
            return pipeline._plain_splats(scene, params, pts, pcfg, cfg)

        before = launches["sdf_descent"], launches["sdf_probe"]
        got, want = call(), plain()
        torch.cuda.synchronize()
        check((launches["sdf_descent"], launches["sdf_probe"]) == (before[0] + 1, before[1] + 1),
              f"modeler {name}: not one launch of each kernel a call")
        differ = {k: int((got[k].view(torch.int32) != want[k].view(torch.int32)).sum())
                  for k in want}
        check(list(got) == list(want) and not any(differ.values()),
              f"modeler {name}: kernels vs plain path differ {differ}")
        del got, want
        call_ms = elapsed_ms(call, reps)
        plain_ms = elapsed_ms(plain, 3)
        call_ms_2 = elapsed_ms(call, reps)
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
        kernel_ms = {}
        for cold in (True, False):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    if cold:
                        flush.fill_(0)
                    call()
                torch.cuda.synchronize()
            for k in ("sdf_descent_kernel", "sdf_probe_kernel"):
                kernel_ms[cold, k] = sum(e.self_device_time_total for e in prof.key_averages()
                                         if k in e.key) / 1e3 / reps
                check(kernel_ms[cold, k] > 0, f"modeler {name}: the profiler saw no {k}")
        del flush
        d_ms, c_ms = kernel_ms[True, "sdf_descent_kernel"], kernel_ms[True, "sdf_probe_kernel"]
        ms = d_ms + c_ms
        log(f"phase 19: sdf_model {name} at {n} points, {pcfg.descent_steps} steps, "
            f"{len(program_for(scene).code)} nodes: 11 planes bit-equal to the plain path, one "
            f"launch each a call; descent {d_ms:.4f} + probe {c_ms:.4f} = {ms:.4f} ms (device, "
            f"profiler, L2 written over before each call; warm "
            f"{kernel_ms[False, 'sdf_descent_kernel']:.4f} + "
            f"{kernel_ms[False, 'sdf_probe_kernel']:.4f}), call {call_ms:.4f} / {call_ms_2:.4f} "
            f"ms (CUDA events, {reps} calls, the draws included), plain path {plain_ms:.3f} ms; "
            f"bound {bnd[0]:.4f} ms ({by}: {n_bytes / 1e6:.0f} MB {bounds['bytes']:.4f}, "
            f"{flops} flops a point {bounds['flops']:.4f}, {sfu} SFU results a point "
            f"{bounds['SFU']:.4f}), {100 * bnd[0] / ms:.1f}% of it; {card}")
        out[name] = dict(ms=ms, descent_ms=d_ms, probe_ms=c_ms, call_ms=min(call_ms, call_ms_2),
                         plain_ms=plain_ms, bound=bnd)
    return out["gaussian"]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    import numpy as np

    import splat_renderer_tpu_torch as spt
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.convert import splats_from_numpy
    from splat_renderer_tpu_torch.ops import build
    from splat_renderer_tpu_torch.ops.build import launches
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
    from splat_renderer_tpu_torch.points import point_count
    from splat_renderer_tpu_torch.render.binning import bin_packed_words
    from splat_renderer_tpu_torch.render.compositor import tiles_to_image
    from splat_renderer_tpu_torch.render.pipeline import (
        Engine, animate_demo, demo_scene, model_points, render_splats,
    )
    from splat_renderer_tpu_torch.render.packing import U32_MASK, unpack_words
    from splat_renderer_tpu_torch.render.projector import splat_screen_words

    t_start = time.perf_counter()
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
    sources = ("tile_blend", "tile_blend_diff", "probe_rate", "project_words", "bin_words",
               "sdf_model")
    build.build_all(sources)  # one nvcc per source, in parallel
    for name in sources:
        build.load_library(name)
    log(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; kernels built/loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{k} {build.build_seconds[k]:.2f} s" for k in sources) + ")")
    launch_lines(dev)

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

    # the kernels' launches on the main path: these 5 frames'
    launches.clear()
    frame_ms, shares = run_frames(eng, 5, 0.0, 0)
    main_launches = launches["tile_blend"]
    proj_launches = launches["project_words"]
    bin_launches = launches["bin_words"]
    model_launches = launches["sdf_descent"], launches["sdf_probe"]
    check(main_launches == k1_launches(), "Engine frames launched another kernel")
    check(main_launches >= 5, f"tile_blend launched {main_launches} times in 5 frames")
    check(proj_launches == 5, f"the projector kernel launched {proj_launches} times in 5 frames")
    check(bin_launches == 5, f"the binner's kernels ran {bin_launches} times in 5 frames")
    check(model_launches == (5, 5),
          f"the modeler's kernels (descent, probe) launched {model_launches} times in 5 frames")
    log(f"phase 3: Engine 1M @1920x1080 32x16 cap 4, 5 frames: tile_blend launches "
        f"{main_launches}, project_words launches {proj_launches}, bin_words calls "
        f"{bin_launches}, sdf_descent and sdf_probe launches {model_launches}; coverage {min(shares):.3f}..{max(shares):.3f} "
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
        f"the support; culling removes {packed_cull_share(binned, rcfg):.3f} of the (record, "
        f"warp) pairs), max-abs {d_main:.3g}; {card}")
    log(f"phase 3: that stream's tiles: {tile_load(binned)}; {heaviest_tile(binned, rcfg)}")

    # ---- phase 4: the surface preset's quads at cap 16, 2 frames ----
    from splat_renderer_tpu_torch.utils import profiling

    scene4 = demo_scene()
    eng4 = Engine(scene4, pcfg, spt.surface_render_config(1920, 1080, quad=True,
                                                          tiles_per_splat_cap=16),
                  n=1_000_000, device=dev)
    before = k1_launches()
    frame_ms4, shares4 = run_frames(eng4, 2, 0.5, 10)
    check(k1_launches() - before == 2, "surface frames did not launch the kernel")
    with profiling.recording() as rec4:
        run_frames(eng4, 1, 1.0, 12)
    pairs4, walked4 = rec4.counter("pairs"), rec4.counter("blend_walked")
    check(0 < walked4 <= pairs4, f"surface frame: K1 walked {walked4} of {pairs4} pairs")
    log(f"phase 4: surface quads Engine n={eng4.n} @1920x1080 16x16 cap 16, 2 frames: coverage "
        f"{min(shares4):.3f}..{max(shares4):.3f}; frame ms "
        + " ".join(f"{t:.2f}" for t in frame_ms4)
        + f"; a recorded frame: {int(pairs4)} pairs, K1 walked {int(walked4)}")

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

    with tempfile.TemporaryDirectory() as workdir:
        # ---- phase 10: static-scene serving ----
        p10 = phase10_static_scene(dev, card, workdir)

        # ---- phase 11: datagen ----
        p11 = phase11_datagen(dev, card, rcfg, cam)

        # ---- phase 12: the rate probe ----
        p12 = phase12_rate_probe(dev, card)

        # ---- phase 13: the front ends, on phase 10's .ply too ----
        t13 = time.perf_counter()
        p13 = phase13_front_ends(dev, card, workdir, p10["ply"])
        t14 = time.perf_counter()

    # ---- phase 14: mesh export ----
    phase14_mesh(dev, card)
    t15 = time.perf_counter()

    # ---- phase 15: the turbo profile at the headline shape ----
    phase15_turbo(dev, card, rcfg, cam)
    t16 = time.perf_counter()

    # ---- phase 16: multi-device rendering and training at one rank ----
    p16 = phase16_parallel(dev, card, rcfg, cam)

    # ---- phase 17: the projector kernel at the headline shape ----
    p17 = phase17_projector(dev, card, rcfg, cam)

    # ---- phase 18: the binner's kernels at three shapes, the headline's first ----
    p18 = phase18_binner(dev, card, rcfg, cam)

    # ---- phase 19: the modeler's kernels at the headline's 1M points ----
    p19 = phase19_modeler(dev, card, rcfg)
    log(f"phases 13-16: {t14 - t13:.1f} / {t15 - t14:.1f} / {t16 - t15:.1f} / "
        f"{time.perf_counter() - t16:.1f} s (host clock); the script so far "
        f"{time.perf_counter() - t_start:.1f} s; {card}")

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
        entry("tile_blend", blend_src, f"{jax_blend}:337, {jax_blend}:570",
              main_launches + p16["k1_launches"], max(max_err, p13["err"]["k1"], p16["k1_err"]),
              exact_ms, plain_exact_ms, k1_bound),
        # the same two TPU kernels' with_depth form (body at :96-113, :271-278)
        entry("tile_blend_depth", blend_src, f"{jax_blend}:337, {jax_blend}:570",
              p11["launches"], max(depth_err, p11["err"], p13["err"]["depth"]), p11["ms"],
              p11["plain_ms"],
              p11["bound"]),
        entry("tile_blend_xp", blend_src, f"{jax_blend}:422", p10["launches"],
              max(xp_err, p10["err"]), p10["ms"], p10["plain_ms"], p10["bound"]),
        entry("tile_blend_diff_fwd", diff_src, "splat_renderer_tpu/ops/tile_blend_diff.py:136",
              p7["launches"][0] + p16["k4_launches"],
              max(k4_err, k4_main_err, p13["err"]["k4"], p16["k4_err"]), k4_ms, k4_plain,
              k4_bound),
        entry("tile_blend_diff_bwd", diff_src, "splat_renderer_tpu/ops/tile_blend_diff.py:199",
              p7["launches"][1] + p16["k5_launches"],
              max(k5_err, k5_main_err, p13["err"]["k5"], p16["k5_err"]), k5_ms, k5_plain,
              k5_bound),
        # the float32 chain in the common keys, the bfloat16 chain beside it
        entry("probe_rate", "splat_renderer_tpu_torch/csrc/probe_rate.cu",
              "benchmarks/probe_bf16.py:24", p12["launches"], f32["err"], f32["ms"],
              f32["plain_ms"], f32["bound"], library=f32["lib_ms"],
              bf16_ms=bf16["ms"], bf16_plain_ms=bf16["plain_ms"],
              bf16_bound_ms=bf16["bound"][0], bf16_library_ms=bf16["lib_ms"],
              bf16_max_abs_err=bf16["err"]),
        # bit-equal to the plain path, so its error is 0
        entry("project_words", "splat_renderer_tpu_torch/csrc/project_words.cu", "none",
              proj_launches, 0.0, p17["ms"], p17["plain_ms"], p17["bound"],
              call_ms=p17["call_ms"]),
        # the same: bit-equal over the live pairs; launches: one call a frame
        entry("bin_words", "splat_renderer_tpu_torch/csrc/bin_words.cu", "none",
              bin_launches, 0.0, p18["ms"], p18["plain_ms"], p18["bound"],
              call_ms=p18["call_ms"]),
        # bit-equal to the plain path; launches: the SplatEngine frames served
        entry("sh_colors", "splat_renderer_tpu_torch/csrc/sh_colors.cu", "none",
              p10["sh"]["launches"], 0.0, p10["sh"]["ms"], p10["sh"]["plain_ms"],
              p10["sh"]["bound"], call_ms=p10["sh"]["call_ms"]),
        # bit-equal to the plain path; launches: phase 3's frames, one
        # descent and one probe each; ms: the two kernels' sum
        entry("sdf_model", "splat_renderer_tpu_torch/csrc/sdf_model.cu", "none",
              model_launches[0] + model_launches[1], 0.0, p19["ms"], p19["plain_ms"],
              p19["bound"], call_ms=p19["call_ms"], descent_ms=p19["descent_ms"],
              probe_ms=p19["probe_ms"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def k4_parity(mode: str, path: str) -> None:
    """Hold K4 and K5 to another tree's kernels bit for bit.

    `--save-k4 PATH`: run K4 (with and without its residual) and K5 on phase
    6's four streams and phase 7's 200k stream and save the streams, the
    cotangents and every output to PATH.  `--check-k4 PATH`: run this
    tree's kernels on the saved streams and require every output to be
    `torch.equal` to the saved one (the residual in every row a tile uses).
    To compare with an earlier tree, copy this file into that tree's root
    and save from there; then check from this one."""
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    from splat_renderer_tpu_torch import RenderConfig
    from splat_renderer_tpu_torch.ops.tile_blend_diff import diff_backward, diff_forward
    from splat_renderer_tpu_torch.render.binning import bin_planes_diff

    dev = torch.device("cuda")

    def run(binned, cfg, cots):
        *outs, t_start = diff_forward(binned, cfg, residuals=True)
        bare = diff_forward(binned, cfg)
        grads = diff_backward(binned, cfg, cots, t_start)
        torch.cuda.synchronize()
        return dict(outs=list(outs), bare=list(bare), t_start=t_start, grads=grads)

    cpu = lambda v: [x.cpu() for x in v] if isinstance(v, list) else v.cpu()  # noqa: E731
    if mode == "save":
        streams = [(cfg, bin_planes_diff({k: p.detach() for k, p in zip(DIFF_PLANES, planes)},
                                         cfg))
                   for _, _, cfg, planes in diff_streams(dev)]
        cfg, spl, cam = training_scene(dev)
        with torch.no_grad():
            streams.append((cfg, bin_planes_diff(training_planes(spl, cam, cfg), cfg)))
        saved = []
        for i, (cfg, binned) in enumerate(streams):
            g = torch.Generator(device=dev).manual_seed(100 + i)
            t, tp = cfg.num_tiles, cfg.tile_pixels
            cots = [torch.rand(s, generator=g, device=dev) - 0.5
                    for s in ((t, tp, 3), (t, tp), (t, tp))]
            out = run(binned, cfg, cots)
            saved.append(dict(cfg=dataclasses.asdict(cfg), cots=cpu(cots),
                              binned={k: v.detach().cpu() for k, v in binned.items()},
                              **{k: cpu(v) for k, v in out.items()}))
        torch.save(saved, path)
        log(f"k4 parity: saved {len(saved)} streams' K4/K5 outputs to {path}")
        return

    from splat_renderer_tpu_torch.ops.tile_blend_diff import bwd_chunk, residual_rows_used

    equal = []
    for i, rec in enumerate(torch.load(path)):
        cfg = RenderConfig(**rec["cfg"])
        binned = {k: v.to(dev) for k, v in rec["binned"].items()}
        out = run(binned, cfg, [c.to(dev) for c in rec["cots"]])
        used = residual_rows_used(binned, bwd_chunk(cfg)).cpu()
        same = {
            "outputs": all(torch.equal(a.cpu(), b) for a, b in zip(out["outs"], rec["outs"])),
            "without_residual": all(torch.equal(a.cpu(), b)
                                    for a, b in zip(out["bare"], rec["bare"])),
            "residual": torch.equal(out["t_start"].cpu()[used], rec["t_start"][used]),
            "k5_gradients": torch.equal(out["grads"].cpu(), rec["grads"]),
        }
        equal.append(all(same.values()))
        log(f"k4 parity: stream {i} ({'oriented' if cfg.oriented else 'isotropic'} "
            f"{cfg.tile_w}x{cfg.tile_h} @{cfg.width}x{cfg.height}, "
            f"{int(binned['offsets'][-1])} pairs, {used.numel()} residual rows): torch.equal "
            + ", ".join(f"{k} {v}" for k, v in same.items()))
    check(all(equal), "K4/K5 outputs differ from the saved ones")
    print(json.dumps({"k4_bit_equal": all(equal), "streams": len(equal)}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in ("--save-k4", "--check-k4"):
        k4_parity(sys.argv[1][2:6], sys.argv[2])
    else:
        main()
