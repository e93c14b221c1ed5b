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

It prints one JSON line describing the kernels, then, as its last line,
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


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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
    build.load_library("tile_blend")
    log(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; tile_blend built/loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds['tile_blend']:.2f} s)")

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

    def time_ms(fn, reps):
        fn()
        sync()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / reps

    kernel_ms = time_ms(lambda: blend_tiles(binned, rcfg), 20)
    plain_ms = time_ms(lambda: blend_tiles_plain(binned, rcfg, pair_chunk=8192), 3)
    kernel_ms_2 = time_ms(lambda: blend_tiles(binned, rcfg), 20)
    log(f"phase 3: tile_blend at the 1M @1080p stream: kernel {kernel_ms:.3f} / "
        f"{kernel_ms_2:.3f} ms, plain twin (pair_chunk 8192) {plain_ms:.3f} ms, "
        f"eps=0 max-abs {d_main:.3g}; {card}")

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

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "splat_renderer_tpu"
                    or m.startswith("splat_renderer_tpu."))
    check(not leaked, f"JAX modules imported: {leaked}")

    print(json.dumps({"kernels": [{
        "name": "tile_blend",
        "route": "cuda",
        "source": "splat_renderer_tpu_torch/csrc/tile_blend.cu",
        "replaces": "splat_renderer_tpu/ops/tile_blend.py:337",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
