"""The render-loop driver: frames back to back, each handed to display.

The traffic file (`kind: "frames"`) sets the camera schedule (an orbit that
advances `azimuth_step` radians a frame), the scene's animation clock
(`animate_fps`, or none for a static scene), how many frames warm up, how
many frames of the window the check compares and from how many first
frames they are drawn, and the traced stretch.  The configuration file sets
the engine (`sdf`: the live modeler, `Engine`, over the configuration's
scene file; `static`: a splat set made from the seed by the reference's
modeler, with SH rest coefficients, behind `SplatEngine`), the sizes and
the limits of the check.

Frame i: the host sets the scene's animation to i / animate_fps, seeds the
generator from (seed, i), sets the camera, calls the engine's `frame` and
synchronises.  The loop is closed: frame i + 1 starts when frame i ends.
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time
from typing import Dict

import torch

from .. import inputs, window
from ..reference import frame as ref
from ..reference.camera import Camera as RefCamera
from ..reference.config import PointConfig as RefPointConfig
from ..reference.config import RenderConfig as RefRenderConfig
from ..roofline import blend_bytes, least_seconds, share_percent
from ..spans import Spans
from ..tracing import Stretch, TracedRun, read_metrics, seed_of, wrap_targets

PIPELINE = "splat_renderer_tpu_torch.render.pipeline"
# what the check captures of a frame: span name -> program entry
CAPTURE = {
    "model_points": f"{PIPELINE}:model_points",
    "apply_sh": f"{PIPELINE}:apply_sh",
    "splat_screen_words": f"{PIPELINE}:splat_screen_words",
    "bin_packed_words": f"{PIPELINE}:bin_packed_words",
}
WORDS = ("dk", "w_pos", "w_ro", "w_rgb")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def camera_args(traffic: dict, config: dict, i: int) -> dict:
    c = traffic["camera"]
    r = config["render"]
    return dict(azimuth=c["azimuth"] + c["azimuth_step"] * i, elevation=c["elevation"],
                distance=c["distance"], aspect=r["width"] / r["height"])


class Setup:
    """The engine and its inputs; `frame(i)` renders frame i and waits."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import splat_renderer_tpu_torch as spt
        from splat_renderer_tpu_torch.camera import camera_tensors
        from splat_renderer_tpu_torch.render.pipeline import Engine, SplatEngine

        if device.type == "cuda":
            from splat_renderer_tpu_torch.ops import build

            build.build_all(["tile_blend"])
            build.load_library("tile_blend")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.rcfg = spt.RenderConfig(**config["render"])
        self.camera_tensors = camera_tensors
        self.Camera = spt.Camera
        self.fps = traffic.get("animate_fps")
        self.gen = torch.Generator(device=device)
        if config["engine"] == "sdf":
            self.scene = inputs.build(config["scene"], inputs.program_sdf())
            self.engine = Engine(self.scene, spt.PointConfig(**config["points"]), self.rcfg,
                                 n=config["n"], blend_kernel=config["blend_kernel"],
                                 device=device)
            self.splats = self.sh = None
        elif config["engine"] == "static":
            self.splats, self.sh = inputs.static_scene(config, seed, device)
            self.engine = SplatEngine(self.splats, self.rcfg, sh=self.sh,
                                      blend_kernel=config["blend_kernel"], device=device)
            self.scene = None
        else:
            raise ValueError(f"unknown engine {config['engine']!r}")

    def frame(self, i: int):
        if self.scene is not None and self.fps:
            inputs.animate(self.scene, self.config["scene"], i / self.fps)
        self.gen.manual_seed(seed_of(self.seed, i))
        cam = self.camera_tensors(self.Camera(**camera_args(self.traffic, self.config, i))
                                  .arrays(), self.device)
        img = self.engine.frame(cam, self.gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return img


def reference_frame(config: dict, traffic: dict, seed: int, i: int, device, splats=None,
                    sh=None, rnd=ref.exact):
    """The reference's (splats, words, binned, image, counts) of frame i."""
    rcfg = RefRenderConfig(**config["render"])
    cam_np = RefCamera(**camera_args(traffic, config, i)).arrays()
    cam = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in cam_np.items()}
    if config["engine"] == "sdf":
        scene = inputs.scene_at(config, traffic, i, inputs.reference_sdf())
        gen = torch.Generator(device=device).manual_seed(seed_of(seed, i))
        splats = ref.model_splats(scene, gen, config["n"], RefPointConfig(**config["points"]),
                                  rcfg, rnd)
    elif sh is not None:
        splats = ref.lit_splats({k: rnd(v) for k, v in splats.items()}, sh, cam["cam_pos"], rnd)
    words, binned, image, counts = ref.render(splats, cam, rcfg, rnd)
    return splats, words, binned, image, counts


def gaps(config: dict, got: dict, want: dict) -> Dict[str, float]:
    """The numbers the check compares for one frame: `got` is what the
    program (or the control) made, `want` the reference's."""
    out = {}
    if config["engine"] == "sdf":
        rel = 0.0
        for k, w in want["splats"].items():
            scale = max(float(w.abs().max()), 1e-30)
            rel = max(rel, float((got["splats"][k] - w).abs().max()) / scale)
        out["splats_gap"] = rel
    else:
        out["colour_gap"] = max(float((got["splats"][k] - want["splats"][k]).abs().max())
                                for k in ("cr", "cg", "cb"))
    diff = torch.zeros_like(want["words"]["dk"], dtype=torch.bool)
    for k in WORDS:
        diff |= got["words"][k] != want["words"][k]
    out["words_differ"] = float(diff.float().mean())
    n_got, n_want = int(got["binned"]["offsets"][-1]), int(want["binned"]["offsets"][-1])
    n = max(n_got, n_want)
    same = torch.zeros(n, dtype=torch.bool, device=diff.device)
    m = min(n_got, n_want)
    same[:m] = ((got["binned"]["pair_tile"][:m] == want["binned"]["pair_tile"][:m])
                & (got["binned"]["pair_rank"][:m] == want["binned"]["pair_rank"][:m]))
    out["order_differ"] = int((~same).sum()) / n if n else 0.0
    out["image_gap"] = float((got["image"] - want["image"]).abs().max())
    return out


def program_frame(spans: Spans, img) -> dict:
    """What the program made in the frame whose entries were captured."""
    splat_calls = spans.take("apply_sh") or spans.take("model_points")
    words = spans.take("splat_screen_words")
    binned = spans.take("bin_packed_words")
    if not (words and binned):
        raise RuntimeError("the frame's projector or binner entry was not captured")
    if splat_calls:
        splats = splat_calls[-1][2]
    else:  # a static set without SH renders its splats as they are
        splats = words[-1][0][0]
    return {"splats": splats, "words": words[-1][2], "binned": binned[-1][2], "image": img}


def run(config, traffic, seed, seconds, trace, device, readers, t_start) -> dict:
    st = Setup(config, traffic, seed, device)
    for j in range(traffic["warmup_frames"]):
        st.frame(-1 - j)
    rng = random.Random(seed_of(seed, 0xC4EC))
    check_at = sorted(rng.sample(range(traffic["check_range"]), traffic["check_frames"]))
    spans = Spans(device, timed=trace)
    if trace:
        for name, target in wrap_targets(readers).items():
            if not spans.wrap(target, name):
                log(f"gpubench: entry {target} is gone; its metric reads null")
    got = {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # set-up's objects leave the collector's generations: a collection in
    # the window walks only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"gpubench: set-up {setup_s:.3f} s; checking frames {check_at}")

    # the window: frames until --seconds have passed and the checked frames
    # are done
    times = []
    i = 0
    t0 = time.perf_counter()
    while True:
        capture = i in check_at
        if capture:
            for name, target in CAPTURE.items():
                spans.wrap(target, name)
            spans.capturing = True
        ta = time.perf_counter()
        img = st.frame(i)
        tb = time.perf_counter()
        times.append(tb - ta)
        if capture:
            spans.capturing = False
            got[i] = program_frame(spans, img)
            if not trace:
                spans.restore()
        i += 1
        if tb - t0 >= seconds and i > check_at[-1]:
            break
    window_s = tb - t0
    gc.unfreeze()
    out = {"attempted": i, "failed": 0, "metrics": {}, "checks": {}}
    out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                if device.type == "cuda" else 0)
    if not trace:
        out["metrics"] = {"setup_s": setup_s,
                          "frame_ms": window.per_item_ms(window_s, i),
                          "frame_p95_ms": window.percentile(times, 95.0) * 1e3}
    starts = [0.0]
    for t in times[:-1]:
        starts.append(starts[-1] + t)
    blocks = [[] for _ in range(max(1, math.ceil(window_s / 5.0)))]
    for s0, t in zip(starts, times):
        blocks[min(int(s0 / 5.0), len(blocks) - 1)].append(t * 1e3)
    log("gpubench: frame ms mean by 5-s stretch of the window "
        f"{[round(sum(b) / len(b), 3) for b in blocks if b]}")
    log(f"gpubench: {i} frames in {window_s:.3f} s; frame ms mean "
        f"{window.per_item_ms(window_s, i):.3f}, p95 {window.percentile(times, 95.0) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}")

    if trace:
        # the profiler's stretches come after the window, so their start and
        # stop fall outside the frames the spans time
        spans.timed = False
        for name, target in CAPTURE.items():
            spans.wrap(target, name)
        n_traced = traffic["trace_frames"]
        roof_items = traffic.get("roofline_frames", 0)
        roof_inputs = []
        dev = Stretch(device, host=False)
        with dev:
            for k in range(n_traced):
                spans.capturing = k < roof_items
                with dev.item():
                    st.frame(i)
                spans.capturing = False
                if k < roof_items:
                    roof_inputs.append(spans.captured["splat_screen_words"][-1][0])
                for name in CAPTURE:
                    spans.take(name)
                i += 1
        host = Stretch(device, host=True)
        spans.named = True
        with host:
            for _ in range(n_traced):
                with host.item():
                    st.frame(i)
                i += 1
        spans.named = False
        out["attempted"] = i
        line = dev.summary()
        out["busy_s"], out["window_s"] = line.busy_s(), line.window_s()
        log(f"gpubench: device stretch of {n_traced} frames: {line.window_s():.4f} s, "
            f"device busy {line.busy_s():.4f} s, {len(line.device)} device operations")

        def roofline(ops, kernel, n_items):
            least = 0.0
            for args in roof_inputs[:n_items]:
                splats, view_proj, cam_pos = args[0], args[1], args[2]
                rcfg = RefRenderConfig(**config["render"])
                cam = {"view_proj": view_proj, "cam_pos": cam_pos}
                _, binned = ref.words_and_bins(dict(splats), cam, rcfg)
                _, _, c = ref.fold_blend(binned, rcfg)
                least += least_seconds(ops, blend_bytes(rcfg.num_tiles, rcfg.tile_pixels,
                                                        c["pairs"], c["records"]),
                                       c["evals"], c["inside"])
            return share_percent(least, line.kernel_s(kernel, n_items))

        run_ = TracedRun(spans, line, host.summary(), roofline, item_s=window_s / len(times))
        out["breakdown"] = run_.breakdown()
        out["metrics"] = read_metrics(readers, run_)
        roof_inputs.clear()
        spans.restore()
    del st

    # the check: every sampled frame against the reference, which remakes
    # a static configuration's inputs from the seed
    splats_in, sh_in = (inputs.static_scene(config, seed, device) if config["engine"] == "static"
                        else (None, None))
    limits = config["limits"]["frames"]
    worst: Dict[str, float] = {}
    t_check = time.perf_counter()
    for fi, g in sorted(got.items()):
        splats, words, binned, image, _ = reference_frame(config, traffic, seed, fi, device,
                                                          splats_in, sh_in)
        read = gaps(config, g, {"splats": splats, "words": words, "binned": binned,
                                "image": image})
        for k, v in read.items():
            worst[k] = max(worst.get(k, 0.0), v)
        bad = [k for k, v in read.items() if v > limits[k]]
        if bad:
            out["failed"] += 1
            log(f"gpubench: frame {fi} fails {bad}: {read}")
    log(f"gpubench: the check took {time.perf_counter() - t_check:.3f} s")
    missing = [fi for fi in check_at if fi not in got]
    if missing:
        out["failed"] += len(missing)
        log(f"gpubench: frames {missing} were never rendered")
    out["checks"] = {k: {"value": worst.get(k, math.inf), "limit": limits[k]} for k in limits}
    return out
