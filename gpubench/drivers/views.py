"""The multi-view driver: 8-view batches back to back, each copied to the host.

One item is one step of the datagen front end: the splat set rendered from
`views` cameras on an orbit ring (`render_views(flat=True, as_uint8=True)`,
SH lit per view), the (V, H, W*3) uint8 batch copied to the host with
`.cpu()`, and a synchronize.  Item i's ring has elevation
`elevation + elevation_amp * sin(i / elevation_period)`, as datagen's step i
does.  PNG encoding is not part of an item: it is zlib on host threads.
The loop is closed: item i + 1 starts when item i ends.

The configuration (`engine: "gaussians"`) holds full-covariance 3D Gaussians
made from the seed (`gaussian_scene`): the demo scene's splats from the
reference's modeler give positions, normals and radii r; each Gaussian's
scales are s1 = scale_of_radius * r * exp(N(0, scale_log_std)),
s2 = s1 * U(aspect_lo, 1), s3 = thin * s2, its rotation takes +z to the
normal after a uniform twist about z, its opacity is
U(opacity_lo, opacity_hi).

The check: in `check_items` items drawn from the seed among the first
`check_range`, `check_views` of the views drawn from the seed are captured
where the program makes them (the lit colours at `apply_sh`, the words at
`splat_screen_words`, the runs at `bin_packed_words`, the float image at
`tiles_to_image`, and the view's bytes of the batch on the host) and held
to `reference.gaussians` (`gaps`).
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time
from typing import Dict, List

import torch

from .. import inputs, window
from ..reference import frame as ref
from ..reference import gaussians as ref_gs
from ..reference.camera import Camera as RefCamera
from ..reference.config import RenderConfig as RefRenderConfig
from ..spans import Spans
from ..tracing import Stretch, TracedRun, read_metrics, seed_of, wrap_targets

PIPELINE = "splat_renderer_tpu_torch.render.pipeline"
# what the check captures of a view: name -> program entry
CAPTURE = {
    "apply_sh": "splat_renderer_tpu_torch.render.multiview:apply_sh",
    "splat_screen_words": f"{PIPELINE}:splat_screen_words",
    "bin_packed_words": f"{PIPELINE}:bin_packed_words",
    "tiles_to_image": f"{PIPELINE}:tiles_to_image",
}
WORDS = ("dk", "w_pos", "w_ro", "w_rgb")
COV3D = ("sx", "sy", "sz", "qw", "qx", "qy", "qz")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _quat_mul(a, b):
    """Hamilton product of (w, x, y, z) plane tuples: the rotation b, then a."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def gaussian_scene(config: dict, seed: int, device):
    """The configuration's Gaussians (the eleven planes and the seven of
    a covariance) and SH rest coefficients, made on the device from the
    seed, by the benchmark alone."""
    base, sh = inputs.static_scene(config, seed, device)
    g = config["gaussians"]
    n = config["n"]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 0x6A055))
    u = lambda: torch.rand(n, generator=gen, device=device)  # noqa: E731
    s1 = g["scale_of_radius"] * base["radius"] * torch.exp(
        g["scale_log_std"] * torch.randn(n, generator=gen, device=device))
    s2 = s1 * (g["aspect_lo"] + (1.0 - g["aspect_lo"]) * u())
    s3 = g["thin"] * s2
    twist = 2.0 * math.pi * u()
    opacity = g["opacity_lo"] + (g["opacity_hi"] - g["opacity_lo"]) * u()
    nx, ny, nz = base["nx"], base["ny"], base["nz"]
    # +z to n: axis z x n, half-angle form; n near -z: a half turn about x
    w = 1.0 + nz
    flip = w < 1e-6
    to_n = (torch.where(flip, 0.0, w), torch.where(flip, 1.0, -ny), torch.where(flip, 0.0, nx),
            torch.zeros_like(nz))
    norm = torch.sqrt(sum(c * c for c in to_n))
    to_n = tuple(c / norm for c in to_n)
    z = torch.zeros_like(twist)
    q = _quat_mul(to_n, (torch.cos(0.5 * twist), z, z, torch.sin(0.5 * twist)))
    splats = dict(base, radius=2.0 * s1, opacity=opacity)
    splats.update(zip(COV3D, (s1, s2, s3) + q))
    return splats, sh


def elevation(traffic: dict, i: int) -> float:
    c = traffic["camera"]
    return c["elevation"] + c["elevation_amp"] * math.sin(i / c["elevation_period"])


def ref_camera(config: dict, traffic: dict, i: int, v: int, device) -> Dict[str, torch.Tensor]:
    """View v of item i as the reference sees it: the frame uniform and the
    view and projection matrices."""
    c, r = traffic["camera"], config["render"]
    cam = RefCamera(azimuth=2 * math.pi * v / traffic["views"], elevation=elevation(traffic, i),
                    distance=c["distance"], aspect=r["width"] / r["height"])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    out = {k: f32(a) for k, a in cam.arrays().items()}
    out["view"], out["proj"] = f32(cam.view_matrix()), f32(cam.projection_matrix())
    return out


class Setup:
    """The program's inputs; `item(i)` renders item i's batch, copies it
    to the host and waits."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import splat_renderer_tpu_torch as spt
        from splat_renderer_tpu_torch.camera import camera_tensors, orbit_ring
        from splat_renderer_tpu_torch.render.multiview import render_views

        if config["engine"] != "gaussians":
            raise ValueError(f"the views driver takes engine 'gaussians', not {config['engine']!r}")
        if device.type == "cuda":
            from splat_renderer_tpu_torch.ops import build

            build.build_all(["tile_blend", "project_words"])
            build.load_library("tile_blend")
            build.load_library("project_words")
        self.config, self.traffic, self.device = config, traffic, device
        self.rcfg = spt.RenderConfig(**config["render"])
        self.camera_tensors, self.orbit_ring, self.render_views = (camera_tensors, orbit_ring,
                                                                   render_views)
        self.splats, self.sh = gaussian_scene(config, seed, device)

    def item(self, i: int) -> torch.Tensor:
        c, r = self.traffic["camera"], self.config["render"]
        cams = self.camera_tensors(self.orbit_ring(
            self.traffic["views"], distance=c["distance"], elevation=elevation(self.traffic, i),
            aspect=r["width"] / r["height"]), self.device)
        batch = self.render_views(self.splats, cams, self.rcfg, flat=True, as_uint8=True,
                                  sh=self.sh, device=self.device)
        host = batch.cpu()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return host


class Capture:
    """Wrappers on the program's entries that keep the calls of the
    chosen views of an item (their arguments and results), and nothing of
    the others: the k-th call of an entry within the item is view k."""

    def __init__(self):
        self.views: List[int] = []
        self.names = tuple(CAPTURE)
        self.calls: Dict[str, int] = {}
        self.kept: Dict[str, Dict[int, tuple]] = {}
        self._saved = []

    def install(self) -> None:
        import importlib

        for name, target in CAPTURE.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrapper(fn, name))

    def _wrapper(self, fn, name):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.views and name in self.names:
                k = self.calls.get(name, 0)
                self.calls[name] = k + 1
                if k in self.views:
                    self.kept.setdefault(name, {})[k] = (args, kwargs, out)
            return out

        return wrapper

    def start(self, views: List[int], names=tuple(CAPTURE)) -> None:
        self.views, self.names, self.calls, self.kept = list(views), tuple(names), {}, {}

    def take(self, name: str) -> List[tuple]:
        """The kept calls of `name`, in view order; capturing stops."""
        kept = self.kept.get(name, {})
        self.views, self.kept = [], {}
        return [kept[v] for v in sorted(kept)]

    def stop(self, host: torch.Tensor) -> Dict[int, dict]:
        """What the program made of each chosen view of the item."""
        got = {}
        for v in self.views:
            try:
                got[v] = {"splats": self.kept["apply_sh"][v][2],
                          "words": self.kept["splat_screen_words"][v][2],
                          "binned": self.kept["bin_packed_words"][v][2],
                          "image": self.kept["tiles_to_image"][v][2],
                          "u8": host[v]}
            except KeyError as e:
                raise RuntimeError(f"view {v}'s {e} entry was not captured") from None
        self.views, self.kept = [], {}
        return got

    def restore(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


def reference_view(config: dict, traffic: dict, splats, sh, i: int, v: int, device,
                   rnd=ref.exact) -> dict:
    """The reference's lit colours, words, runs, image and bytes of view v
    of item i."""
    rcfg = RefRenderConfig(**config["render"])
    cam = ref_camera(config, traffic, i, v, device)
    lit = ref.lit_splats({k: rnd(t) for k, t in splats.items()}, sh, cam["cam_pos"], rnd)
    words, binned, image, _ = ref_gs.render(lit, cam, rcfg, rnd)
    u8 = ref_gs.quantize_u8(image).reshape(rcfg.height, rcfg.width * 3)
    return {"splats": lit, "words": words, "binned": binned, "image": image, "u8": u8}


def pairs_out_of_place(got: dict, want: dict) -> float:
    """The share of the two sides' pairs that are out of place: each
    (tile, record) pair that one side alone binned, and each pair both
    binned at a position where the two tiles' runs order them differently
    (on both sides), over both sides' pairs.  A record with one tile more
    or less costs that one pair, not the rest of the tile's run."""
    n_g, n_w = int(got["offsets"][-1]), int(want["offsets"][-1])
    if not n_g + n_w:
        return 0.0

    def keys(b, n):
        return (b["pair_tile"][:n].to(torch.int64) << 32) | b["pair_rank"][:n].to(torch.int64)

    k_g, k_w = keys(got, n_g), keys(want, n_w)
    in_g, in_w = torch.isin(k_g, k_w), torch.isin(k_w, k_g)
    only = int((~in_g).sum()) + int((~in_w).sum())
    # the pairs both binned, each side's in its own order: the same pairs,
    # grouped by tile in tile order, so a position differs only where a
    # tile's runs order them differently
    moved = int((k_g[in_g] != k_w[in_w]).sum())
    return (only + 2 * moved) / (n_g + n_w)


def gaps(got: dict, want: dict) -> Dict[str, float]:
    """The numbers the check compares for one view: `got` is what the
    program (or a control or a fault) made, `want` the reference's."""
    out = {"colour_gap": max(float((got["splats"][k] - want["splats"][k]).abs().max())
                             for k in ("cr", "cg", "cb"))}
    diff = torch.zeros_like(want["words"]["dk"], dtype=torch.bool)
    for k in WORDS:
        diff |= got["words"][k] != want["words"][k]
    # a record culled on both sides (the +inf depth key) carries nothing
    inf_key = int(ref_gs.depth_bits(torch.tensor([math.inf]))[0])
    both_culled = (got["words"]["dk"] == inf_key) & (want["words"]["dk"] == inf_key)
    out["words_differ"] = float((diff & ~both_culled).float().mean())
    out["pairs_out_of_place"] = pairs_out_of_place(got["binned"], want["binned"])
    out["image_gap"] = float((got["image"] - want["image"]).abs().max())
    u8 = got["u8"].to(want["u8"].device)
    out["u8_differ"] = float((u8 != want["u8"]).float().mean())
    return out


def checked(traffic: dict, seed: int):
    """{item: [views]} that the check compares, drawn from the seed."""
    rng = random.Random(seed_of(seed, 0xC4EC))
    items = sorted(rng.sample(range(traffic["check_range"]), traffic["check_items"]))
    return {i: sorted(rng.sample(range(traffic["views"]), traffic["check_views"]))
            for i in items}


def require_cov3d() -> None:
    """Exit at once where the program has no full-covariance model: a
    program without it would render the records of another ellipse model
    (an unknown `ellipse` is the foreshortened disc there)."""
    try:
        from splat_renderer_tpu_torch.points import COV3D_PLANES  # noqa: F401
    except ImportError:
        raise SystemExit("gpubench: the program has no full-covariance 3D Gaussians "
                         "(splat_renderer_tpu_torch.points.COV3D_PLANES): it cannot run "
                         "this configuration") from None


def run(config, traffic, seed, seconds, trace, device, readers, t_start) -> dict:
    require_cov3d()
    st = Setup(config, traffic, seed, device)
    for j in range(traffic["warmup_items"]):
        st.item(-1 - j)
    check_at = checked(traffic, seed)
    last_checked = max(check_at)
    spans = Spans(device, timed=trace)
    if trace:
        for name, target in wrap_targets(readers).items():
            if not spans.wrap(target, name):
                log(f"gpubench: entry {target} is gone; its metric reads null")
    capture = Capture()
    capture.install()
    got: Dict[tuple, dict] = {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"gpubench: set-up {setup_s:.3f} s; checking items and views {check_at}")

    # the window: items until --seconds have passed and the checked items
    # are done
    times = []
    i = 0
    t0 = time.perf_counter()
    while True:
        if i in check_at:
            capture.start(check_at[i])
        ta = time.perf_counter()
        host = st.item(i)
        tb = time.perf_counter()
        times.append(tb - ta)
        if i in check_at:
            for v, g in capture.stop(host).items():
                got[(i, v)] = g
        i += 1
        if tb - t0 >= seconds and i > last_checked:
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
    log(f"gpubench: {i} batches of {traffic['views']} views in {window_s:.3f} s; batch ms mean "
        f"{window.per_item_ms(window_s, i):.3f}, p95 {window.percentile(times, 95.0) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}")

    if trace:
        spans.timed = False
        n_traced = traffic["trace_items"]
        roof_items = traffic.get("roofline_items", 0)
        projector_calls: List[dict] = []
        roof_item = i
        dev = Stretch(device, host=False)
        with dev:
            for k in range(n_traced):
                if k < roof_items:
                    capture.start(range(traffic["views"]), ("splat_screen_words",))
                with dev.item():
                    st.item(i)
                if k < roof_items:
                    projector_calls += [args[0] for args, _, _ in
                                        capture.take("splat_screen_words")]
                i += 1
        host_line = Stretch(device, host=True)
        spans.named = True
        with host_line:
            for _ in range(n_traced):
                with host_line.item():
                    st.item(i)
                i += 1
        spans.named = False
        out["attempted"] = i
        line = dev.summary()
        out["busy_s"], out["window_s"] = line.busy_s(), line.window_s()
        log(f"gpubench: device stretch of {n_traced} batches: {line.window_s():.4f} s, "
            f"device busy {line.busy_s():.4f} s, {len(line.device)} device operations")
        run_ = TracedRun(spans, line, host_line.summary(), None, item_s=window_s / len(times))
        run_.projector_calls = projector_calls  # the roofline items' projector inputs

        def blend_counts(n_views: int) -> List[dict]:
            """The reference's fold counts (`reference.frame.fold_blend`) of
            the first n views of the first traced batch, from the splats
            the program lit for them: the work their blends must do."""
            return [ref_gs.render(dict(s), ref_camera(config, traffic, roof_item, v, device),
                                  run_.render_config)[3]
                    for v, s in enumerate(projector_calls[:n_views])]

        run_.blend_counts = blend_counts
        run_.render_config = RefRenderConfig(**config["render"])
        out["breakdown"] = run_.breakdown()
        out["metrics"] = read_metrics(readers, run_)
        projector_calls.clear()
        spans.restore()
    capture.restore()
    del st

    # the check: every sampled view against the reference, which remakes
    # the Gaussians from the seed
    splats_in, sh_in = gaussian_scene(config, seed, device)
    limits = config["limits"]["views"]
    worst: Dict[str, float] = {}
    t_check = time.perf_counter()
    for (fi, v), g in sorted(got.items()):
        read = gaps(g, reference_view(config, traffic, splats_in, sh_in, fi, v, device))
        for k, val in read.items():
            worst[k] = max(worst.get(k, 0.0), val)
        bad = [k for k, val in read.items() if val > limits[k]]
        if bad:
            out["failed"] += 1
            log(f"gpubench: item {fi} view {v} fails {bad}: {read}")
    log(f"gpubench: the check took {time.perf_counter() - t_check:.3f} s")
    missing = [(fi, v) for fi, vs in check_at.items() for v in vs if (fi, v) not in got]
    if missing:
        out["failed"] += len(missing)
        log(f"gpubench: views {missing} were never rendered")
    out["checks"] = {k: {"value": worst.get(k, math.inf), "limit": limits[k]} for k in limits}
    return out
