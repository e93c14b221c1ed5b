"""The optimiser-loop driver: one `fit_splats` call of S steps is the window.

The traffic file (`kind: "fit"`) sets the view (the orbit camera), the
loss, the fitted fields, the learning rate, the seeded perturbation of the
start, the warm-up steps, how many first steps the check follows and the
traced stretch.  The configuration file is a static one (`engine:
"static"`): its splats and SH rest coefficients are made from the seed by
the reference's modeler.  The target is the reference's render of them;
the start is a perturbation of them drawn from the seed.

Set-up warms the call up with `warmup_steps` steps from the same start.
The window's call takes S = --seconds x `steps_per_second` steps: a fixed
amount of work for a given run length (the pair count drifts as the fit
moves the splats, so a step count read off the warm-up's time would change
the load from run to run); `steps_per_second` is the rate measured when
the cell was added, so the call lasts about --seconds.  The window's
first `check_steps` steps are captured at the program's optimiser entry
(`fit.adam_update`: the gradient it is handed, the parameters it returns)
and held to the reference's steps from the same start.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from typing import Dict

import torch

from ..inputs import static_scene
from ..reference import fit as ref_fit
from ..reference.camera import Camera as RefCamera
from ..reference.config import RenderConfig as RefRenderConfig
from ..roofline import diff_bwd_bytes, diff_fwd_bytes, least_seconds, share_percent
from ..spans import Spans
from ..tracing import Stretch, TracedRun, read_metrics, seed_of, wrap_targets

def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def camera_arrays(traffic: dict, config: dict) -> dict:
    c, r = traffic["camera"], config["render"]
    return RefCamera(azimuth=c["azimuth"], elevation=c["elevation"], distance=c["distance"],
                     aspect=r["width"] / r["height"]).arrays()


def start_of(splats: Dict[str, torch.Tensor], traffic: dict, seed: int, device):
    """The seeded perturbation of the configuration's splats the fit starts
    from: positions, radii, colours and opacities jittered."""
    j = traffic["jitter"]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 0x57A27))
    n = splats["px"].shape[0]
    z = torch.randn((8, n), generator=gen, device=device)
    out = dict(splats)
    for i, k in enumerate(("px", "py", "pz")):
        out[k] = splats[k] + j["position"] * z[i]
    out["radius"] = splats["radius"] * torch.exp(j["log_radius"] * z[3])
    for i, k in enumerate(("cr", "cg", "cb")):
        out[k] = torch.clamp(splats[k] + j["colour"] * z[4 + i], 0.0, 1.0)
    out["opacity"] = torch.clamp(splats["opacity"] - j["opacity"] * z[7].abs(), 0.0, 1.0)
    return out


class StepHooks:
    """Wrappers at the program's step entries: capture the first steps'
    optimiser input and output, run the profiler's two stretches (the
    device's, then the host's) over the call's last steps, and keep each
    step's pair stream's offsets at the first and last step."""

    def __init__(self, spans: Spans, check_steps: int, trace: bool, skip: int, n_traced: int,
                 roof_steps: int, total: int, device):
        self.spans, self.check_steps = spans, check_steps
        self.trace, self.skip, self.n_traced, self.roof_steps = trace, skip, n_traced, roof_steps
        self.total = total
        self.step = 0
        self.checked = []  # (grads, theta after) of the first steps
        self.roof_theta = []
        self.offsets = {}
        self.t_skip = None  # host clock at the first profiled step's entry
        if trace:
            self.stretches = (Stretch(device, host=False), Stretch(device, host=True))
        self._item = None
        import splat_renderer_tpu_torch.fit as fit_mod
        from splat_renderer_tpu_torch.ops import tile_blend_diff

        self.fit_mod, self.tbd = fit_mod, tile_blend_diff
        self.orig = {"_loss_and_grads": fit_mod._loss_and_grads,
                     "adam_update": fit_mod.adam_update,
                     "bin_planes_diff": tile_blend_diff.bin_planes_diff}

    def _stretch(self, i: int):
        """(stretch, position in it) of step i, or (None, None)."""
        if not self.trace or i < self.skip:
            return None, None
        k, j = divmod(i - self.skip, self.n_traced)
        return (self.stretches[k], j) if k < 2 else (None, None)

    def install(self):
        o = self.orig

        def loss_and_grads(theta, *a, **k):
            stretch, j = self._stretch(self.step)
            if stretch is not None:
                if j == 0 and not stretch.host:
                    self.t_skip = time.perf_counter()
                if j == 0:
                    # the device stretch times no span; the host stretch
                    # names them, to file the device's idle gaps
                    self.spans.timed = False
                    self.spans.named = stretch.host
                    stretch.__enter__()
                self._item = stretch.item()
                self._item.__enter__()
                if not stretch.host and j < self.roof_steps:
                    self.roof_theta.append(theta)
            return o["_loss_and_grads"](theta, *a, **k)

        def adam_update(theta, grads, state, lr, *a, **k):
            out = o["adam_update"](theta, grads, state, lr, *a, **k)
            i = self.step
            if i < self.check_steps:
                self.checked.append((grads, out[0]))
            stretch, j = self._stretch(i)
            if stretch is not None:
                last = j == self.n_traced - 1
                if last and self.spans.device.type == "cuda":
                    torch.cuda.synchronize(self.spans.device)
                self._item.__exit__(None, None, None)
                self._item = None
                if last:
                    stretch.__exit__(None, None, None)
                    self.spans.named = False
            self.step += 1
            return out

        def bin_planes_diff(planes, cfg):
            out = o["bin_planes_diff"](planes, cfg)
            if self.step in (0, self.total - 1):
                self.offsets[self.step] = out["offsets"]
            return out

        self.fit_mod._loss_and_grads = loss_and_grads
        self.fit_mod.adam_update = adam_update
        self.tbd.bin_planes_diff = bin_planes_diff

    def restore(self):
        self.fit_mod._loss_and_grads = self.orig["_loss_and_grads"]
        self.fit_mod.adam_update = self.orig["adam_update"]
        self.tbd.bin_planes_diff = self.orig["bin_planes_diff"]


def norm_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep=None):
    """max over leaves of | ||got|| - ||want|| | / max(||want||, the median
    leaf's ||want||), over the leaves in `keep` (all by default)."""
    names = list(want) if keep is None else keep
    wn = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    med = statistics.median(wn.values())
    worst, at = 0.0, None
    for k in names:
        g = float(torch.linalg.vector_norm(got[k].double()))
        gap = abs(g - wn[k]) / max(wn[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def compare(steps_got, losses_got, steps_ref, losses_ref, theta0, leaf_floor: float):
    """The fit check's numbers from the program's first steps and the
    reference's, and the leaves left out of the change's comparison."""
    grads_got, theta_got = steps_got[0][0], steps_got[-1][1]
    grads_ref, theta_ref = steps_ref
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses_got, losses_ref))
    grad_gap, grad_at = norm_gaps(grads_got, grads_ref)
    gn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads_ref.items()}
    med = statistics.median(gn.values())
    # leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: left out by a rule on the reference's gradient
    keep = [k for k in grads_ref if gn[k] >= leaf_floor * med]
    d_got = {k: theta_got[k] - theta0[k] for k in theta0}
    d_ref = {k: theta_ref[k] - theta0[k] for k in theta0}
    change_gap, change_at = norm_gaps(d_got, d_ref, keep)
    return ({"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap},
            {"grad_worst_leaf": grad_at, "change_worst_leaf": change_at,
             "left_out": sorted(set(grads_ref) - set(keep))})


def fit_call(config, traffic, start, sh, target, device):
    """`call(steps)`: the program's `fit_splats` over the cell's view from
    `start`, as the window runs it."""
    import splat_renderer_tpu_torch as spt
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.fit import fit_splats

    if device.type == "cuda":
        from splat_renderer_tpu_torch.ops import build

        build.build_all(["tile_blend_diff"])
        build.load_library("tile_blend_diff")
    rcfg = spt.RenderConfig(**config["render"])
    cam = camera_tensors(camera_arrays(traffic, config), device)

    def call(steps: int):
        return fit_splats(start, [cam], [target], rcfg, fields=tuple(traffic["fields"]),
                          steps=steps, lr=traffic["lr"], method="kernel", loss=traffic["loss"],
                          sh=sh, fit_sh=traffic["fit_sh"])

    return call


def program_steps(config, traffic, start, sh, target, n: int, device):
    """The program's first n steps as the check captures them, and their
    losses."""
    call = fit_call(config, traffic, start, sh, target, device)
    hooks = StepHooks(Spans(device, timed=False), n, False, 0, 0, 0, n, device)
    hooks.install()
    try:
        _, losses, _ = call(n)
    finally:
        hooks.restore()
    return hooks.checked, [float(v) for v in losses]


def run(config, traffic, seed, seconds, trace, device, readers, t_start) -> dict:
    rref = RefRenderConfig(**config["render"])
    splats, sh = static_scene(config, seed, device)
    cam_ref = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
               for k, v in camera_arrays(traffic, config).items()}
    # the target is the reference's work, not the program's set-up: its
    # time is left out of setup_s, as the check's is
    t_ref = time.perf_counter()
    target = ref_fit.render_image(splats, sh, cam_ref, rref)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ref_s = time.perf_counter() - t_ref
    start = start_of(splats, traffic, seed, device)
    fields = tuple(traffic["fields"])
    call = fit_call(config, traffic, start, sh, target, device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    call(traffic["warmup_steps"])
    sync()
    n_traced = traffic["trace_steps"]
    roof_steps = traffic.get("roofline_steps", 0)
    # a fixed amount of work for a given --seconds: the pair count drifts
    # as the fit moves the splats, so S steps from one start are one load
    steps = max(round(seconds * traffic["steps_per_second"]), traffic["check_steps"] + 1)
    if trace:
        steps = max(steps, traffic["check_steps"] + 2 * n_traced)
    # a traced run profiles the call's last steps, its two stretches of
    # n_traced steps each: the profiler's last stop closes the call
    skip = steps - 2 * n_traced if trace else steps
    spans = Spans(device, timed=trace)
    if trace:
        for name, target_name in wrap_targets(readers).items():
            if not spans.wrap(target_name, name):
                log(f"gpubench: entry {target_name} is gone; its metric reads null")
    hooks = StepHooks(spans, traffic["check_steps"], trace, skip, n_traced, roof_steps, steps,
                      device)
    hooks.install()
    sync()
    # set-up's objects leave the collector's generations: a collection in
    # the window walks only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start - ref_s
    log(f"gpubench: set-up {setup_s:.3f} s (the reference's target render, {ref_s:.3f} s, "
        f"left out); window of {steps} steps")
    t0 = time.perf_counter()
    _, losses, _ = call(steps)
    sync()
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    hooks.restore()
    pairs = {k: int(v[-1]) for k, v in hooks.offsets.items()}
    log(f"gpubench: {steps} steps in {window_s:.3f} s ({window_s * 1e3 / steps:.3f} ms a step); "
        f"pairs at the first and last step {pairs.get(0)} / {pairs.get(steps - 1)}")
    out = {"attempted": steps, "failed": 0, "metrics": {}, "checks": {}}
    out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                if device.type == "cuda" else 0)
    losses = [float(v) for v in losses]
    if not trace:
        out["metrics"] = {"setup_s": setup_s, "step_ms": window_s * 1e3 / steps}
    if trace:
        line = hooks.stretches[0].summary()
        out["busy_s"], out["window_s"] = line.busy_s(), line.window_s()
        log(f"gpubench: device stretch of {n_traced} steps: {line.window_s():.4f} s, "
            f"device busy {line.busy_s():.4f} s, {len(line.device)} device operations")

        def roofline(ops, kernel, n_items):
            least = 0.0
            for theta in hooks.roof_theta[:n_items]:
                s = dict(splats, **{k: v for k, v in theta.items() if ":" not in k})
                shc = {c: theta[f"sh:{c}"] for c in ("r", "g", "b")}
                with torch.no_grad():
                    binned = ref_fit.bin_planes_diff(ref_fit.planes_of(s, shc, cam_ref, rref),
                                                     rref)
                c = ref_fit.render_and_grad(binned, rref)[3]
                nf = binned["planes"].shape[1]
                size = (rref.num_tiles, rref.tile_pixels, c["pairs"], c["records"], nf)
                nbytes = diff_fwd_bytes(*size) if ops.endswith("fwd") else diff_bwd_bytes(*size)
                least += least_seconds(ops, nbytes, c["evals"], c["inside"])
            return share_percent(least, line.kernel_s(kernel, n_items))

        # the steps before the stretches are the unprofiled ones
        item_s = (hooks.t_skip - t0) / skip if hooks.t_skip and skip else None
        run_ = TracedRun(spans, line, hooks.stretches[1].summary(), roofline, item_s=item_s)
        out["breakdown"] = run_.breakdown()
        out["metrics"] = read_metrics(readers, run_)
        spans.restore()
    checked = hooks.checked
    theta0 = {k: start[k] for k in fields}
    theta0.update({f"sh:{c}": sh[c] for c in ("r", "g", "b")})
    del hooks, spans

    limits = config["limits"]["fit"]
    n = traffic["check_steps"]
    if len(checked) < n:
        out["failed"] = n - len(checked)
        out["checks"] = {k: {"value": math.inf, "limit": v} for k, v in limits.items()}
        return out
    t_check = time.perf_counter()
    r_losses, r_first, r_theta = ref_fit.fit_steps(theta0, splats, cam_ref, target, rref, n,
                                                   traffic["lr"], traffic["loss"])
    log(f"gpubench: the reference's {n} steps took {time.perf_counter() - t_check:.3f} s")
    read, notes = compare(checked, losses[:n], (r_first, r_theta), r_losses, theta0,
                          traffic["leaf_floor"])
    log(f"gpubench: losses of the first {n} steps {losses[:n]} against the reference's "
        f"{r_losses}; {notes}")
    out["failed"] = int(any(read[k] > limits[k] for k in limits))
    out["checks"] = {k: {"value": read[k], "limit": limits[k]} for k in limits}
    return out
