"""Readings that set a cell's limits: the program's and the control's.

    python3 -m gpubench.control --workload sdf_anim --seeds 11 12 13 [--program]

For each seed it draws the check's frames as a run of the cell would,
computes the reference of each, and prints one JSON line per seed with the
numbers the check compares:

- "control": the reference computed in the nearest precision below the
  configuration's float32, bfloat16 (`reference.frame.bf16`: every float
  handed from one stage to the next, and the blend's running colour and
  transmittance, rounded to bfloat16), held to the float32 reference;
- with --program, "program": the program's own frames (its engine, as the
  cell builds it, the check's frames rendered one by one) or first fit
  steps (one `fit_splats` call), held to the float32 reference;
- with --faults, a frame cell's planted fault "early_stop": the reference
  with its pixels stopping at T <= `EARLY_STOP` (0.05, against the
  configuration's 0.01) put in the program's place; a fit cell's faults
  are `FAULTS`, planted in the reference fit.

A fit cell reads the first steps' losses, first gradient and change of
the parameters (`fitloop.compare`); its control is the reference fit with
the same rounding to bfloat16.

A limit lies above every sound reading of the program and below the
control's.  This is not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

import torch

from . import bench
from .drivers import fit as fitloop
from .drivers import frames
from .inputs import static_scene
from .reference import fit as ref_fit
from .reference import frame as ref
from .tracing import seed_of


EARLY_STOP = 0.05


def readings(workload: str, seed: int, device, program: bool, faults: bool = False,
             root=bench.ROOT) -> dict:
    spec = bench.load_spec(root)
    config, traffic = bench.cell_parts(spec, workload, root / "gpubench")
    if traffic["kind"] == "fit":
        return fit_readings(config, traffic, seed, device, program)
    rng = random.Random(seed_of(seed, 0xC4EC))
    check_at = sorted(rng.sample(range(traffic["check_range"]), traffic["check_frames"]))
    splats_in, sh_in = (static_scene(config, seed, device)
                        if config["engine"] == "static" else (None, None))
    got_program = {}
    if program:
        st = frames.Setup(config, traffic, seed, device)
        spans = frames.Spans(device, timed=False)
        for name, target in frames.CAPTURE.items():
            spans.wrap(target, name)
        spans.capturing = True
        for fi in check_at:
            got_program[fi] = frames.program_frame(spans, st.frame(fi))
        spans.restore()
        del st
    out = {"seed": seed, "frames": check_at, "control": {}, "program": {}}
    early = dict(config, render=dict(config["render"], transmittance_eps=EARLY_STOP))
    keys = ("splats", "words", "binned", "image")
    for fi in check_at:
        want = dict(zip(keys, frames.reference_frame(config, traffic, seed, fi, device,
                                                     splats_in, sh_in)[:4]))
        low = dict(zip(keys, frames.reference_frame(config, traffic, seed, fi, device,
                                                    splats_in, sh_in, rnd=ref.bf16)[:4]))
        stop = (dict(zip(keys, frames.reference_frame(early, traffic, seed, fi, device,
                                                      splats_in, sh_in)[:4]))
                if faults else None)
        for key, got in (("control", low), ("program", got_program.get(fi)),
                         ("early_stop", stop)):
            if got is None:
                continue
            for k, v in frames.gaps(config, got, want).items():
                out.setdefault(key, {})[k] = max(out.get(key, {}).get(k, 0.0), v)
    return out


def fit_readings(config: dict, traffic: dict, seed: int, device, program: bool) -> dict:
    """The fit check's numbers for the control's first steps and, with
    `program`, for the program's (its `fit_splats` over those steps)."""
    rref = fitloop.RefRenderConfig(**config["render"])
    splats, sh = static_scene(config, seed, device)
    cam = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
           for k, v in fitloop.camera_arrays(traffic, config).items()}
    target = ref_fit.render_image(splats, sh, cam, rref)
    start = fitloop.start_of(splats, traffic, seed, device)
    theta0 = {k: start[k] for k in traffic["fields"]}
    theta0.update({f"sh:{c}": sh[c] for c in ("r", "g", "b")})
    n, lr, loss = traffic["check_steps"], traffic["lr"], traffic["loss"]
    r_losses, r_first, r_theta = ref_fit.fit_steps(theta0, splats, cam, target, rref, n, lr, loss)
    out = {"seed": seed, "control": {}, "program": {}}
    c_losses, c_first, c_theta = ref_fit.fit_steps(theta0, splats, cam, target, rref, n, lr,
                                                   loss, rnd=ref.bf16)
    steps_c = [(c_first, None)] * (n - 1) + [(c_first, c_theta)]
    out["control"], out["control_notes"] = fitloop.compare(
        steps_c, c_losses, (r_first, r_theta), r_losses, theta0, traffic["leaf_floor"])
    if program:
        checked, losses = fitloop.program_steps(config, traffic, start, sh, target, n, device)
        out["program"], out["program_notes"] = fitloop.compare(
            checked, losses, (r_first, r_theta), r_losses, theta0, traffic["leaf_floor"])
    return out


def _faulty(fault: str):
    """A context that plants `fault` in the reference fit put in the
    program's place: "state_unchanged" (each Adam step returns the
    parameters it was given), "half_the_batch" (the loss over the top half
    of the image, the mean taken over that half), "altered_tile" (one
    tile's colour raised by 0.5 where the blend produces it)."""
    import contextlib

    @contextlib.contextmanager
    def planted():
        saved = {k: getattr(ref_fit, k) for k in ("adam_update", "image_loss", "tiles_to_image")}
        if fault == "state_unchanged":
            ref_fit.adam_update = lambda theta, grads, state, lr: (
                theta, saved["adam_update"](theta, grads, state, lr)[1])
        elif fault == "half_the_batch":
            def half(name):
                f = saved["image_loss"](name)
                return lambda img, tgt: f(img[: img.shape[0] // 2], tgt[: tgt.shape[0] // 2])
            ref_fit.image_loss = half
        elif fault == "altered_tile":
            def altered(color, alpha, cfg):
                bump = torch.zeros_like(color)
                bump[color.shape[0] // 2] = 0.5
                return saved["tiles_to_image"](color + bump, alpha, cfg)
            ref_fit.tiles_to_image = altered
        else:
            raise ValueError(f"unknown fault {fault!r}")
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(ref_fit, k, v)

    return planted()


FAULTS = ("state_unchanged", "half_the_batch", "altered_tile")


def fault_readings(workload: str, seed: int, device, root=bench.ROOT) -> dict:
    """The fit check's numbers for each fault of `FAULTS` planted in the
    reference, held to the sound reference."""
    spec = bench.load_spec(root)
    config, traffic = bench.cell_parts(spec, workload, root / "gpubench")
    rref = fitloop.RefRenderConfig(**config["render"])
    splats, sh = static_scene(config, seed, device)
    cam = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
           for k, v in fitloop.camera_arrays(traffic, config).items()}
    target = ref_fit.render_image(splats, sh, cam, rref)
    start = fitloop.start_of(splats, traffic, seed, device)
    theta0 = {k: start[k] for k in traffic["fields"]}
    theta0.update({f"sh:{c}": sh[c] for c in ("r", "g", "b")})
    n, lr, loss = traffic["check_steps"], traffic["lr"], traffic["loss"]
    r_losses, r_first, r_theta = ref_fit.fit_steps(theta0, splats, cam, target, rref, n, lr, loss)
    out = {"seed": seed}
    for fault in FAULTS:
        with _faulty(fault):
            f_losses, f_first, f_theta = ref_fit.fit_steps(theta0, splats, cam, target, rref, n,
                                                           lr, loss)
        steps = [(f_first, None)] * (n - 1) + [(f_first, f_theta)]
        out[fault] = fitloop.compare(steps, f_losses, (r_first, r_theta), r_losses, theta0,
                                     traffic["leaf_floor"])[0]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--faults", action="store_true",
                   help="the readings of each fault planted in the reference")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.control: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for s in a.seeds:
        kind = bench.cell_parts(bench.load_spec(), a.workload)[1]["kind"]
        if a.faults and kind == "fit":
            print(json.dumps({"faults": fault_readings(a.workload, s, dev)}), flush=True)
        else:
            print(json.dumps(readings(a.workload, s, dev, a.program, a.faults)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
