"""Readings that set a `views` cell's limits: the control's, the program's
and the planted fault's.

    python3 -m gpubench.views_control --workload views8_2m_1080p --seeds 11 12 13 \
        [--program] [--faults]

`gpubench.control` reads the frame and fit cells; a `views` cell is read
here, the same way.  For each seed it draws the checked items and views as
a run of the cell would (`drivers.views.checked`), computes the reference
of each view, and prints one JSON line per seed with the numbers the check
compares (`drivers.views.gaps`), each the largest over the views:

- "control": the reference computed in bfloat16 (`reference.frame.bf16`:
  the Gaussians' planes, the lit colours, the screen covariance, the
  record's continuous fields and the fold's running colour and
  transmittance rounded to bfloat16), held to the float32 reference;
- with --program, "program": the program's own views (the cell's inputs,
  each checked item rendered as the cell renders it, captured at the
  program's entries), held to the float32 reference;
- with --faults, "disc_collapse": the reference's render of each Gaussian
  collapsed to a disc as `load_ply`'s default mapping makes it (normal the
  axis of the smallest scale, radius the geometric mean of the two larger
  scales, the "ewa" disc model) put in the program's place.

A limit lies above every sound reading of the program and below the
control's and the fault's.  This is not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import bench
from .drivers import views
from .reference import frame as ref
from .reference.config import RenderConfig
from .reference.gaussians import quantize_u8, rotation


def disc_collapse(splats: dict) -> dict:
    """The Gaussians as `load_ply`'s default mapping makes them: the
    normal is R(q)'s axis of the smallest scale, the radius the geometric
    mean of the two larger scales; the covariance planes are dropped."""
    s = torch.stack([splats[k] for k in views.COV3D[:3]], 1)
    q = torch.stack([splats[k] for k in views.COV3D[3:]], 1)
    rot = rotation(q)
    flat = torch.argmin(s, dim=1)
    normal = rot.gather(2, flat[:, None, None].expand(-1, 3, 1))[:, :, 0]
    larger = torch.sort(s, dim=1).values[:, 1:]
    out = {k: v for k, v in splats.items() if k not in views.COV3D}
    out.update(radius=torch.sqrt(larger[:, 0] * larger[:, 1]), nx=normal[:, 0].contiguous(),
               ny=normal[:, 1].contiguous(), nz=normal[:, 2].contiguous())
    return out


def disc_view(config: dict, traffic: dict, splats, sh, i: int, v: int, device) -> dict:
    """The disc collapse's view v of item i, rendered by the reference with
    the "ewa" disc model."""
    ewa = dict(config, render=dict(config["render"], ellipse="ewa"))
    rcfg = RenderConfig(**ewa["render"])
    cam = views.ref_camera(config, traffic, i, v, device)
    lit = ref.lit_splats(disc_collapse(splats), sh, cam["cam_pos"])
    words, binned, image, _ = ref.render(lit, cam, rcfg)
    u8 = quantize_u8(image).reshape(rcfg.height, rcfg.width * 3)
    return {"splats": lit, "words": words, "binned": binned, "image": image, "u8": u8}


def program_views(config: dict, traffic: dict, seed: int, device, check_at: dict) -> dict:
    """The program's checked views, each checked item rendered once as the
    cell renders it."""
    st = views.Setup(config, traffic, seed, device)
    capture = views.Capture()
    capture.install()
    got = {}
    try:
        for i, vs in sorted(check_at.items()):
            capture.start(vs)
            host = st.item(i)
            for v, g in capture.stop(host).items():
                got[(i, v)] = g
    finally:
        capture.restore()
    return got


def readings(workload: str, seed: int, device, program: bool, faults: bool = False,
             root=bench.ROOT) -> dict:
    spec = bench.load_spec(root)
    config, traffic = bench.cell_parts(spec, workload, root / "gpubench")
    check_at = views.checked(traffic, seed)
    splats, sh = views.gaussian_scene(config, seed, device)
    got_program = program_views(config, traffic, seed, device, check_at) if program else {}
    out = {"seed": seed, "views": {str(i): vs for i, vs in check_at.items()}, "control": {},
           "program": {}}
    for i, vs in sorted(check_at.items()):
        for v in vs:
            want = views.reference_view(config, traffic, splats, sh, i, v, device)
            low = views.reference_view(config, traffic, splats, sh, i, v, device, rnd=ref.bf16)
            disc = disc_view(config, traffic, splats, sh, i, v, device) if faults else None
            for key, got in (("control", low), ("program", got_program.get((i, v))),
                             ("disc_collapse", disc)):
                if got is None:
                    continue
                for k, val in views.gaps(got, want).items():
                    out.setdefault(key, {})[k] = max(out.get(key, {}).get(k, 0.0), val)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench.views_control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--faults", action="store_true",
                   help="the readings of the disc collapse put in the program's place")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.views_control: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for s in a.seeds:
        print(json.dumps(readings(a.workload, s, dev, a.program, a.faults)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
