"""What the benchmark hands the program: SDF scenes built from their data
files, and the static configurations' splats made from the seed.

A scene file (`scenes/<name>.json`) holds a CSG tree and its animation as
data.  `build` makes the tree from either side's SDF modules: the
program's (`splat_renderer_tpu_torch.sdf`) for the engine, the reference's
(`reference.sdf`) for the check, so both read one description.  A node is
`{"prim": <class>, ...its keyword arguments}` or `{"op": <function>,
"args": [leading numbers], "of": [children]}`.  The animation sets, at
time t, each listed attribute (or its `index`-th element) to
`amp * wave(t * rate)`, plus `base` where one is given.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from .tracing import seed_of

WAVES = {"sin": math.sin, "cos": math.cos}


def program_sdf() -> SimpleNamespace:
    from splat_renderer_tpu_torch.sdf import primitives, scene

    return SimpleNamespace(primitives=primitives, scene=scene)


def reference_sdf() -> SimpleNamespace:
    from .reference.sdf import primitives, scene

    return SimpleNamespace(primitives=primitives, scene=scene)


def _node(desc: dict, sdf: SimpleNamespace):
    if "prim" in desc:
        kw = {k: v for k, v in desc.items() if k != "prim"}
        return getattr(sdf.primitives, desc["prim"])(**kw)
    children = [_node(c, sdf) for c in desc["of"]]
    return getattr(sdf.scene, desc["op"])(*desc.get("args", []), *children)


def build(desc: dict, sdf: SimpleNamespace):
    """The scene of a scene file's description, from `sdf`'s classes."""
    return sdf.scene.SDFScene(_node(desc["tree"], sdf))


def animate(scene, desc: dict, t: float) -> None:
    """Set the scene's animated parameters to their values at time t."""
    for a in desc.get("animate", []):
        v = a["amp"] * WAVES[a["wave"]](t * a["rate"])
        if "base" in a:
            v = a["base"] + v
        node = scene[a["id"]]
        if "index" in a:
            getattr(node, a["attr"])[a["index"]] = v
        else:
            setattr(node, a["attr"], v)


def static_scene(config: dict, seed: int, device):
    """A static configuration's splats and SH rest coefficients, made on the
    device from the seed by the reference's modeler (not the program's), so
    a change to the program's modeler cannot change them."""
    from .reference import frame as ref
    from .reference.config import PointConfig, RenderConfig

    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 0x5CE7E))
    splats = ref.model_splats(build(config["scene"], reference_sdf()), gen, config["n"],
                              PointConfig(**config["points"]), RenderConfig(**config["render"]))
    rows = {1: 3, 2: 8, 3: 15}[config["sh_degree"]]
    sh = torch.randn((3, rows, config["n"]), generator=gen, device=device) * config["sh_std"]
    return splats, {"r": sh[0], "g": sh[1], "b": sh[2]}


def scene_at(config: dict, traffic: dict, i: int, sdf: SimpleNamespace):
    """An animated configuration's scene as frame i sees it."""
    scene = build(config["scene"], sdf)
    if traffic.get("animate_fps"):
        animate(scene, config["scene"], i / traffic["animate_fps"])
    return scene


