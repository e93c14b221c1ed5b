"""SDF primitives with analytic gradients, vectorized over point batches.

Counterpart of `splat_renderer_tpu/sdf/primitives.py`: the same 7 `sdg_*`
functions written as elementwise torch ops (all branches are `torch.where`
selects), and the same mutable `Primitive` classes.

Every `sdg_*` function takes points already translated into the primitive's
local frame and returns `(dist, grad)` with shapes `(...,)` and `(..., 3)`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .._torch_util import rdiv

SdfResult = Tuple[torch.Tensor, torch.Tensor]  # (dist (...,), grad (..., 3))

_EPS = 1e-4


def _length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def sdg_sphere(p: torch.Tensor, radius: torch.Tensor) -> SdfResult:
    """Sphere distance + gradient."""
    d = _length(p)
    dist = d - radius
    grad = p / torch.clamp(d, min=_EPS)[..., None]
    return dist, grad


def sdg_box(p: torch.Tensor, half_size: torch.Tensor) -> SdfResult:
    """Box distance + gradient.

    Outside: grad = sign(p) * normalize(max(q, 0)).
    Inside: the gradient points at the nearest face (x wins only on strict
    >, then y, else z).
    """
    q = torch.abs(p) - half_size
    w = torch.clamp(q, min=0.0)
    wlen = _length(w)
    g = torch.amax(q, dim=-1)
    dist = wlen + torch.clamp(g, max=0.0)

    s = torch.sign(p)
    grad_out = s * (w / torch.clamp(wlen, min=_EPS)[..., None])

    qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]
    pick_x = (qx > qy) & (qx > qz)
    pick_y = (~pick_x) & (qy > qz)
    one, zero = torch.ones_like(qx), torch.zeros_like(qx)
    axis_onehot = torch.stack(
        [
            torch.where(pick_x, one, zero),
            torch.where(pick_y, one, zero),
            torch.where(pick_x | pick_y, zero, one),
        ],
        dim=-1,
    )
    grad_in = s * axis_onehot
    grad = torch.where((g > 0.0)[..., None], grad_out, grad_in)
    return dist, grad


def sdg_torus(p: torch.Tensor, major: torch.Tensor, minor: torch.Tensor) -> SdfResult:
    """Torus (ring in the xz-plane) distance + gradient."""
    pxz = p[..., [0, 2]]
    lxz = _length(pxz)
    q = torch.stack([lxz - major, p[..., 1]], dim=-1)
    lq = _length(q)
    dist = lq - minor

    ok = (lxz > _EPS) & (lq > _EPS)
    dxz = pxz / torch.clamp(lxz, min=_EPS)[..., None]
    dd = q / torch.clamp(lq, min=_EPS)[..., None]
    grad_ok = torch.stack(
        [dxz[..., 0] * dd[..., 0], dd[..., 1], dxz[..., 1] * dd[..., 0]],
        dim=-1,
    )
    grad_fallback = torch.tensor(
        [0.0, 1.0, 0.0], dtype=p.dtype, device=p.device
    ).expand(grad_ok.shape)
    grad = torch.where(ok[..., None], grad_ok, grad_fallback)
    return dist, grad


def sdg_capsule(p: torch.Tensor, height: torch.Tensor, radius: torch.Tensor) -> SdfResult:
    """Vertical capsule distance + gradient."""
    half_h = height * 0.5
    py = torch.clamp(p[..., 1], min=-half_h, max=half_h)
    q = p - torch.stack([torch.zeros_like(py), py, torch.zeros_like(py)], dim=-1)
    d = _length(q)
    dist = d - radius
    grad_ok = q / torch.clamp(d, min=_EPS)[..., None]
    zero = torch.zeros_like(p[..., 0])
    grad_fallback = torch.stack([zero, torch.sign(p[..., 1]), zero], dim=-1)
    grad = torch.where((d > _EPS)[..., None], grad_ok, grad_fallback)
    return dist, grad


def sdg_cylinder(p: torch.Tensor, height: torch.Tensor, radius: torch.Tensor) -> SdfResult:
    """Capped vertical cylinder distance + gradient (the exact capped
    cylinder SDF; radial/axial parts outside, nearest-face one-hot
    inside)."""
    hh = height * 0.5
    pxz = p[..., [0, 2]]
    rl = _length(pxz)
    qx = rl - radius
    qy = torch.abs(p[..., 1]) - hh
    wx = torch.clamp(qx, min=0.0)
    wy = torch.clamp(qy, min=0.0)
    outside = torch.sqrt(wx * wx + wy * wy)
    dist = outside + torch.clamp(torch.maximum(qx, qy), max=0.0)

    one, zero = torch.ones_like(rl), torch.zeros_like(rl)
    safe_rl = torch.clamp(rl, min=_EPS)
    rx = torch.where(rl > _EPS, pxz[..., 0] / safe_rl, one)
    rz = torch.where(rl > _EPS, pxz[..., 1] / safe_rl, zero)
    sy = torch.where(p[..., 1] >= 0.0, one, -one)
    inv_out = rdiv(1.0, torch.clamp(outside, min=_EPS))
    grad_out = torch.stack(
        [wx * rx * inv_out, wy * sy * inv_out, wx * rz * inv_out], dim=-1
    )
    pick_r = qx > qy  # nearest interior face: side wall vs cap
    grad_in = torch.stack(
        [
            torch.where(pick_r, rx, zero),
            torch.where(pick_r, zero, sy),
            torch.where(pick_r, rz, zero),
        ],
        dim=-1,
    )
    is_out = (qx > 0.0) | (qy > 0.0)
    return dist, torch.where(is_out[..., None], grad_out, grad_in)


def sdg_ellipsoid(p: torch.Tensor, radii: torch.Tensor) -> SdfResult:
    """Axis-aligned ellipsoid: the first-order bound k0*(k0-1)/k1 with its
    own analytic gradient (exact for equal radii)."""
    r2 = radii * radii
    pr = p / radii
    pr2 = p / r2
    k0 = _length(pr)
    k1 = _length(pr2)
    safe_k0 = torch.clamp(k0, min=_EPS)
    safe_k1 = torch.clamp(k1, min=_EPS)
    dist = k0 * (k0 - 1.0) / safe_k1
    # d = (k0^2 - k0)/k1;  grad k0 = pr2/k0,  grad k1 = (p/r^4)/k1
    gk0 = pr2 / safe_k0[..., None]
    gk1 = (pr2 / r2) / safe_k1[..., None]
    grad = (
        (2.0 * k0 - 1.0)[..., None] * gk0
        - (k0 * (k0 - 1.0) / safe_k1)[..., None] * gk1
    ) / safe_k1[..., None]
    # centre: the quotient form degenerates (0/0); any fixed unit vector
    center = k0 < _EPS
    dist = torch.where(center, -torch.amin(radii, dim=-1), dist)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=p.dtype, device=p.device).expand(grad.shape)
    grad = torch.where(center[..., None], up, grad)
    return dist, grad


def sdg_round_box(p: torch.Tensor, half_size: torch.Tensor, rounding: torch.Tensor) -> SdfResult:
    """Rounded box: the box field of the inner core minus the rounding
    radius.  `half_size` is the outer half-extent."""
    inner = torch.clamp(half_size - rounding, min=_EPS)
    d, g = sdg_box(p, inner)
    return d - rounding, g


# ---------------------------------------------------------------------------
# Primitive classes: the mutable, animatable host-side scene objects.
# Parameters are plain numpy so the user can mutate them per frame;
# `SDFScene.params(device)` snapshots them as tensors.
# ---------------------------------------------------------------------------

_next_id = [0]


def _fresh_id() -> str:
    i = _next_id[0]
    _next_id[0] += 1
    return f"prim_{i}"


class Primitive:
    """Base primitive: id + world position."""

    kind = "primitive"

    def __init__(self, id: str | None = None, position=(0.0, 0.0, 0.0)):
        self.id = id or _fresh_id()
        self.position = np.asarray(position, dtype=np.float32).copy()

    # --- interface ---
    def params(self) -> Dict[str, np.ndarray]:
        """Snapshot of the animatable parameters (numpy float32)."""
        raise NotImplementedError

    def sdg(self, local_p: torch.Tensor, params: Dict[str, torch.Tensor]) -> SdfResult:
        """Evaluate distance+gradient at points in the primitive's local frame."""
        raise NotImplementedError

    def aabb(self, params: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Axis-aligned bounds (min, max) as tensors."""
        raise NotImplementedError

    def surface_area(self) -> float:
        raise NotImplementedError



class Sphere(Primitive):
    kind = "sphere"

    def __init__(self, id=None, position=(0, 0, 0), radius: float = 0.5):
        super().__init__(id, position)
        self.radius = float(radius)

    def params(self):
        return {"center": np.asarray(self.position, np.float32), "radius": np.float32(self.radius)}

    def sdg(self, local_p, params):
        return sdg_sphere(local_p, params["radius"])

    def aabb(self, params):
        r = params["radius"]
        c = params["center"]
        return c - r, c + r

    def surface_area(self):
        return 4.0 * math.pi * self.radius**2



class Box(Primitive):
    """Box with half-extents `size`."""

    kind = "box"

    def __init__(self, id=None, position=(0, 0, 0), size=(0.5, 0.5, 0.5)):
        super().__init__(id, position)
        self.size = np.asarray(size, dtype=np.float32).copy()

    def params(self):
        return {"center": np.asarray(self.position, np.float32), "size": np.asarray(self.size, np.float32)}

    def sdg(self, local_p, params):
        return sdg_box(local_p, params["size"])

    def aabb(self, params):
        return params["center"] - params["size"], params["center"] + params["size"]

    def surface_area(self):
        w, h, d = (2 * float(s) for s in self.size)
        return 2.0 * (w * h + w * d + h * d)



class Torus(Primitive):
    kind = "torus"

    def __init__(self, id=None, position=(0, 0, 0), major_radius=0.5, minor_radius=0.2):
        super().__init__(id, position)
        self.major_radius = float(major_radius)
        self.minor_radius = float(minor_radius)

    def params(self):
        return {
            "center": np.asarray(self.position, np.float32),
            "major": np.float32(self.major_radius),
            "minor": np.float32(self.minor_radius),
        }

    def sdg(self, local_p, params):
        return sdg_torus(local_p, params["major"], params["minor"])

    def aabb(self, params):
        outer = params["major"] + params["minor"]
        c = params["center"]
        ext = torch.stack([outer, params["minor"], outer])
        return c - ext, c + ext

    def surface_area(self):
        return 4.0 * math.pi**2 * self.major_radius * self.minor_radius



class Capsule(Primitive):
    kind = "capsule"

    def __init__(self, id=None, position=(0, 0, 0), height=1.0, radius=0.3):
        super().__init__(id, position)
        self.height = float(height)
        self.radius = float(radius)

    def params(self):
        return {
            "center": np.asarray(self.position, np.float32),
            "height": np.float32(self.height),
            "radius": np.float32(self.radius),
        }

    def sdg(self, local_p, params):
        return sdg_capsule(local_p, params["height"], params["radius"])

    def aabb(self, params):
        c = params["center"]
        r = params["radius"]
        half_h = params["height"] * 0.5
        ext = torch.stack([r, half_h + r, r])
        return c - ext, c + ext

    def surface_area(self):
        return 2 * math.pi * self.radius * self.height + 4 * math.pi * self.radius**2



class Cylinder(Primitive):
    """Capped vertical cylinder."""

    kind = "cylinder"

    def __init__(self, id=None, position=(0, 0, 0), height=1.0, radius=0.3):
        super().__init__(id, position)
        self.height = float(height)
        self.radius = float(radius)

    def params(self):
        return {
            "center": np.asarray(self.position, np.float32),
            "height": np.float32(self.height),
            "radius": np.float32(self.radius),
        }

    def sdg(self, local_p, params):
        return sdg_cylinder(local_p, params["height"], params["radius"])

    def aabb(self, params):
        c = params["center"]
        r = params["radius"]
        ext = torch.stack([r, params["height"] * 0.5, r])
        return c - ext, c + ext

    def surface_area(self):
        return 2 * math.pi * self.radius * (self.height + self.radius)



class Ellipsoid(Primitive):
    kind = "ellipsoid"

    def __init__(self, id=None, position=(0, 0, 0), radii=(0.5, 0.3, 0.4)):
        super().__init__(id, position)
        self.radii = np.asarray(radii, dtype=np.float32).copy()

    def params(self):
        return {"center": np.asarray(self.position, np.float32), "radii": np.asarray(self.radii, np.float32)}

    def sdg(self, local_p, params):
        return sdg_ellipsoid(local_p, params["radii"])

    def aabb(self, params):
        return params["center"] - params["radii"], params["center"] + params["radii"]

    def surface_area(self):
        # Thomsen's approximation (max error ~1.06%)
        a, b, c = (float(r) for r in self.radii)
        p = 1.6075
        return 4.0 * math.pi * (
            ((a * b) ** p + (a * c) ** p + (b * c) ** p) / 3.0
        ) ** (1.0 / p)



class RoundBox(Primitive):
    """Box with rounded edges/corners; `size` is the OUTER half-extent."""

    kind = "round_box"

    def __init__(self, id=None, position=(0, 0, 0), size=(0.5, 0.5, 0.5),
                 rounding=0.1):
        super().__init__(id, position)
        self.size = np.asarray(size, dtype=np.float32).copy()
        self.rounding = float(rounding)

    def params(self):
        return {
            "center": np.asarray(self.position, np.float32),
            "size": np.asarray(self.size, np.float32),
            "rounding": np.float32(self.rounding),
        }

    def sdg(self, local_p, params):
        return sdg_round_box(local_p, params["size"], params["rounding"])

    def aabb(self, params):
        return params["center"] - params["size"], params["center"] + params["size"]

    def surface_area(self):
        # exact: inner faces + quarter-cylinder edges + sphere corners
        r = min(self.rounding, float(self.size.min()))
        w, h, d = (2.0 * max(float(s) - r, 0.0) for s in self.size)
        return (
            2.0 * (w * h + w * d + h * d)
            + 2.0 * math.pi * r * (w + h + d)
            + 4.0 * math.pi * r * r
        )



def scale_aabb(lo: torch.Tensor, hi: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grow an AABB about its centre."""
    center = (lo + hi) * 0.5
    ext = (hi - lo) * (scale * 0.5)
    return center - ext, center + ext
