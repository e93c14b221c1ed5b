"""CSG combination operators over (distance, gradient) fields.

Counterpart of `splat_renderer_tpu/sdf/ops.py`: each op combines two
`(dist, grad)` batches elementwise with `torch.where` selects.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .primitives import SdfResult

_next_op_id = [0]


def op_union(a: SdfResult, b: SdfResult) -> SdfResult:
    """min-union, selecting the nearer field's gradient."""
    da, ga = a
    db, gb = b
    take_a = da < db
    return torch.where(take_a, da, db), torch.where(take_a[..., None], ga, gb)


def op_intersection(a: SdfResult, b: SdfResult) -> SdfResult:
    """max-intersection."""
    da, ga = a
    db, gb = b
    take_a = da > db
    return torch.where(take_a, da, db), torch.where(take_a[..., None], ga, gb)


def op_subtraction(a: SdfResult, b: SdfResult) -> SdfResult:
    """a minus b = intersection(a, -b)."""
    db, gb = b
    return op_intersection(a, (-db, -gb))


def op_smooth_union(a: SdfResult, b: SdfResult, k) -> SdfResult:
    """Quadratic-polynomial smooth minimum with blended gradient; k is
    normalized by 4 so it reads as blend thickness."""
    da, ga = a
    db, gb = b
    k4 = k * 4.0
    diff = torch.abs(da - db)
    h = torch.clamp(k4 - diff, min=0.0) / k4
    dist = torch.minimum(da, db) - h * h * k4 * 0.25

    h_grad = torch.clamp(k4 - diff, min=0.0) / (2.0 * k4)
    t = torch.where(da < db, h_grad, 1.0 - h_grad)
    grad = ga + t[..., None] * (gb - ga)
    return dist, grad


def op_smooth_intersection(a: SdfResult, b: SdfResult, k) -> SdfResult:
    """Smooth maximum: -smin(-a, -b, k)."""
    da, ga = a
    db, gb = b
    d, g = op_smooth_union((-da, -ga), (-db, -gb), k)
    return -d, -g


def op_smooth_subtraction(a: SdfResult, b: SdfResult, k) -> SdfResult:
    """a minus b with a smooth fillet = smooth_intersection(a, -b)."""
    db, gb = b
    return op_smooth_intersection(a, (-db, -gb), k)


class Operation:
    """CSG operation node metadata."""

    kind = "op"

    def params(self) -> Dict[str, np.ndarray]:
        return {}

    def apply(self, a: SdfResult, b: SdfResult, params: Dict) -> SdfResult:
        raise NotImplementedError


class Union(Operation):
    kind = "union"

    def apply(self, a, b, params):
        return op_union(a, b)


class Intersection(Operation):
    kind = "intersection"

    def apply(self, a, b, params):
        return op_intersection(a, b)


class Subtraction(Operation):
    kind = "subtraction"

    def apply(self, a, b, params):
        return op_subtraction(a, b)


class _SmoothOp(Operation):
    """Smooth op with an animatable blend radius k."""

    prefix = ""

    def __init__(self, k: float, id: str | None = None):
        i = _next_op_id[0]
        _next_op_id[0] += 1
        self.id = id or f"{self.prefix}_{i}"
        self.k = float(k)

    def params(self):
        return {"k": np.float32(self.k)}


class SmoothUnion(_SmoothOp):
    kind = "smooth_union"
    prefix = "smin"

    def apply(self, a, b, params):
        return op_smooth_union(a, b, params["k"])


class SmoothIntersection(_SmoothOp):
    kind = "smooth_intersection"
    prefix = "smax"

    def apply(self, a, b, params):
        return op_smooth_intersection(a, b, params["k"])


class SmoothSubtraction(_SmoothOp):
    kind = "smooth_subtraction"
    prefix = "ssub"

    def apply(self, a, b, params):
        return op_smooth_subtraction(a, b, params["k"])
