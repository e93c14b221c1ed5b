"""CSG scene graph and its evaluation as a function of points.

Counterpart of `splat_renderer_tpu/sdf/scene.py`.  `SDFScene.sdf` walks the
tree and evaluates it with torch ops; `structure_hash()` names the tree's
shape, so callers key per-structure state on it, and parameter animation is
a fresh `params(device)` snapshot (a plain dict of tensors).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union as TUnion

import torch

from .ops import (
    Intersection,
    Operation,
    SmoothIntersection,
    SmoothSubtraction,
    SmoothUnion,
    Subtraction,
    Union,
)
from .primitives import Primitive, SdfResult, scale_aabb

# A scene node is either a primitive or (operation, [children]).
SceneNode = TUnion[Primitive, "OpNode"]


class OpNode:
    __slots__ = ("operation", "children")

    def __init__(self, operation: Operation, children: List[SceneNode]):
        self.operation = operation
        self.children = children


def _as_node(x) -> SceneNode:
    if isinstance(x, (Primitive, OpNode)):
        return x
    raise TypeError(f"not a scene node: {x!r}")


def union(a, b) -> OpNode:
    return OpNode(Union(), [_as_node(a), _as_node(b)])


def intersection(a, b) -> OpNode:
    return OpNode(Intersection(), [_as_node(a), _as_node(b)])


def subtraction(a, b) -> OpNode:
    return OpNode(Subtraction(), [_as_node(a), _as_node(b)])


def smooth_union(k: float, a, b) -> OpNode:
    return OpNode(SmoothUnion(k), [_as_node(a), _as_node(b)])


def smooth_intersection(k: float, a, b) -> OpNode:
    return OpNode(SmoothIntersection(k), [_as_node(a), _as_node(b)])


def smooth_subtraction(k: float, a, b) -> OpNode:
    return OpNode(SmoothSubtraction(k), [_as_node(a), _as_node(b)])


Params = Dict[str, Dict[str, torch.Tensor]]


class SDFScene:
    """Mutable scene container."""

    def __init__(self, root: Optional[SceneNode] = None):
        self._root: Optional[SceneNode] = None
        self._primitives: Dict[str, Primitive] = {}
        if root is not None:
            self.set_root(root)

    # -- structure ----------------------------------------------------------
    def set_root(self, node: SceneNode) -> None:
        self._root = _as_node(node)
        self._primitives = {}
        self._collect(self._root)

    def _collect(self, node: SceneNode) -> None:
        if isinstance(node, Primitive):
            self._primitives[node.id] = node
        else:
            for c in node.children:
                self._collect(c)

    def __getitem__(self, id: str) -> Primitive:
        return self._primitives[id]

    def primitives(self) -> List[Primitive]:
        return list(self._primitives.values())

    def operations(self) -> List[Operation]:
        ops: List[Operation] = []

        def walk(node: SceneNode):
            if isinstance(node, OpNode):
                ops.append(node.operation)
                for c in node.children:
                    walk(c)

        if self._root is not None:
            walk(self._root)
        return ops

    def structure_hash(self) -> str:
        """Typed tree walk: the key of per-structure state."""

        def walk(node: SceneNode) -> str:
            if isinstance(node, Primitive):
                return f"P:{node.kind}:{node.id}"
            kids = ",".join(walk(c) for c in node.children)
            return f"O:{node.operation.kind}:({kids})"

        return walk(self._root) if self._root is not None else ""

    # -- parameters ---------------------------------------------------------
    def params(self, device) -> Params:
        """Snapshot all animatable parameters as float32 tensors on
        `device`, keyed by primitive/operation id."""
        out: Params = {}
        nodes = self.primitives() + self.operations()
        for node in nodes:
            values = node.params()
            if values:
                out[node.id] = {
                    k: torch.as_tensor(v, dtype=torch.float32, device=device)
                    for k, v in values.items()
                }
        return out

    # -- evaluation ---------------------------------------------------------
    def sdf(self, p: torch.Tensor, params: Params) -> SdfResult:
        """Evaluate (distance, gradient) at points p (..., 3).  An empty
        scene returns (1000, +y)."""
        if self._root is None:
            dist = torch.full(p.shape[:-1], 1000.0, dtype=p.dtype, device=p.device)
            grad = torch.zeros_like(p)
            grad[..., 1] = 1.0
            return dist, grad

        def walk(node: SceneNode) -> SdfResult:
            if isinstance(node, Primitive):
                prim_params = params[node.id]
                return node.sdg(p - prim_params["center"], prim_params)
            a = walk(node.children[0])
            b = walk(node.children[1])
            op = node.operation
            op_params = params.get(getattr(op, "id", ""), {})
            return op.apply(a, b, op_params)

        return walk(self._root)

    # -- bounds -------------------------------------------------------------
    def aabb(self, params: Params, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global AABB over all primitives (unit box for an empty scene)."""
        prims = self.primitives()
        if not prims:
            one = torch.ones(3, dtype=torch.float32, device=device)
            return -one, one
        los, his = zip(*(prim.aabb(params[prim.id]) for prim in prims))
        lo = torch.amin(torch.stack(los), dim=0)
        hi = torch.amax(torch.stack(his), dim=0)
        return lo, hi

    def seeding_aabb(
        self, params: Params, device, scale: float = 1.5
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global AABB grown by `scale` for point seeding."""
        lo, hi = self.aabb(params, device)
        return scale_aabb(lo, hi, scale)
