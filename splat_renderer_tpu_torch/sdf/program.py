"""The CSG tree as a program: what the modeler's CUDA kernels read.

`program_for(scene)` flattens the scene's tree into a postfix `Program` of
(code, offset) pairs, once per structure (every node's class and id): a
primitive's code pushes its (distance, gradient), an operation's pops two
and pushes their combination, and the offset points into one float32
parameter block.
Of an operation's two subtrees the one needing the deeper evaluation stack
is emitted first (Sethi-Ullman order), so a tree of L leaves needs at most
log2(L) + 1 slots; an operation whose right subtree came first carries
`SWAPPED` in its code, and the kernels hand it its operands back in the
tree's order.
`pack_params(program, params)` packs a frame's `params` dict into that
block in the tree's walk order, on the tensors' device, with no read-back.
The kernels (`csrc/sdf_model.cu`, through `ops/sdf_model.py`) walk the
program the way `SDFScene.sdf` walks the tree.

A tree the kernels cannot evaluate flattens to None: an empty scene, a node
of a class the table below does not name (a subclass included), an
operation with fewer than two children, or one needing a deeper evaluation
stack than `STACK_LIMIT` (2**16 leaves at the least).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from .ops import (
    Intersection,
    SmoothIntersection,
    SmoothSubtraction,
    SmoothUnion,
    Subtraction,
    Union,
)
from .primitives import Box, Capsule, Cylinder, Ellipsoid, Primitive, RoundBox, Sphere, Torus
from .scene import OpNode, Params, SDFScene

# each node class's parameters, in the order the kernel reads them
PRIMITIVES = {
    Sphere: ("center", "radius"),
    Box: ("center", "size"),
    Torus: ("center", "major", "minor"),
    Capsule: ("center", "height", "radius"),
    Cylinder: ("center", "height", "radius"),
    Ellipsoid: ("center", "radii"),
    RoundBox: ("center", "size", "rounding"),
}
OPERATIONS = {
    Union: (),
    Intersection: (),
    Subtraction: (),
    SmoothUnion: ("k",),
    SmoothIntersection: ("k",),
    SmoothSubtraction: ("k",),
}
PARAMS_OF = {**PRIMITIVES, **OPERATIONS}
# the kernel's Code enum: the primitives, then the operations
CODES = {cls: i for i, cls in enumerate([*PRIMITIVES, *OPERATIONS])}
# floats a parameter takes; every other key is a scalar
WIDTHS = {"center": 3, "size": 3, "radii": 3}
# on an operation's code: its right subtree was emitted first (csrc kSwapped)
SWAPPED = 1 << 8
# the deepest evaluation stack the kernels hold (csrc kStack)
STACK_LIMIT = 16
CACHE_SIZE = 8


@dataclasses.dataclass(frozen=True)
class Program:
    """A flattened tree.  `code`: the postfix (code, offset) pairs;
    `bounds`: a (code, offset) pair per `scene.primitives()` entry, for the
    seeding box; `layout`: the block's (node id, key, width) runs in order;
    `size`: the block's floats; `depth`: the deepest stack it needs."""

    code: Tuple[Tuple[int, int], ...]
    bounds: Tuple[Tuple[int, int], ...]
    layout: Tuple[Tuple[str, str, int], ...]
    size: int
    depth: int
    # the words on each device they were copied to (ops/sdf_model.py)
    on_device: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def words(self) -> List[int]:
        """The int32 words the kernels read: `code`'s pairs, then
        `bounds`'."""
        return [v for pair in self.code + self.bounds for v in pair]


def flatten(scene: SDFScene) -> Optional[Program]:
    """`scene`'s tree as a Program, or None where the kernels cannot
    evaluate it (module docstring)."""
    root = scene._root
    if root is None:
        return None
    layout: List[Tuple[str, str, int]] = []
    owners: Dict[str, Tuple[type, int]] = {}  # node id -> (class, offset)
    size = 0

    def offset(node_id: str, cls: type, keys: Tuple[str, ...]) -> Optional[int]:
        nonlocal size
        if node_id in owners:
            seen, at = owners[node_id]
            return at if PARAMS_OF[seen] == keys else None
        owners[node_id] = (cls, size)
        at = size
        for key in keys:
            width = WIDTHS.get(key, 1)
            layout.append((node_id, key, width))
            size += width
        return at

    def walk(node) -> Optional[Tuple[List[Tuple[int, int]], int]]:
        """The subtree's code and the stack it needs, or None."""
        cls = type(node)
        if isinstance(node, Primitive):
            at = offset(node.id, cls, PRIMITIVES[cls]) if cls in PRIMITIVES else None
            return None if at is None else ([(CODES[cls], at)], 1)
        if not isinstance(node, OpNode):
            return None
        op_cls = type(node.operation)
        if op_cls not in OPERATIONS or len(node.children) < 2:
            return None
        left, right = walk(node.children[0]), walk(node.children[1])
        if left is None or right is None:
            return None
        keys = OPERATIONS[op_cls]
        at = offset(node.operation.id, op_cls, keys) if keys else 0
        if at is None:
            return None
        (l_code, l_need), (r_code, r_need) = left, right
        if r_need > l_need:  # the right first: the left then needs one slot more, no deeper
            return r_code + l_code + [(CODES[op_cls] | SWAPPED, at)], r_need
        return l_code + r_code + [(CODES[op_cls], at)], max(l_need, r_need + 1)

    flat = walk(root)
    if flat is None or flat[1] > STACK_LIMIT:
        return None
    code, depth = flat
    bounds = []
    for prim in scene.primitives():
        owner = owners.get(prim.id)
        if owner is None or PARAMS_OF.get(type(prim)) != PARAMS_OF[owner[0]]:
            return None
        bounds.append((CODES[type(prim)], owner[1]))
    return Program(tuple(code), tuple(bounds), tuple(layout), size, depth)


_programs: "OrderedDict[tuple, Optional[Program]]" = OrderedDict()
_programs_lock = threading.Lock()  # a served engine renders on its own thread


def _structure(node) -> tuple:
    """The tree's node classes and ids, operations' included: what a
    program depends on."""
    if isinstance(node, OpNode):
        op = node.operation
        return (type(op), getattr(op, "id", None), *(_structure(c) for c in node.children))
    return (type(node), getattr(node, "id", None))


def program_for(scene: SDFScene) -> Optional[Program]:
    """`flatten(scene)`, kept per structure (the latest CACHE_SIZE
    structures), so a frame at a seen structure flattens nothing.  The key
    is every node's class and id: `SDFScene.structure_hash()` names kinds,
    which a subclass inherits, and leaves the operations' ids out."""
    key = _structure(scene._root)
    with _programs_lock:
        if key in _programs:
            _programs.move_to_end(key)
            return _programs[key]
        program = flatten(scene)
        while len(_programs) >= CACHE_SIZE:
            _programs.popitem(last=False)
        _programs[key] = program
        return program


def pack_params(program: Program, params: Params) -> torch.Tensor:
    """The frame's parameters as one block in `program.layout`'s order, on
    the parameters' device and of their dtype: one concatenation, no
    read-back.
    Raises ValueError where a parameter is not of its width."""
    parts = []
    for node_id, key, width in program.layout:
        t = params[node_id][key]
        if t.numel() != width:
            raise ValueError(f"params[{node_id!r}][{key!r}] has {t.numel()} values, "
                             f"expected {width}")
        parts.append(t.reshape(width))
    return torch.cat(parts)
