"""The bytes the projector's kernel (`csrc/project_words.cu`) must move for one call: the planes
it reads, each at its own element stride, and the words and depth it writes.  The helper of
`project_roofline.batch`, beside it; not a metric."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

# the planes every ellipse model reads, and those only "cov3d" reads
PLANES = ("px", "py", "pz", "radius", "cr", "cg", "cb", "opacity", "nx", "ny", "nz")
COV3D = ("sx", "sy", "sz", "qw", "qx", "qy", "qz")
SECTOR = 32  # bytes the memory moves at least for a load


def read_bytes(planes: Dict[str, torch.Tensor], names=PLANES + COV3D) -> int:
    """The bytes of memory the reads of one call touch: the planes are
    grouped by the storage they view (the modeler's columns share one
    (N, 3) tensor), and a group costs the span of memory its rows cover,
    or at most a 32-byte sector for each element it reads."""
    groups = defaultdict(list)
    for k in names:
        t = planes[k]
        groups[t.untyped_storage().data_ptr()].append(t)
    total = 0
    for ts in groups.values():
        n, size = ts[0].shape[0], ts[0].element_size()
        starts = [t.storage_offset() for t in ts]
        stride = max(t.stride(0) for t in ts)
        span = ((n - 1) * stride + max(starts) - min(starts) + 1) * size
        total += min(span, len(ts) * n * SECTOR)
    return total


def write_bytes(n: int) -> int:
    """Four int64 words and a float32 depth a splat."""
    return n * (4 * 8 + 4)


def call_bytes(planes: Dict[str, torch.Tensor]) -> int:
    return read_bytes(planes) + write_bytes(planes["px"].shape[0])
