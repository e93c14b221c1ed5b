"""View-dependent splat colour: real spherical-harmonics appearance.

Counterpart of `splat_renderer_tpu/render/sh.py`.  Coefficients are a
`{"r"|"g"|"b": (n_rest, N)}` dict of float32 row planes per channel (3, 8
or 15 rest coefficients for degree 1, 2 or 3; the DC band lives in the
base colour), evaluated along the camera -> splat direction as elementwise
plane math.  The basis is the real SH of 3DGS in its coefficient order.
`apply_sh` launches one CUDA kernel (`ops/sh_colors.py`) for CUDA tensors
through which no gradient can flow; it computes the plain path
`apply_sh_plain` per splat, bit for bit.  The CPU and autograd take the
plain path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .._torch_util import clip
from ..ops.sh_colors import PLANES, sh_colors
from ..points.properties import Splats
from ..utils.profiling import span

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

# added to the squared camera -> splat distance before its rsqrt
SQ_LENGTH_FLOOR = 1e-20
# the scalars above as the SH kernel takes them (csrc/sh_colors.cu Consts)
KERNEL_SCALARS = (-SH_C1, SH_C1, *SH_C2, *SH_C3, SQ_LENGTH_FLOOR)

_REST_PER_DEGREE = {0: 0, 1: 3, 2: 8, 3: 15}

SHCoeffs = Dict[str, torch.Tensor]


def sh_degree(sh: Optional[SHCoeffs]) -> int:
    """The SH degree from the coefficient row count (0 for None)."""
    if sh is None:
        return 0
    rows = int(sh["r"].shape[0])
    for deg, n in _REST_PER_DEGREE.items():
        if n == rows:
            return deg
    raise ValueError(
        f"sh coefficient rows {rows} is not a complete SH band set "
        f"(expected one of {sorted(_REST_PER_DEGREE.values())})"
    )


def sh_basis_planes(
    dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor, degree: int
) -> Tuple[torch.Tensor, ...]:
    """Real SH basis planes (bands 1..degree) for unit directions, in 3DGS
    coefficient order (band-major); the DC band is excluded."""
    if degree not in _REST_PER_DEGREE:
        raise ValueError(f"unsupported SH degree {degree} (max 3)")
    out = []
    if degree >= 1:
        out += [-SH_C1 * dy, SH_C1 * dz, -SH_C1 * dx]
    if degree >= 2:
        xx, yy, zz = dx * dx, dy * dy, dz * dz
        xy, yz, xz = dx * dy, dy * dz, dx * dz
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            SH_C3[0] * dy * (3.0 * xx - yy),
            SH_C3[1] * xy * dz,
            SH_C3[2] * dy * (4.0 * zz - xx - yy),
            SH_C3[3] * dz * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * dx * (4.0 * zz - xx - yy),
            SH_C3[5] * dz * (xx - yy),
            SH_C3[6] * dx * (xx - 3.0 * yy),
        ]
    return tuple(out)


def kernel_takes(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether the SH kernel takes a call on these inputs: every one on
    CUDA, and no gradient can flow (grad mode off, or no input requires
    one).  Reads no device value."""
    return (all(t.is_cuda for t in tensors)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)))


@span("sh")
def apply_sh(
    splats: Splats, sh: Optional[SHCoeffs], cam_pos: torch.Tensor,
    degree: Optional[int] = None,
) -> Splats:
    """View-dependent colour for one camera position: new splats whose
    cr/cg/cb are clip(base + sum_k basis_k(dir) * coeff_k, 0, 1), dir the
    unit vector from the camera to the splat.  `sh=None` (or degree 0)
    only clips the base colour; `degree` truncates the bands evaluated.
    On CUDA inputs through which no gradient can flow (`kernel_takes`),
    one launch of the SH kernel (`ops/sh_colors.py`; it raises on inputs
    it does not take), counted in `ops/build.py`'s `launches`; otherwise
    `apply_sh_plain`."""
    full = sh_degree(sh)
    degree = full if degree is None else min(degree, full)
    if degree > 0 and kernel_takes(
            [*(splats[k] for k in PLANES), sh["r"], sh["g"], sh["b"], cam_pos]):
        return sh_colors(splats, sh, cam_pos, degree, KERNEL_SCALARS)
    return apply_sh_plain(splats, sh, cam_pos, degree)


def apply_sh_plain(
    splats: Splats, sh: Optional[SHCoeffs], cam_pos: torch.Tensor,
    degree: Optional[int] = None,
) -> Splats:
    """`apply_sh` as plane operations, on any device and under autograd."""
    full = sh_degree(sh)
    degree = full if degree is None else min(degree, full)
    out = dict(splats)
    if degree <= 0 or sh is None:
        for ch in ("cr", "cg", "cb"):
            out[ch] = clip(splats[ch], 0.0, 1.0)
        return out
    dx = splats["px"] - cam_pos[0]
    dy = splats["py"] - cam_pos[1]
    dz = splats["pz"] - cam_pos[2]
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + SQ_LENGTH_FLOOR)
    basis = sh_basis_planes(dx * inv, dy * inv, dz * inv, degree)
    for ch, field in (("r", "cr"), ("g", "cg"), ("b", "cb")):
        c = splats[field]
        coeff = sh[ch]
        for k, b in enumerate(basis):
            c = c + b * coeff[k]
        out[field] = clip(c, 0.0, 1.0)
    return out
