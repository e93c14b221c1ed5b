"""Shared splat evaluation + front-to-back blending math.

Counterpart of `splat_renderer_tpu/render/blend.py`: the single definition
of what one splat contributes to one pixel, used by the oracle and the plain
tile compositor, and re-derived in the CUDA kernel
(csrc/tile_blend.cu) with the same op sequence.

The support cutoff `dist2 <= margin2 * scale2` is a hard threshold: one ulp
of difference in `dist2` flips a pixel's alpha by about 0.011.  So the
cutoff is all-multiply, the trig is a fixed polynomial, and no expression
here may be contracted into a fused multiply-add (eager PyTorch never does;
the kernel is built with `-fmad=false`).  The differentiable render
(render/diff.py) runs through `splat_alpha_planes`, so its bounds use
`_torch_util.maximum`, whose gradient at a tie is jnp's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._torch_util import maximum, rdiv
from ..config import RenderConfig


def ellipse_cos_sin(angle: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of the quantized ellipse angle by a FIXED polynomial (IEEE
    mul/add chains give the same bits on every backend; libm `cos`/`sin` do
    not).  |err| < 3.1e-7 on [-pi, pi]."""
    x = angle  # in [-pi, pi] from the u8 grid
    x2 = x * x
    s = x * (
        9.999997070e-01
        + x2 * (
            -1.666657722e-01
            + x2 * (
                8.332558118e-03
                + x2 * (-1.981257552e-04 + x2 * (2.704051213e-06 + x2 * -2.053424453e-08))
            )
        )
    )
    c = 9.999999923e-01 + x2 * (
        -4.999999177e-01
        + x2 * (
            4.166652436e-02
            + x2 * (
                -1.388797039e-03
                + x2 * (2.477342375e-05 + x2 * (-2.711336876e-07 + x2 * 1.736911667e-09))
            )
        )
    )
    return c, s


def splat_alpha_planes(
    cx: torch.Tensor,
    cy: torch.Tensor,
    radius: torch.Tensor,
    opacity: torch.Tensor,
    angle: torch.Tensor,
    ratio: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    cfg: RenderConfig,
) -> torch.Tensor:
    """Per-(splat, pixel) alpha from broadcastable per-field planes.

    - splats with screen radius < cfg.min_screen_radius contribute nothing;
    - Gaussian: opacity * exp(-0.5 (d/r)^2 / sigma^2) inside the disc
      d <= bounds_margin * r;
    - cfg.oriented: d is measured in the splat's screen-ellipse frame
      (rotate by -angle, the component along the angle scaled by 1/ratio,
      written ratio-multiplied so the cutoff stays divide-free);
    - cfg.opaque: hard coverage inside the ellipse; with cfg.quad, inside
      the square of the ellipse's half-extents.
    """
    dx = px - cx
    dy = py - cy
    big_enough = radius >= cfg.min_screen_radius
    if cfg.oriented:
        rr = maximum(ratio, 1e-3)
        ca, sa = ellipse_cos_sin(angle)
        u = ca * dx + sa * dy
        vr = (-sa * dx + ca * dy) * rr
        dist2 = u * u + vr * vr
        scale = radius * rr
    else:
        # isotropic: no rotation (a rotated distance differs by ulps and
        # flips pixels across the cutoff)
        dist2 = dx * dx + dy * dy
        scale = radius

    scale2 = scale * scale
    # exp argument only: one record-scale coefficient
    coef = rdiv(-0.5 / (cfg.sigma * cfg.sigma), maximum(scale2, 1e-12))
    margin2 = cfg.bounds_margin * cfg.bounds_margin
    if cfg.opaque and cfg.quad:
        if cfg.oriented:
            inside = (u * u <= scale2) & (vr * vr <= scale2)
        else:
            inside = (dx * dx <= scale2) & (dy * dy <= scale2)
        shape = inside.to(dist2.dtype)
    elif cfg.opaque:
        shape = (dist2 <= scale2).to(dist2.dtype)
    else:
        shape = torch.where(dist2 <= margin2 * scale2, torch.exp(dist2 * coef), 0.0)
    return torch.where(big_enough, opacity * shape, 0.0)


def segmented_exclusive_product(
    values: torch.Tensor,  # (n, ...) per-element factors (e.g. 1 - alpha)
    starts: torch.Tensor,  # (n,) bool, True where a new segment begins
) -> torch.Tensor:
    """Exclusive running product within contiguous segments along dim 0:
    out[i] = prod(values[j] for j in segment(i), j < i).

    An inclusive Hillis-Steele scan of the right-shifted values with
    segment-reset flags: exact products, no log/exp round trip."""
    n = values.shape[0]
    bshape = (n,) + (1,) * (values.ndim - 1)
    shifted = torch.cat([torch.ones_like(values[:1]), values[:-1]], dim=0)
    v = torch.where(starts.reshape(bshape), 1.0, shifted)
    f = starts
    k = 1
    while k < n:
        # (f_a, v_a) (+) (f_b, v_b) = (f_a | f_b, v_b if f_b else v_a * v_b)
        fb = f[k:]
        v = torch.cat([v[:k], torch.where(fb.reshape((-1,) + bshape[1:]), v[k:], v[:-k] * v[k:])])
        f = torch.cat([f[:k], fb | f[:-k]])
        k *= 2
    return v


def over_merge(
    color_a: torch.Tensor,
    alpha_a: torch.Tensor,
    color_b: torch.Tensor,
    alpha_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two premultiplied (color (..., 3), alpha (...)) layers with A in
    front of B: the associative 'over' fold that combines depth-ordered
    partial composites, such as the depth bands of `parallel/band.py`."""
    t_a = 1.0 - alpha_a
    return color_a + t_a[..., None] * color_b, alpha_a + t_a * alpha_b


def composite_over_background(
    color: torch.Tensor, alpha: torch.Tensor, cfg: RenderConfig
) -> torch.Tensor:
    """final = accumulated + bg * (1 - alpha)."""
    bg = torch.tensor(cfg.background, dtype=color.dtype, device=color.device)
    return color + bg * (1.0 - alpha)[..., None]
