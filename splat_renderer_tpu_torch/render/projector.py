"""Splat projection: world space -> screen space, depth, radius, appearance,
and the fixed-point record words.

Counterpart of `splat_renderer_tpu/render/projector.py`: every field is
computed for the whole (N,) batch as elementwise plane math, with the same
op sequence as the JAX package, so the quantized words come out bit-equal
(tests/test_torch_render.py).  Word arithmetic runs in int64 (see
render/packing.py for why).  `splat_screen_words` launches one CUDA kernel
for CUDA tensors (`ops/project_words.py`), which computes the plain path
`splat_screen_words_plain` per splat, bit for bit; CPU tensors take the
plain path.  Every jnp.clip/minimum/maximum that a
gradient can reach is written with `_torch_util.clip`/`minimum`/`maximum`,
which split the gradient at a bound as jnp does (`torch.clamp` would not),
so the differentiable render (render/diff.py) gets JAX's gradients.  The
grid snap in `screen_planes` has no gradient and keeps `torch.clamp`.
"""

from __future__ import annotations

import math as _math
from typing import Dict

import torch

from .._torch_util import clip, div, maximum, minimum, rdiv, sqrt_rn
from ..config import RenderConfig
from ..points.properties import COV3D_PLANES, Splats, quat_rotation
from ..utils.profiling import count, span
from .packing import (
    ANGLE_SCALE,
    COLOR_SCALE,
    INV_ANGLE_SCALE,
    INV_COLOR_SCALE,
    INV_RATIO_SCALE,
    POS_MAX,
    RATIO_SCALE,
    depth_bits,
)
from ..ops.project_words import project_words

Projected = Dict[str, torch.Tensor]


def _safe(w: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(w) < 1e-8, 1e-8, w)


def project_planes(
    view_proj: torch.Tensor,  # (4, 4)
    cam_pos: torch.Tensor,  # (3,)
    px: torch.Tensor,  # (N,)
    py: torch.Tensor,  # (N,)
    pz: torch.Tensor,  # (N,)
    radii: torch.Tensor,  # (N,)
    cfg: RenderConfig,
) -> Projected:
    """Project all splats; returns a dict of (N,) planes:

    - cx, cy: screen-space centre (pixels)
    - depth: camera-space distance; +inf for culled splats
    - radius: max screen-space radius over the 6 axial offsets +-r,
      capped at cfg.r_cap so the padded footprint fits the tile cap
    - radius_raw: the radius before the cap
    - valid: the centre and all 6 offsets lie in front of the camera
    - clip0, clip1, clip3: the centre's clip coordinates
    """
    vp = view_proj
    clip = [vp[j, 0] * px + vp[j, 1] * py + vp[j, 2] * pz + vp[j, 3]
            for j in range(4)]
    w_center = clip[3]
    safe_w = _safe(w_center)
    half_w = 0.5 * cfg.width
    half_h = 0.5 * cfg.height
    cx = (clip[0] / safe_w + 1.0) * half_w
    cy = (1.0 - clip[1] / safe_w) * half_h
    dx, dy, dz = px - cam_pos[0], py - cam_pos[1], pz - cam_pos[2]
    depth = sqrt_rn(dx * dx + dy * dy + dz * dz)

    # the 6 offsets' clip coordinates are clip_center +- r * VP_column
    screen_radius = torch.zeros_like(depth)
    valid = w_center > 1e-6
    for axis in range(3):
        col = vp[:, axis]
        for sign in (1.0, -1.0):
            sr = sign * radii
            wp = clip[3] + sr * col[3]
            valid = valid & (wp > 1e-6)
            swp = _safe(wp)
            sx = ((clip[0] + sr * col[0]) / swp + 1.0) * half_w
            sy = (1.0 - (clip[1] + sr * col[1]) / swp) * half_h
            ddx = sx - cx
            ddy = sy - cy
            screen_radius = torch.maximum(
                screen_radius, sqrt_rn(ddx * ddx + ddy * ddy)
            )
    # cap so the padded bounds box always fits tiles_per_splat_cap tiles
    radius_raw = torch.where(valid, screen_radius, 0.0)
    screen_radius = minimum(screen_radius, cfg.r_cap)
    screen_radius = torch.where(valid, screen_radius, 0.0)
    depth = torch.where(valid, depth, torch.inf)
    return {
        "cx": cx,
        "cy": cy,
        "depth": depth,
        "radius": screen_radius,
        "radius_raw": radius_raw,
        "valid": valid,
        "clip0": clip[0],
        "clip1": clip[1],
        "clip3": clip[3],
    }


def _disc_covariance(splats: Splats, j0, j1):
    """The "ewa" model's screen covariance (m00, m01, m11) of a disc of
    radius r and normal n: r^2 (J J^T - (J n)(J n)^T), J's rows j0, j1."""
    nx, ny, nz = splats["nx"], splats["ny"], splats["nz"]
    nlen = maximum(sqrt_rn(nx * nx + ny * ny + nz * nz), 1e-8)
    ux, uy, uz = nx / nlen, ny / nlen, nz / nlen
    a00 = j0[0] * j0[0] + j0[1] * j0[1] + j0[2] * j0[2]
    a01 = j0[0] * j1[0] + j0[1] * j1[1] + j0[2] * j1[2]
    a11 = j1[0] * j1[0] + j1[1] * j1[1] + j1[2] * j1[2]
    jn0 = j0[0] * ux + j0[1] * uy + j0[2] * uz
    jn1 = j1[0] * ux + j1[1] * uy + j1[2] * uz
    r2 = splats["radius"] * splats["radius"]
    return r2 * (a00 - jn0 * jn0), r2 * (a01 - jn0 * jn1), r2 * (a11 - jn1 * jn1)


def _gaussian_covariance(splats: Splats, j0, j1):
    """The "cov3d" model's screen covariance (m00, m01, m11) of a 3D
    Gaussian: J Sigma J^T with Sigma = R(q) S S^T R(q)^T, taken as
    (J R S)(J R S)^T, whose columns u_k = (J R)[:, k] s_k are the screen
    images of the Gaussian's scaled axes.  Raises ValueError on splats
    without `COV3D_PLANES`."""
    missing = [k for k in COV3D_PLANES if k not in splats]
    if missing:
        raise ValueError(f'ellipse="cov3d" needs the splat planes {missing} '
                         "(points.gaussian_splats, utils.ply.load_ply(covariance=True))")
    rot = quat_rotation(splats["qw"], splats["qx"], splats["qy"], splats["qz"])
    u0, u1 = [], []
    for k, s in enumerate((splats["sx"], splats["sy"], splats["sz"])):
        u0.append((j0[0] * rot[0][k] + j0[1] * rot[1][k] + j0[2] * rot[2][k]) * s)
        u1.append((j1[0] * rot[0][k] + j1[1] * rot[1][k] + j1[2] * rot[2][k]) * s)
    m00 = u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2]
    m01 = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2]
    m11 = u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]
    return m00, m01, m11


def shade_planes(
    splats: Splats,
    view_proj: torch.Tensor,  # (4, 4)
    cam_pos: torch.Tensor,  # (3,)
    cfg: RenderConfig,
) -> Dict[str, torch.Tensor]:
    """Projection + appearance as continuous (N,) planes: {cx, cy, radius,
    opacity, r, g, b, depth, angle, ratio}.

    Lighting: colour * (ambient + diffuse * max(dot(n, L), 0)).
    Oriented profiles: "foreshorten" puts the minor axis along the
    normal's screen projection with minor/major = |n . view|; "ewa" takes
    the eigendecomposition of the disc's perspective screen covariance
    M = r^2 (J J^T - (J n)(J n)^T); "cov3d" that of a 3D Gaussian's
    M = J Sigma J^T (`COV3D_PLANES`), with radius sqrt(lam_hi) / sigma so
    the profile's standard deviation is the Gaussian's (J: the world-space
    Jacobian of the screen position; no clamp of the view angle).
    cfg.aa_dilation adds a pixel low-pass to Gaussian profiles with
    opacity scaled to conserve mass.
    """
    proj = project_planes(
        view_proj, cam_pos,
        splats["px"], splats["py"], splats["pz"], splats["radius"], cfg,
    )
    nx, ny, nz = splats["nx"], splats["ny"], splats["nz"]

    light = torch.tensor(cfg.light_dir, dtype=nx.dtype, device=nx.device)
    light = light / sqrt_rn(torch.sum(light * light))
    diffuse = maximum(nx * light[0] + ny * light[1] + nz * light[2], 0.0)
    lamb = cfg.light_ambient + cfg.light_diffuse * diffuse

    ell_radius = proj["radius"]
    if cfg.oriented and cfg.ellipse in ("ewa", "cov3d"):
        vp = view_proj
        w = proj["clip3"]
        sw = _safe(w)
        inv_w2 = rdiv(1.0, sw * sw)
        half_w = 0.5 * cfg.width
        half_h = 0.5 * cfg.height
        # J rows: d sx / dp_k = Wh (vp0k w - clip0 vp3k)/w^2,
        #         d sy / dp_k = -Hh (vp1k w - clip1 vp3k)/w^2
        j0 = [half_w * (vp[0, k] * w - proj["clip0"] * vp[3, k]) * inv_w2
              for k in range(3)]
        j1 = [-half_h * (vp[1, k] * w - proj["clip1"] * vp[3, k]) * inv_w2
              for k in range(3)]
        if cfg.ellipse == "ewa":
            m00, m01, m11 = _disc_covariance(splats, j0, j1)
        else:
            m00, m01, m11 = _gaussian_covariance(splats, j0, j1)
        # closed-form 2x2 symmetric eigendecomposition
        half_tr = 0.5 * (m00 + m11)
        half_df = 0.5 * (m00 - m11)
        root = sqrt_rn(half_df * half_df + m01 * m01)
        lam_hi = maximum(half_tr + root, 0.0)
        lam_lo = maximum(half_tr - root, 0.0)
        major = sqrt_rn(lam_hi)
        minor = sqrt_rn(lam_lo)
        # minor-axis direction = eigenvector of lam_lo: (m01, lam_lo - m00)
        angle = torch.atan2(lam_lo - m00, m01)
        # a Gaussian's major standard deviation is sigma * radius
        major_c = minimum(div(major, cfg.sigma) if cfg.ellipse == "cov3d" else major,
                          cfg.r_cap)
        ell_radius = torch.where(proj["valid"], major_c, 0.0)
        ratio = clip(minor / maximum(major, 1e-8), 0.05, 1.0)
    elif cfg.oriented:
        vx = splats["px"] - cam_pos[0]
        vy = splats["py"] - cam_pos[1]
        vz = splats["pz"] - cam_pos[2]
        vn = maximum(sqrt_rn(vx * vx + vy * vy + vz * vz), 1e-8)
        cos_view = (nx * vx + ny * vy + nz * vz) / vn
        # tip = position + radius * normal, projected with the same clip
        # algebra as the 6-offset radius (clip_tip = clip + r*(VP @ n))
        r = splats["radius"]
        vp = view_proj
        tc0 = proj["clip0"] + r * (vp[0, 0] * nx + vp[0, 1] * ny + vp[0, 2] * nz)
        tc1 = proj["clip1"] + r * (vp[1, 0] * nx + vp[1, 1] * ny + vp[1, 2] * nz)
        tc3 = proj["clip3"] + r * (vp[3, 0] * nx + vp[3, 1] * ny + vp[3, 2] * nz)
        stw = _safe(tc3)
        tip_x = (tc0 / stw + 1.0) * (0.5 * cfg.width)
        tip_y = (1.0 - tc1 / stw) * (0.5 * cfg.height)
        angle = torch.atan2(tip_y - proj["cy"], tip_x - proj["cx"])
        ratio = clip(torch.abs(cos_view), 0.05, 1.0)
    else:
        angle = torch.zeros_like(nx)
        ratio = torch.ones_like(nx)

    opacity = splats["opacity"]
    if cfg.aa_dilation > 0.0 and not cfg.opaque:
        s2 = cfg.sigma * cfg.sigma
        lam1 = s2 * ell_radius * ell_radius
        lam2 = lam1 * ratio * ratio
        lam1d = lam1 + cfg.aa_dilation
        lam2d = lam2 + cfg.aa_dilation
        alive = ell_radius > 0.0  # never resurrect culled splats
        opacity = torch.where(
            alive, opacity * sqrt_rn((lam1 / lam1d) * (lam2 / lam2d)), opacity
        )
        # re-cap: the dilated major axis may exceed r_cap
        ell_radius = torch.where(
            alive, minimum(sqrt_rn(div(lam1d, s2)), cfg.r_cap), 0.0
        )
        ratio = torch.where(alive, sqrt_rn(lam2d / lam1d), ratio)

    return {
        "cx": proj["cx"],
        "cy": proj["cy"],
        "radius": ell_radius,
        "opacity": opacity,
        "r": splats["cr"] * lamb,
        "g": splats["cg"] * lamb,
        "b": splats["cb"] * lamb,
        "depth": proj["depth"],
        "angle": angle,
        "ratio": ratio,
    }


def screen_planes(
    splats: Splats,
    view_proj: torch.Tensor,  # (4, 4)
    cam_pos: torch.Tensor,  # (3,)
    cfg: RenderConfig,
) -> Dict[str, torch.Tensor]:
    """Projection + appearance snapped onto the record grids: cx_fx, cy_fx,
    r_fx (1/pos_scale px), op8/r8/g8/b8/ang8/ratio8 (u8 grids), as int64,
    plus depth (f32).  Clip, then round half to even, as jnp does."""
    c = shade_planes(splats, view_proj, cam_pos, cfg)
    ps, po = cfg.pos_scale, cfg.pos_offset
    i64 = lambda v: torch.round(v).to(torch.int64)
    # the grid snap has no gradient: torch.clamp, one launch per clip
    q = lambda v: i64(torch.clamp((v + po) * ps, 0, POS_MAX))
    c8 = lambda v: i64(torch.clamp(v, 0.0, 1.0) * COLOR_SCALE)
    return {
        "cx_fx": q(c["cx"]),
        "cy_fx": q(c["cy"]),
        "r_fx": i64(torch.clamp(c["radius"] * ps, 0, POS_MAX)),
        "op8": c8(c["opacity"]),
        "r8": c8(c["r"]),
        "g8": c8(c["g"]),
        "b8": c8(c["b"]),
        "ang8": i64((c["angle"] + _math.pi) * ANGLE_SCALE) % 256,
        "ratio8": i64(torch.clamp(c["ratio"], 1.0 / RATIO_SCALE, 1.0) * RATIO_SCALE),
        "depth": c["depth"],
    }


@span("project")
def splat_screen_words(
    splats: Splats,
    view_proj: torch.Tensor,
    cam_pos: torch.Tensor,
    cfg: RenderConfig,
) -> Dict[str, torch.Tensor]:
    """Projection + appearance straight to the packed record words
    (render/packing.py layout), as int64 tensors holding u32 values.

    Returns {"dk", "w_pos", "w_ro", "w_rgb", "depth"}.  For CUDA planes
    one launch of the projector kernel (`ops/project_words.py`; it raises
    on inputs it does not take), counted in `ops/build.py`'s `launches`;
    for CPU planes `splat_screen_words_plain`."""
    if splats["px"].device.type == "cpu":
        return splat_screen_words_plain(splats, view_proj, cam_pos, cfg)
    return project_words(splats, view_proj, cam_pos, cfg)


def count_cov3d(words: Dict[str, torch.Tensor], cfg: RenderConfig) -> None:
    """The counters of one "cov3d" projection's words, for a caller that
    checked `enabled()`: `cov3d_splats` its N Gaussians (a host number),
    `cov3d_live` its records with a radius (a culled record has 0), and
    `cov3d_capped` those whose radius sits at r_cap on the record's grid:
    the Gaussians whose major standard deviation (after the low-pass) the
    record format clamps at sigma * r_cap.  Device sums: nothing is read
    back."""
    r_fx = words["w_ro"] & 0xFFFF
    count("cov3d_splats", torch.tensor(r_fx.shape[0]))
    count("cov3d_live", (r_fx > 0).sum())
    count("cov3d_capped", (r_fx >= round(cfg.r_cap * cfg.pos_scale)).sum())


def splat_screen_words_plain(
    splats: Splats,
    view_proj: torch.Tensor,
    cam_pos: torch.Tensor,
    cfg: RenderConfig,
) -> Dict[str, torch.Tensor]:
    """`splat_screen_words` as plane operations, on any device: the
    kernel's twin."""
    c = screen_planes(splats, view_proj, cam_pos, cfg)
    return {
        "dk": depth_bits(c["depth"]),
        "w_pos": c["cx_fx"] | (c["cy_fx"] << 16),
        "w_ro": c["r_fx"] | (c["ang8"] << 16) | (c["ratio8"] << 24),
        "w_rgb": c["r8"] | (c["g8"] << 8) | (c["b8"] << 16) | (c["op8"] << 24),
        "depth": c["depth"],
    }


def splat_screen_records(
    splats: Splats,
    view_proj: torch.Tensor,
    cam_pos: torch.Tensor,
    cfg: RenderConfig,
) -> torch.Tensor:
    """The (N, 10) render record [cx, cy, radius, opacity, r, g, b, depth,
    angle, ratio] on the grids' exact values (dequantized by multiply),
    for the oracle."""
    c = screen_planes(splats, view_proj, cam_pos, cfg)
    inv_ps, po = 1.0 / cfg.pos_scale, cfg.pos_offset
    f = lambda v: v.to(torch.float32)
    return torch.stack(
        [
            f(c["cx_fx"]) * inv_ps - po,
            f(c["cy_fx"]) * inv_ps - po,
            f(c["r_fx"]) * inv_ps,
            f(c["op8"]) * INV_COLOR_SCALE,
            f(c["r8"]) * INV_COLOR_SCALE,
            f(c["g8"]) * INV_COLOR_SCALE,
            f(c["b8"]) * INV_COLOR_SCALE,
            c["depth"],
            f(c["ang8"]) * INV_ANGLE_SCALE - _math.pi,
            f(c["ratio8"]) * INV_RATIO_SCALE,
        ],
        dim=-1,
    )
