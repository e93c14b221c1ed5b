"""The reference of full-covariance 3D Gaussians: the published projection,
then the frozen binning and fold.

Kerbl et al. 2023 (arXiv:2308.04079), written as their forward pass
writes it, in plain float32 PyTorch (TF32 off): R(q) from the normalised
quaternion (w first), Sigma = R S S^T R^T with S = diag(scales), the
camera-space Jacobian J of the perspective map at the Gaussian's centre,
W the view matrix's rotation, T = J W and Sigma' = T Sigma T^T; the screen
ellipse's axes from the eigenvalues mid +- sqrt(mid^2 - det).  The centre,
depth and culling are the frozen projector's (`render/projector.py`
beside this file, with the radius plane 2 max(s)); the words go to the
frozen binning and fold (`frame.fold_blend`), as every frame of the
benchmark does.

Where this departs from the paper (each also under the configuration's
`assumed`):

- no `1.3 tan(fov / 2)` clamp of the camera-space x/z and y/z in J;
- the 0.3 px^2 low-pass is mass-conserving: opacity is scaled by
  sqrt(det Sigma' / det(Sigma' + 0.3 I)), where the paper's rasterizer adds
  0.3 px^2 and leaves the opacity;
- the record format: the ellipse is held as its major radius (its
  standard deviation over the config's sigma, capped at r_cap, on a
  1/pos_scale px grid), the minor-axis angle on an 8-bit grid and the
  minor/major ratio on an 8-bit grid, floored at 0.05 before the low-pass;
  the profile is cut at bounds_margin radii (3 standard deviations), and
  colour and opacity are 8-bit;
- no 0.1 px^2 floor under mid^2 - det (the paper's, for its radius only).

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from .config import RenderConfig
from .frame import exact, fold_blend
from .render.binning import bin_packed_words
from .render.compositor import tiles_to_image
from .render.packing import ANGLE_SCALE, COLOR_SCALE, POS_MAX, RATIO_SCALE, depth_bits
from .render.projector import project_planes

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Rounding = Callable[[torch.Tensor], torch.Tensor]
SCALES = ("sx", "sy", "sz")
QUATERNION = ("qw", "qx", "qy", "qz")


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) R(q) of (N, 4) quaternions, w first, normalised first."""
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1e-8)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], 1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], 1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1),
    ], 1)


def covariance3d(splats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(N, 3, 3) Sigma = R S S^T R^T."""
    q = torch.stack([splats[k] for k in QUATERNION], 1)
    s = torch.stack([splats[k] for k in SCALES], 1)
    m = rotation(q) @ torch.diag_embed(s)
    return m @ m.transpose(1, 2)


def covariance2d(splats: Dict[str, torch.Tensor], view: torch.Tensor, proj: torch.Tensor,
                 rcfg: RenderConfig) -> torch.Tensor:
    """(N, 2, 2) screen covariance Sigma' = T Sigma T^T in px^2, T = J W:
    W the view's rotation, J the Jacobian of the pixel position in camera
    space (GL camera looking down -z; y down on the screen)."""
    p = torch.stack([splats["px"], splats["py"], splats["pz"]], 1)
    rot_w = view[:3, :3]
    t = p @ rot_w.T + view[:3, 3]
    zc = -t[:, 2]
    fx = 0.5 * rcfg.width * proj[0, 0]
    fy = 0.5 * rcfg.height * proj[1, 1]
    zero = torch.zeros_like(zc)
    jac = torch.stack([
        torch.stack([fx / zc, zero, fx * t[:, 0] / (zc * zc)], 1),
        torch.stack([zero, -fy / zc, -fy * t[:, 1] / (zc * zc)], 1),
    ], 1)
    tt = jac @ rot_w
    return tt @ covariance3d(splats) @ tt.transpose(1, 2)


def screen_gaussians(splats: Dict[str, torch.Tensor], camera: Dict[str, torch.Tensor],
                     rcfg: RenderConfig, rnd: Rounding = exact) -> Dict[str, torch.Tensor]:
    """The continuous screen record of each Gaussian: cx, cy, depth (+inf
    when culled), radius (0 when culled), opacity, r, g, b, angle, ratio."""
    pr = project_planes(camera["view_proj"], camera["cam_pos"], splats["px"], splats["py"],
                        splats["pz"], splats["radius"], rcfg)
    cov = rnd(covariance2d(splats, camera["view"], camera["proj"], rcfg))
    a, b, c = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - (a * c - b * b), min=0.0))
    lam_hi = torch.clamp(mid + disc, min=0.0)
    lam_lo = torch.clamp(mid - disc, min=0.0)
    # the major axis at theta (tan 2 theta = 2b / (a - c)); the minor axis a
    # quarter turn clockwise of it, in [-pi, 0]
    angle = 0.5 * torch.atan2(2.0 * b, a - c) - 0.5 * math.pi
    ratio = torch.clamp(torch.sqrt(lam_lo / lam_hi.clamp_min(1e-30)), 0.05, 1.0)
    # the major standard deviation at most sigma * r_cap, then the low-pass
    v1 = torch.clamp(lam_hi, max=(rcfg.sigma * rcfg.r_cap) ** 2)
    live = pr["valid"] & (v1 > 0)
    opacity = splats["opacity"]
    if rcfg.aa_dilation > 0 and not rcfg.opaque:
        v2 = v1 * ratio * ratio
        v1d, v2d = v1 + rcfg.aa_dilation, v2 + rcfg.aa_dilation
        opacity = torch.where(live, opacity * torch.sqrt(v1 * v2 / (v1d * v2d)), opacity)
        ratio = torch.where(live, torch.sqrt(v2d / v1d), ratio)
        v1 = v1d
    radius = torch.where(live, torch.clamp(torch.sqrt(v1) / rcfg.sigma, max=rcfg.r_cap), 0.0)
    light = torch.tensor(rcfg.light_dir, dtype=torch.float32, device=a.device)
    light = light / torch.linalg.vector_norm(light)
    n_dot_l = splats["nx"] * light[0] + splats["ny"] * light[1] + splats["nz"] * light[2]
    lamb = rcfg.light_ambient + rcfg.light_diffuse * torch.clamp(n_dot_l, min=0.0)
    return {"cx": pr["cx"], "cy": pr["cy"], "depth": pr["depth"], "radius": radius,
            "opacity": opacity, "r": splats["cr"] * lamb, "g": splats["cg"] * lamb,
            "b": splats["cb"] * lamb, "angle": angle, "ratio": ratio}


def words(splats: Dict[str, torch.Tensor], camera: Dict[str, torch.Tensor], rcfg: RenderConfig,
          rnd: Rounding = exact) -> Dict[str, torch.Tensor]:
    """The record words {dk, w_pos, w_ro, w_rgb, depth} (render/packing.py
    beside this file) of the Gaussians' screen records."""
    g = {k: rnd(v) for k, v in screen_gaussians(splats, camera, rcfg, rnd).items()}
    ps, po = rcfg.pos_scale, rcfg.pos_offset

    def grid(v, lo, hi, scale):
        return torch.round(torch.clamp(v, lo, hi) * scale).to(torch.int64)

    cx = grid(g["cx"] + po, 0.0, POS_MAX / ps, ps)
    cy = grid(g["cy"] + po, 0.0, POS_MAX / ps, ps)
    r_fx = grid(g["radius"], 0.0, POS_MAX / ps, ps)
    r8, g8, b8, op8 = (grid(g[k], 0.0, 1.0, COLOR_SCALE) for k in ("r", "g", "b", "opacity"))
    ang8 = torch.round((g["angle"] + math.pi) * ANGLE_SCALE).to(torch.int64) % 256
    ratio8 = grid(g["ratio"], 1.0 / RATIO_SCALE, 1.0, RATIO_SCALE)
    return {"dk": depth_bits(g["depth"]), "w_pos": cx | (cy << 16),
            "w_ro": r_fx | (ang8 << 16) | (ratio8 << 24),
            "w_rgb": r8 | (g8 << 8) | (b8 << 16) | (op8 << 24), "depth": g["depth"]}


def render(splats: Dict[str, torch.Tensor], camera: Dict[str, torch.Tensor], rcfg: RenderConfig,
           rnd: Rounding = exact):
    """(words, binned, image, counts) of one view of the Gaussians:
    `camera` holds view_proj, cam_pos, and the view and projection
    matrices."""
    w = words(splats, camera, rcfg, rnd)
    binned = bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], rcfg)
    color, alpha, counts = fold_blend(binned, rcfg, rnd=rnd)
    return w, binned, rnd(tiles_to_image(color, alpha, rcfg)), counts


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """An image's 8-bit output: round(clip(x, 0, 1) * 255), half to even."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
