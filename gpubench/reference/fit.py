"""The reference fit step: loss, gradients and Adam, in plain PyTorch.

One step renders the SH-lit splats through the differentiable render
(`projector.shade_planes`, `binning.bin_planes_diff`), folds every tile's
run front to back one record position at a time for all tiles at once
(the forward's function: w = a T, C += rgb w, T *= 1 - a, a pixel taking
nothing more once T is exactly 0), takes the 3DGS L1/D-SSIM loss of the
image and its gradient with respect to the tiles' colour and alpha by
autograd, and runs the blend's adjoint back to front: with R what follows
a record seen through it and Q the product of 1 - a behind it,
dL/da_i = T_i (w_i - R_i + gA Q_i), chained to the record planes term for
term as the port's plain mirror of its backward does.  Autograd carries
the planes' gradient back through the gather, the projector and SH to the
fitted fields.  Isotropic Gaussian profile only.  The update is optax's
Adam, op for op.

`rnd` is the control's hook (see `frame.py`): it rounds the lit colours,
the planes, the fold's running sums and the adjoint's to bfloat16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ._torch_util import clip, div, maximum, minimum, rdiv, sqrt_rn
from .config import RenderConfig
from .frame import CHUNK, Rounding, exact, run_positions
from .render.binning import bin_planes_diff
from .render.compositor import tiles_to_image
from .render.projector import shade_planes
from .render.sh import apply_sh
from .utils.ssim import image_loss

ALPHA_CAP = 1.0 - 1e-7
PLANE_NAMES = ("cx", "cy", "radius", "opacity", "r", "g", "b", "angle", "ratio", "depth")


def planes_of(splats, sh, camera, cfg: RenderConfig, rnd: Rounding = exact):
    """The render's continuous record planes of the SH-lit splats."""
    lit = apply_sh(splats, sh, camera["cam_pos"])
    lit = dict(lit, **{k: rnd(lit[k]) for k in ("cr", "cg", "cb")})
    c = shade_planes(lit, camera["view_proj"], camera["cam_pos"], cfg)
    c01 = lambda v: clip(v, 0.0, 1.0)  # noqa: E731
    vals = (c["cx"], c["cy"], c["radius"], c01(c["opacity"]), c01(c["r"]), c01(c["g"]),
            c01(c["b"]), c["angle"], c["ratio"], c["depth"])
    return {k: rnd(v) for k, v in zip(PLANE_NAMES, vals)}


def _alpha(cfg: RenderConfig, rec, px, py):
    """The forward's alpha of each (record, pixel) and what the adjoint
    chains through."""
    cx, cy, r, op = rec[..., 0:1], rec[..., 1:2], rec[..., 2:3], rec[..., 3:4]
    dx = px - cx
    dy = py - cy
    dist2 = dx * dx + dy * dy
    scale2 = r * r
    inv_s2 = rdiv(1.0, maximum(scale2, 1e-12))
    margin2 = cfg.bounds_margin * cfg.bounds_margin
    inside = (r >= cfg.min_screen_radius) & (dist2 <= margin2 * scale2)
    nd2 = dist2 * inv_s2
    neg = -0.5 / (cfg.sigma * cfg.sigma)
    shape = torch.where(inside, torch.exp(neg * nd2), 0.0)
    a_raw = op * shape
    return dict(dx=dx, dy=dy, r=r, op=op, scale2=scale2, inv_s2=inv_s2, inside=inside, nd2=nd2,
                neg=neg, shape=shape, a_raw=a_raw, a=minimum(a_raw, ALPHA_CAP))


def render_and_grad(binned, cfg: RenderConfig, loss_of=None, rnd: Rounding = exact):
    """(loss, image, grad of binned["planes"] in rank order, counts): the
    forward fold, the loss of its image, and the blend's adjoint (skipped,
    with loss and grad None, where loss_of is None).  The alphas of CHUNK
    record positions are evaluated together; the fold and the adjoint's
    recurrences stay sequential.

    counts: "evals" (record, pixel) evaluations up to each pixel's stop at
    T = 0, "inside" those inside the support, "pairs" and "records" that
    some pixel still alive reads."""
    if cfg.oriented:
        raise ValueError("the reference fit covers the isotropic profile")
    planes = binned["planes"].detach()
    nf = planes.shape[1]
    device = planes.device
    num_tiles, tp, tw = cfg.num_tiles, cfg.tile_pixels, cfg.tile_w
    offsets = binned["offsets"].to(torch.int64)
    counts = offsets[1:] - offsets[:-1]
    order = torch.sort(counts, descending=True, stable=True).indices
    cnt = counts[order]
    left = cnt.tolist()
    lane = torch.arange(tp, device=device)
    px = ((order % cfg.tiles_x) * tw).to(torch.float32)[:, None] + (
        (lane % tw).to(torch.float32) + 0.5)
    py = ((order // cfg.tiles_x) * cfg.tile_h).to(torch.float32)[:, None] + (
        (lane // tw).to(torch.float32) + 0.5)
    f32 = dict(dtype=torch.float32, device=device)
    color = torch.zeros((num_tiles, tp, 3), **f32)
    trans = torch.ones((num_tiles, tp), **f32)
    chunks = []  # (k0, m, ranks, valid, T before each position)
    evals = torch.zeros((), dtype=torch.int64, device=device)
    inside_n = torch.zeros_like(evals)
    pairs = torch.zeros_like(evals)
    read = torch.zeros(planes.shape[0], dtype=torch.int32, device=device)
    max_c = left[0] if left else 0
    m = num_tiles

    def chunk_alpha(rank, valid, m):
        al = _alpha(cfg, planes[rank], px[:m][None], py[:m][None])
        # past a tile's run: alpha 0, which leaves T and the sums as they are
        al["a"] = rnd(torch.where(valid[:, :, None], al["a"], 0.0))
        al["inside"] = al["inside"] & valid[:, :, None]
        return al

    for k0 in range(0, max_c, CHUNK):
        while left[m - 1] <= k0:
            m -= 1
        kk = min(CHUNK, max_c - k0)
        rank, valid = run_positions(offsets, k0, kk, order[:m], cnt[:m], binned["pair_rank"])
        al = chunk_alpha(rank, valid, m)
        a = al["a"]
        rgb_k = planes[rank][:, :, 4:7]
        t_hist = torch.empty_like(a)
        t, c = trans[:m], color[:m]
        for j in range(kk):
            t_hist[j] = t
            c = rnd(c + rgb_k[j][:, None, :] * (a[j] * t)[:, :, None])
            t = rnd(t * (1.0 - a[j]))
        trans[:m], color[:m] = t, c
        live = (t_hist > 0.0) & valid[:, :, None]
        evals += live.sum()
        inside_n += (live & al["inside"]).sum()
        any_live = live.any(2)
        pairs += any_live.sum()
        read.scatter_reduce_(0, rank.reshape(-1), any_live.reshape(-1).to(torch.int32), "amax")
        chunks.append((m, rank, valid, t_hist))
    stats = {"evals": int(evals), "inside": int(inside_n), "pairs": int(pairs),
             "records": int(read.sum())}
    back = torch.empty_like(order)
    back[order] = torch.arange(num_tiles, device=device)
    if loss_of is None:
        return None, tiles_to_image(color[back], 1.0 - trans[back], cfg), None, stats
    tile_color = color[back].requires_grad_(True)
    tile_alpha = (1.0 - trans[back]).requires_grad_(True)
    image = tiles_to_image(tile_color, tile_alpha, cfg)
    loss = loss_of(image)
    g_color, g_alpha = torch.autograd.grad(loss, (tile_color, tile_alpha))
    g_color, g_alpha = g_color[order], g_alpha[order]

    grads = torch.zeros_like(planes)
    r_acc = torch.zeros((num_tiles, tp), **f32)
    q_acc = torch.ones((num_tiles, tp), **f32)
    for m, rank, valid, t_hist in reversed(chunks):
        al = chunk_alpha(rank, valid, m)
        a = al["a"]
        kk = a.shape[0]
        gc, ga = g_color[:m][None], g_alpha[:m][None]
        rec = planes[rank]  # (kk, m, nf)
        w_pan = ((rec[:, :, 4:5] * gc[..., 0] + rec[:, :, 5:6] * gc[..., 1])
                 + rec[:, :, 6:7] * gc[..., 2])
        r_hist, q_hist = torch.empty_like(a), torch.empty_like(a)
        r, q = r_acc[:m], q_acc[:m]
        for j in range(kk - 1, -1, -1):  # what follows each record, back to front
            r_hist[j], q_hist[j] = r, q
            r = rnd(w_pan[j] * a[j] + (1.0 - a[j]) * r)
            q = rnd(q * (1.0 - a[j]))
        r_acc[:m], q_acc[:m] = r, q
        g_a = t_hist * ((w_pan - r_hist) + ga * q_hist)
        g_prod = torch.where(al["inside"] & (al["a_raw"] < ALPHA_CAP), g_a, 0.0)
        g_nd2 = ((g_prod * al["op"]) * al["neg"]) * al["shape"]
        g_dist2 = g_nd2 * al["inv_s2"]
        at = torch.where(al["inside"], a * t_hist, 0.0)
        s2 = (g_nd2 * al["nd2"]).sum(2)
        alive = (al["scale2"][..., 0] > 1e-12).to(torch.float32)
        rows = torch.zeros((kk, m, nf), **f32)
        rows[:, :, 0] = ((g_dist2 * -2.0) * al["dx"]).sum(2)
        rows[:, :, 1] = ((g_dist2 * -2.0) * al["dy"]).sum(2)
        rows[:, :, 2] = ((s2 * -2.0) * alive) / maximum(al["r"][..., 0], 1e-9)
        rows[:, :, 3] = (g_prod * al["shape"]).sum(2)
        for ch in range(3):
            rows[:, :, 4 + ch] = (gc[..., ch] * at).sum(2)
        rows = torch.where(valid[:, :, None], rnd(rows), 0.0)
        grads.index_add_(0, rank.reshape(-1), rows.reshape(-1, nf))
    return loss.detach(), image.detach(), grads, stats


def loss_and_grads(theta: Dict[str, torch.Tensor], splats, camera, target, cfg: RenderConfig,
                   loss: str = "ssim", rnd: Rounding = exact):
    """(loss, {leaf: gradient}, counts) of one view at `theta` (fitted
    splat fields and "sh:r|g|b" rows)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in theta.items()}
    s = dict(splats, **{k: v for k, v in leaves.items() if ":" not in k})
    sh = {c: leaves[f"sh:{c}"] for c in ("r", "g", "b")}
    planes = planes_of(s, sh, camera, cfg, rnd)
    binned = bin_planes_diff(planes, cfg)
    img_loss = image_loss(loss)
    val, _, g_planes, stats = render_and_grad(binned, cfg, lambda img: img_loss(img, target),
                                              rnd)
    torch.autograd.backward(binned["planes"], g_planes)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}
    return div(val, 1), grads, stats


def render_image(splats, sh, camera, cfg: RenderConfig) -> torch.Tensor:
    """The forward image of the SH-lit splats (the fit's target)."""
    with torch.no_grad():
        binned = bin_planes_diff(planes_of(splats, sh, camera, cfg), cfg)
    return render_and_grad(binned, cfg)[1]


def adam_update(theta, grads, state, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> Tuple[Dict, Dict]:
    """optax.adam, op for op."""
    count = state["count"] + 1
    f32 = dict(dtype=torch.float32, device=count.device)
    bc1 = 1 - torch.tensor(b1, **f32) ** count
    bc2 = 1 - torch.tensor(b2, **f32) ** count
    mu, nu, out = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - b1) * g + b1 * state["mu"][k]
        nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
        out[k] = theta[k] + (-lr) * ((mu[k] / bc1) / (sqrt_rn(nu[k] / bc2) + eps))
    return out, {"count": count, "mu": mu, "nu": nu}


def adam_init(theta):
    device = next(iter(theta.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: torch.zeros_like(v) for k, v in theta.items()},
            "nu": {k: torch.zeros_like(v) for k, v in theta.items()}}


def fit_steps(theta, splats, camera, target, cfg: RenderConfig, steps: int, lr: float,
              loss: str = "ssim", rnd: Rounding = exact):
    """The first `steps` steps from `theta`: (losses, first step's
    gradients, theta after the last step)."""
    state = adam_init(theta)
    losses, first = [], None
    for i in range(steps):
        val, grads, _ = loss_and_grads(theta, splats, camera, target, cfg, loss, rnd)
        if i == 0:
            first = grads
        theta, state = adam_update(theta, grads, state, lr)
        theta = {k: rnd(v) for k, v in theta.items()}
        losses.append(float(val))
    return losses, first, theta
