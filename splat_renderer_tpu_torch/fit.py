"""Inverse rendering: fit splat fields to target images by gradient descent.

Counterpart of `splat_renderer_tpu/fit.py`.  Each step renders every view
through `render/diff.py` (method "kernel": the CUDA forward and backward
kernels on CUDA tensors), takes the gradient of the mean per-view loss with
autograd, and applies Adam.  The Adam update is optax's, written out
(`adam_init`/`adam_update`): bias-corrected moments, eps outside the square
root, the same float32 op order, and a state dict ({count, mu, nu}) that
checkpoints as plain tensors.  Random draws (density control's jitter) come
from a `torch.Generator`, whose state is part of the checkpoint.
`fit_splats_dp` splits the views over the ranks of a `parallel.Mesh`
(torch.distributed).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ._torch_util import check_device, clip, div, maximum, minimum, sqrt_rn
from .camera import CameraArrays, Camera, orbit_camera_arrays
from .config import RenderConfig
from .points.properties import Splats
from .render.diff import render_diff, render_diff_gbuffer
from .render.sh import apply_sh
from .utils.profiling import span
from .utils.snapshot import checkpoint_file, load_pytree, save_pytree
from .utils.ssim import image_loss

FIT_FIELDS_APPEARANCE = ("cr", "cg", "cb", "opacity")
FIT_FIELDS_GEOMETRY = ("px", "py", "pz", "radius")
DENSIFY_FIELDS = ("px", "py", "pz", "radius", "opacity")

Params = Dict[str, torch.Tensor]


def adam_init(theta: Params) -> Dict:
    """optax.adam's state: a step count and zeroed first and second moments."""
    device = next(iter(theta.values())).device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": {k: torch.zeros_like(v) for k, v in theta.items()},
        "nu": {k: torch.zeros_like(v) for k, v in theta.items()},
    }


@span("fit/adam")
def adam_update(
    theta: Params, grads: Params, state: Dict, lr: float,
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> Tuple[Params, Dict]:
    """One optax.adam step, op for op:
    mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;
    theta += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)."""
    count = state["count"] + 1
    f32 = dict(dtype=torch.float32, device=count.device)
    bc1 = 1 - torch.tensor(b1, **f32) ** count
    bc2 = 1 - torch.tensor(b2, **f32) ** count
    mu, nu, out = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - b1) * g + b1 * state["mu"][k]
        nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
        upd = (mu[k] / bc1) / (sqrt_rn(nu[k] / bc2) + eps)
        out[k] = theta[k] + (-lr) * upd
    return out, {"count": count, "mu": mu, "nu": nu}


def render_targets(
    splats: Splats,
    cameras: Sequence[CameraArrays],
    cfg: RenderConfig,
    method: str = "kernel",
    sh=None,
) -> Tuple[torch.Tensor, ...]:
    """One target image per camera through the differentiable render (for
    synthetic fits and tests); `sh` lights each view (render/sh.py)."""
    with torch.no_grad():
        return tuple(
            render_diff(apply_sh(splats, sh, c["cam_pos"]) if sh is not None else splats,
                        c, cfg, method=method)
            for c in cameras
        )


def _loss_and_grads(theta, splats, sh_fixed, fit_sh, cameras, targets, cfg, method,
                    loss_img, depth_targets=None, depth_weight=0.2):
    """The mean per-view loss of `theta` over the views and its gradient
    (a dict keyed like theta); the step of fit_splats and fit_splats_dp."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    s = dict(splats, **{k: v for k, v in leaves.items() if ":" not in k})
    sh_cur = {c: leaves[f"sh:{c}"] for c in ("r", "g", "b")} if fit_sh else sh_fixed
    per_view = []
    for i, (cam, t) in enumerate(zip(cameras, targets)):
        s_v = apply_sh(s, sh_cur, cam["cam_pos"]) if sh_cur is not None else s
        if depth_targets is not None:
            gb = render_diff_gbuffer(s_v, cam, cfg, method=method)
            with span("fit/loss"):
                l_v = loss_img(gb["rgb"], t)
                dt = depth_targets[i]
                mask = (dt > 0.0).to(torch.float32)
                l_v = l_v + depth_weight * torch.sum(
                    torch.abs(gb["depth"] - dt) * mask) / maximum(torch.sum(mask), 1.0)
        else:
            img = render_diff(s_v, cam, cfg, method=method)
            with span("fit/loss"):
                l_v = loss_img(img, t)
        per_view.append(l_v)
    loss_val = div(sum(per_view), len(per_view))
    with span("fit/backward"):
        grads = torch.autograd.grad(loss_val, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
    return loss_val.detach(), dict(zip(leaves, grads))


def fit_splats(
    splats: Splats,
    cameras: Sequence[CameraArrays],
    targets: Sequence[torch.Tensor],
    cfg: RenderConfig,
    fields: Sequence[str] = FIT_FIELDS_APPEARANCE,
    steps: int = 100,
    lr: float = 3e-2,
    method: str = "kernel",
    loss: str = "l2",
    init: Optional[Params] = None,
    log_every: int = 0,
    densify_every: int = 0,
    densify_threshold: float = 1e-5,
    prune_opacity: float = 0.005,
    clone_radius: Optional[float] = None,
    opacity_reset_every: int = 0,
    opacity_reset_value: float = 0.01,
    generator: Optional[torch.Generator] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    sh=None,
    fit_sh: bool = False,
    depth_targets: Optional[Sequence[torch.Tensor]] = None,
    depth_weight: float = 0.2,
):
    """Optimise `fields` of `splats` so renders match `targets` (Adam).

    As the JAX package's fit_splats: `loss` is "l2", "l1" or "ssim" (the
    3DGS L1/D-SSIM mix); cameras/targets pair up (a joint multi-view fit);
    `init` overrides a field's starting value.  densify_every > 0 runs
    `density_control` every that many steps on the accumulated
    positional-gradient score (needs DENSIFY_FIELDS in `fields`; resets the
    Adam state).  opacity_reset_every > 0 clamps live opacities down to
    opacity_reset_value (Kerbl et al. 2023 sec. 5.2).  checkpoint_path +
    checkpoint_every write the whole training state (theta, Adam state,
    splats, score, generator state, step, losses) to one .npz; resume=True
    restarts from it, step for step identical to an uninterrupted run.
    `sh` lights every view through apply_sh; fit_sh=True also optimises the
    coefficients.  depth_targets adds depth_weight * mean over target
    depth > 0 of |depth - target| per view, rendered as a G-buffer.

    Returns (fitted splats, (steps,) losses) [+ fitted sh if fit_sh].
    """
    if len(cameras) != len(targets):
        raise ValueError("cameras and targets must pair up")
    if depth_targets is not None:
        if len(depth_targets) != len(cameras):
            raise ValueError("depth_targets must pair up with cameras")
        if method == "oracle":
            raise ValueError("depth supervision renders the G-buffer: use "
                             "method='kernel' or 'tiles'")
    if not fields and not fit_sh:
        raise ValueError("nothing to fit: fields is empty")
    if fit_sh and sh is None:
        raise ValueError("fit_sh=True needs an initial sh coefficient dict")
    if densify_every and not set(DENSIFY_FIELDS) <= set(fields):
        raise ValueError(f"densify_every needs fields to include {DENSIFY_FIELDS}")

    loss_img = image_loss(loss)
    device = splats["radius"].device
    theta = {k: (init[k] if init and k in init else splats[k]).detach().clone() for k in fields}
    if fit_sh:
        # "sh:" keeps coefficient rows apart from splat planes in one dict
        theta.update({f"sh:{c}": sh[c].detach().clone() for c in ("r", "g", "b")})
    opt_state = adam_init(theta)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def step(theta, opt_state, splats, sh_fixed):
        with span("fit/step"):
            loss_val, grads = _loss_and_grads(theta, splats, sh_fixed, fit_sh, cameras,
                                              targets, cfg, method, loss_img, depth_targets,
                                              depth_weight)
            pos_g = (torch.abs(grads["px"]) + torch.abs(grads["py"]) + torch.abs(grads["pz"])
                     if densify_every else None)
            theta, opt_state = adam_update(theta, grads, opt_state, lr)
            return loss_val, theta, opt_state, pos_g

    losses = []
    score = torch.zeros(splats["radius"].shape if densify_every else (), device=device)
    start = 0
    sh_fixed = None if fit_sh else sh
    ckpt_sh = sh_fixed is not None  # fixed coefficients are training state
    if checkpoint_path and resume:
        import os

        if os.path.exists(checkpoint_file(checkpoint_path)):
            tpl = {
                "theta": theta, "opt_state": opt_state, "splats": dict(splats),
                "score": score, "generator": generator.get_state(),
                "step": torch.zeros((), dtype=torch.int32), "losses": torch.zeros((0,)),
            }
            if ckpt_sh:
                tpl["sh"] = dict(sh_fixed)
            try:
                st = load_pytree(checkpoint_path, tpl)
            except KeyError as e:
                raise ValueError(
                    f"checkpoint {checkpoint_path!r} is incompatible with this fit "
                    f"(different fields/loss/densify settings?): missing leaf {e}"
                ) from e
            for k in theta:
                if st["theta"][k].shape != theta[k].shape:
                    raise ValueError(
                        f"checkpoint {checkpoint_path!r} is incompatible: theta[{k!r}] "
                        f"has shape {tuple(st['theta'][k].shape)}, this fit needs "
                        f"{tuple(theta[k].shape)}"
                    )
            start = int(st["step"])
            if start > steps:
                raise ValueError(
                    f"checkpoint {checkpoint_path!r} already holds {start} steps > "
                    f"requested steps={steps}; raise steps or start fresh (resume=False)"
                )
            theta, opt_state = st["theta"], st["opt_state"]
            splats, score = st["splats"], st["score"]
            generator.set_state(st["generator"])
            losses = [v.to(device) for v in st["losses"].unbind(0)]
            if ckpt_sh:
                sh_fixed = st["sh"]

    for i in range(start, steps):
        loss_val, theta, opt_state, pos_g = step(theta, opt_state, splats, sh_fixed)
        losses.append(loss_val)
        if densify_every:
            score = score + pos_g
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"fit step {i:4d}  {loss} {float(loss_val):.3e}")
        if densify_every and (i + 1) % densify_every == 0 and i + 1 < steps:
            theta_f = {k: v for k, v in theta.items() if ":" not in k}
            sh_cur = {c: theta[f"sh:{c}"] for c in ("r", "g", "b")} if fit_sh else sh_fixed
            res = density_control(
                dict(splats, **theta_f), div(score, densify_every), generator,
                densify_threshold, prune_opacity, sh=sh_cur, clone_radius=clone_radius,
            )
            merged, stats = res[0], res[-1]
            splats = merged
            theta = {k: merged[k] for k in fields}
            if fit_sh:
                theta.update({f"sh:{c}": res[1][c] for c in ("r", "g", "b")})
            elif sh_cur is not None:
                sh_fixed = res[1]
            opt_state = adam_init(theta)  # the population changed: fresh moments
            score = torch.zeros_like(score)
            if log_every:
                print(f"  densify @{i + 1}: split {int(stats['split'])}, "
                      f"cloned {int(stats['cloned'])}, pruned {int(stats['pruned'])}, "
                      f"live {int(stats['live'])}")
        if (opacity_reset_every and (i + 1) % opacity_reset_every == 0
                and i + 1 < steps and "opacity" in theta):
            theta = dict(theta, opacity=minimum(theta["opacity"], opacity_reset_value))
            opt_state = adam_init(theta)  # the parameter jumped: fresh moments
            if log_every:
                print(f"  opacity reset @{i + 1} -> <= {opacity_reset_value}")
        if checkpoint_path and checkpoint_every and (
            (i + 1) % checkpoint_every == 0 or i + 1 == steps
        ):
            state = {
                "theta": theta, "opt_state": opt_state, "splats": dict(splats),
                "score": score, "generator": generator.get_state(),
                "step": torch.tensor(i + 1, dtype=torch.int32),
                "losses": torch.stack(losses),
            }
            if ckpt_sh:
                state["sh"] = dict(sh_fixed)
            save_pytree(checkpoint_path, state)
    fitted = dict(splats, **{k: v for k, v in theta.items() if ":" not in k})
    if fit_sh:
        return fitted, torch.stack(losses), {c: theta[f"sh:{c}"] for c in ("r", "g", "b")}
    return fitted, torch.stack(losses)


def fit_splats_dp(
    splats: Splats,
    cameras: CameraArrays,  # tensors with a leading view axis V (orbit_ring format)
    targets: torch.Tensor,  # (V, H, W, 3)
    mesh,  # parallel.Mesh: every rank is one flat view axis
    cfg: RenderConfig,
    fields: Sequence[str] = FIT_FIELDS_APPEARANCE,
    steps: int = 100,
    lr: float = 3e-2,
    method: str = "kernel",
    loss: str = "l2",
    init: Optional[Params] = None,
    sh=None,
    fit_sh: bool = False,
):
    """Multi-view fit with the views split over the mesh's ranks: gradient
    data parallelism.  Called on every rank with the same arguments.

    Each rank renders and differentiates its V / size views (method
    "kernel": the CUDA forward and backward kernels on CUDA tensors), the
    mean loss of its views and its gradients go through one all_reduce
    SUM, divided by the rank count (JAX's pmean: over equal view counts the
    mean of the ranks' means is the global mean), and every rank applies
    the same Adam update to its replica of theta, which therefore stays
    bit-identical across ranks.  On one rank the loss and theta are those
    of `fit_splats` over the same views, bit for bit.  `sh`/`fit_sh` as in
    fit_splats.  Returns (splats, (steps,) losses) [+ fitted sh if fit_sh],
    the same on every rank."""
    import torch.distributed as dist

    from .render.multiview import camera_at

    world = mesh.size
    v = targets.shape[0]
    if v % world:
        raise ValueError(f"view count {v} must divide over {world} devices")
    if not fields and not fit_sh:
        raise ValueError("nothing to fit: fields is empty")
    if fit_sh and sh is None:
        raise ValueError("fit_sh=True needs an initial sh coefficient dict")
    check_device(mesh.device, targets=targets, **{f"splats[{k!r}]": t for k, t in splats.items()})
    loss_img = image_loss(loss)
    vl = v // world
    views = range(mesh.rank * vl, (mesh.rank + 1) * vl)
    cams = [camera_at(cameras, i) for i in views]
    tgts = [targets[i] for i in views]
    theta = {k: (init[k] if init and k in init else splats[k]).detach().clone() for k in fields}
    if fit_sh:
        theta.update({f"sh:{c}": sh[c].detach().clone() for c in ("r", "g", "b")})
    sh_fixed = None if fit_sh else sh
    opt_state = adam_init(theta)
    losses = []
    for _ in range(steps):
        with span("fit/step"):
            loss_val, grads = _loss_and_grads(theta, splats, sh_fixed, fit_sh, cams, tgts, cfg,
                                              method, loss_img)
            flat = torch.cat([loss_val.reshape(1)] + [grads[k].reshape(-1) for k in theta])
            dist.all_reduce(flat, group=mesh.group)
            flat = div(flat, world)
            parts = flat[1:].split([t.numel() for t in theta.values()])
            grads = {k: g.reshape(theta[k].shape) for k, g in zip(theta, parts)}
            theta, opt_state = adam_update(theta, grads, opt_state, lr)
            losses.append(flat[0])
    fitted = dict(splats, **{k: v_ for k, v_ in theta.items() if ":" not in k})
    if fit_sh:
        return fitted, torch.stack(losses), {c: theta[f"sh:{c}"] for c in ("r", "g", "b")}
    return fitted, torch.stack(losses)


def psnr(mse: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio of an MSE (images in [0, 1])."""
    return -10.0 * torch.log10(maximum(mse, 1e-12))


def fit_camera(
    splats: Splats,
    pose_init: Dict,
    target: torch.Tensor,
    cfg: RenderConfig,
    steps: int = 100,
    lr: float = 1e-2,
    method: str = "tiles",
    loss: str = "l2",
    fov_deg: float = 45.0,
) -> Tuple[Params, torch.Tensor]:
    """Recover the orbit pose {"azimuth", "elevation", "distance", "target"}
    that produced `target` by gradient descent through the render (pose
    registration); needs pose_init in the basin of convergence.  Returns
    the fitted pose and the loss curve."""
    loss_img = image_loss(loss)
    device = splats["px"].device
    aspect = cfg.width / cfg.height
    pose = {k: torch.as_tensor(v, dtype=torch.float32, device=device).clone()
            for k, v in pose_init.items()}
    opt_state = adam_init(pose)
    losses = []
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in pose.items()}
        cam = orbit_camera_arrays(leaves, fov_deg=fov_deg, aspect=aspect)
        val = loss_img(render_diff(splats, cam, cfg, method=method), target)
        grads = dict(zip(leaves, torch.autograd.grad(val, list(leaves.values()))))
        pose, opt_state = adam_update(pose, grads, opt_state, lr)
        # the Camera's interaction clamps: crossing the pole collapses the
        # look-at basis, and distance through 0 flips the camera
        pose["elevation"] = clip(pose["elevation"], -Camera.MAX_ELEVATION, Camera.MAX_ELEVATION)
        pose["distance"] = clip(pose["distance"], Camera.MIN_DISTANCE, Camera.MAX_DISTANCE)
        losses.append(val.detach())
    return pose, torch.stack(losses)


def density_control(
    splats: Splats,
    score: torch.Tensor,  # (N,) accumulated positional-gradient magnitude
    generator: torch.Generator,
    densify_threshold: float,
    prune_opacity: float = 0.005,
    split_factor: float = 1.6,
    jitter: float = 0.5,
    sh=None,
    clone_radius: Optional[float] = None,
):
    """One 3DGS adaptive-density event at a fixed splat count N.

    A dead slot has radius 0 and opacity 0.  Live splats with opacity <
    prune_opacity die.  Live splats whose score exceeds densify_threshold
    reproduce: the i-th best candidate copies into the i-th free slot
    (stable sorts, so ties keep index order); candidates beyond the free
    pool wait.  Candidates with radius > clone_radius (None = the live-
    radius mean) SPLIT, original and copy both shrunk by split_factor;
    smaller ones CLONE at full size.  Every copy's position is jittered by
    jitter * its radius * a normal draw from `generator`.  `sh` coefficient
    columns move with their splats.

    Returns (splats, stats {pruned, split, cloned, live}), with the new sh
    between them when `sh` is given.
    """
    n = score.shape[0]
    device = score.device
    radius, opacity = splats["radius"], splats["opacity"]
    live = radius > 0.0
    prune = live & (opacity < prune_opacity)
    keep = live & ~prune
    free = ~keep

    cand = keep & (score > densify_threshold)
    iota = torch.arange(n, device=device)
    cand_idx = torch.sort(torch.where(cand, -score, torch.inf), stable=True).indices
    free_idx = torch.sort(torch.where(free, iota, n), stable=True).indices
    k_live = torch.minimum(cand.sum(), free.sum())
    pair_ok = iota < k_live
    src = torch.where(pair_ok, cand_idx, 0)
    dst = free_idx[pair_ok]

    out = dict(splats)
    out["radius"] = torch.where(prune, 0.0, radius)
    out["opacity"] = torch.where(prune, 0.0, opacity)
    if clone_radius is None:
        n_keep = torch.clamp(keep.sum(), min=1)
        clone_thr = torch.sum(torch.where(keep, radius, 0.0)) / n_keep
    else:
        clone_thr = torch.tensor(clone_radius, dtype=radius.dtype, device=device)
    is_big = radius > clone_thr
    split_src = pair_ok & is_big[src]
    split_mask = torch.zeros(n, dtype=torch.bool, device=device)
    split_mask[src[split_src]] = True
    out["radius"] = torch.where(split_mask, div(out["radius"], split_factor), out["radius"])
    noise = torch.randn((3, n), generator=generator, device=device)
    for f in list(out):
        vals = out[f][src]  # post-shrink values of the candidates
        if f in ("px", "py", "pz"):
            vals = vals + jitter * out["radius"][src] * noise[("px", "py", "pz").index(f)]
        out[f] = out[f].clone()
        out[f][dst] = vals[pair_ok]
    n_split = split_src.sum()
    stats = {
        "pruned": prune.sum(),
        "split": n_split,
        "cloned": k_live - n_split,
        "live": (out["radius"] > 0.0).sum(),
    }
    if sh is not None:
        sh_out = {}
        for ch, coeff in sh.items():
            c = torch.where(prune[None, :], 0.0, coeff)
            vals = c[:, src]
            c = c.clone()
            c[:, dst] = vals[:, pair_ok]
            sh_out[ch] = c
        return out, sh_out, stats
    return out, stats
