"""Dataset IO: load multi-view training data from disk for inverse rendering.

Counterpart of `splat_renderer_tpu/data.py`, reading the same files: a
datagen run writes PNGs + a manifest.json (camera matrices per frame,
optional 16-bit depth / alpha G-buffer channels); this loads them back as
the (cameras, targets) pairs `fit.fit_splats` consumes, as float32 tensors
on the device the caller names.  Decoding and back-projection are host-side
numpy; tensors are made at the very end.

Layout (datagen.py's output):
    <dir>/manifest.json        {"frames": [...], "width", "height", "fov_deg"}
    <dir>/stepNNN_viewVV.png   8-bit RGB target
    <dir>/..._depth.png        16-bit grayscale, per-frame affine in manifest
    <dir>/..._alpha.png        16-bit grayscale coverage

PNG decode is stdlib-only (utils/image.read_png) and threaded across frames
(zlib releases the GIL).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ._torch_util import to_numpy
from .utils.image import load_image, read_png


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def load_dataset(
    path: str,
    step: Optional[int] = None,
    gbuffer: bool = False,
    max_workers: int = 8,
    *,
    device,
) -> Dict:
    """Load a datagen-produced dataset directory.

    Directories without a manifest.json fall through to the NeRF-standard
    transforms.json layout (load_transforms) when one is present, so
    `load_dataset` opens both this engine's own datasets and the public
    NVS-dataset format.

    step: keep only frames of that animation step (None = all — fine for
    static scenes; animated datasets should fit one step's geometry at a
    time).  gbuffer=True also loads depth (denormalized to metric camera
    distance via the manifest's per-frame affine; 0 where alpha ~ 0) and
    alpha channels when the manifest has them.

    Returns {"cameras": [ {view_proj (4,4), cam_pos (3,)} ... ],
             "images": [ (H, W, 3) f32 ... ],
             "depth": [ (H, W) f32 ... ] | None,
             "alpha": [ (H, W) f32 ... ] | None,
             "width", "height", "fov_deg", "frames" (manifest rows)} —
    cameras/images are parallel lists in manifest order, ready for
    fit_splats(cameras=..., targets=...); stack_views() turns them into the
    stacked (V, ...) form render_views uses.  Tensors are float32 on
    `device`.
    """
    if not os.path.exists(os.path.join(path, "manifest.json")):
        for name in ("transforms.json", "transforms_train.json"):
            if os.path.exists(os.path.join(path, name)):
                if step is not None or gbuffer:
                    raise ValueError(
                        "step/gbuffer filters apply to manifest.json "
                        "datasets only"
                    )
                return load_transforms(os.path.join(path, name),
                                       max_workers=max_workers, device=device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    frames = manifest["frames"]
    if step is not None:
        frames = [fr for fr in frames if fr.get("step") == step]
    if not frames:
        raise ValueError(f"{path}: no frames" + (f" for step {step}" if step
                                                 is not None else ""))
    want_gb = gbuffer and all("depth_file" in fr for fr in frames)
    if gbuffer and not want_gb:
        raise ValueError(
            f"{path}: gbuffer=True but the manifest has no depth channels "
            "(generate with datagen.py --gbuffer)"
        )

    def one(fr):
        img = load_image(os.path.join(path, fr["file"]))
        if not want_gb:
            return img, None, None
        alpha = read_png(os.path.join(path, fr["alpha_file"])).astype(
            np.float32
        ) / np.float32(65535.0)
        dn = read_png(os.path.join(path, fr["depth_file"])).astype(
            np.float32
        ) / np.float32(65535.0)
        lo, hi = fr["depth_min"], fr["depth_max"]
        depth = np.where(alpha > 1e-6, dn * (hi - lo) + lo, 0.0).astype(
            np.float32
        )
        return img, depth, alpha

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        loaded = list(pool.map(one, frames))

    cameras = [
        {
            "view_proj": _t(fr["view_proj"], device),
            "cam_pos": _t(fr["cam_pos"], device),
        }
        for fr in frames
    ]
    return {
        "cameras": cameras,
        "images": [_t(im, device) for im, _, _ in loaded],
        "depth": [_t(d, device) for _, d, _ in loaded] if want_gb else None,
        "alpha": [_t(a, device) for _, _, a in loaded] if want_gb else None,
        "width": manifest["width"],
        "height": manifest["height"],
        "fov_deg": manifest.get("fov_deg", 45.0),
        "frames": frames,
    }


def load_transforms(
    json_path: str,
    bg=(1.0, 1.0, 1.0),
    max_workers: int = 8,
    *,
    device,
) -> Dict:
    """Load a NeRF-standard ``transforms.json`` dataset (the NeRF-synthetic
    / nerfstudio interchange format — what public NVS training sets and
    3DGS tooling ship) into the same structure load_dataset returns.

    Supported intrinsics: ``camera_angle_x`` (Blender exports) or
    ``fl_x``/``fl_y`` (nerfstudio; the principal point must be centered —
    off-center cx/cy raise).  Extrinsics: per-frame ``transform_matrix`` is
    camera-to-world in the OpenGL convention (camera looks along -Z, +Y
    up) — exactly this engine's camera convention (camera.py::look_at), so
    view = inv(c2w) and view_proj = perspective(fov) @ view with no basis
    flip.  RGBA images composite over ``bg`` (white, the NeRF-synthetic
    standard); the source alpha rides along as the dataset's "alpha"
    channel (a coverage mask for losses), depth is None.
    """
    with open(json_path) as f:
        meta = json.load(f)
    root = os.path.dirname(os.path.abspath(json_path))
    frames = meta["frames"]
    if not frames:
        raise ValueError(f"{json_path}: no frames")

    def img_path(fr):
        p = os.path.join(root, fr["file_path"])
        if not os.path.splitext(p)[1]:
            p += ".png"  # NeRF-synthetic file_paths are extensionless
        return p

    def one(fr):
        arr = read_png(img_path(fr))
        scale = np.float32(
            1.0 / (65535.0 if arr.dtype == np.uint16 else 255.0)
        )
        x = arr.astype(np.float32) * scale
        if x.ndim == 2:
            x = np.repeat(x[:, :, None], 3, axis=2)
        alpha = None
        if x.shape[2] == 4:
            alpha = x[:, :, 3]
            x = x[:, :, :3] * alpha[:, :, None] + np.asarray(
                bg, np.float32
            ) * (1.0 - alpha[:, :, None])
        elif x.shape[2] == 2:
            alpha = x[:, :, 1]
            x = np.repeat(x[:, :, :1], 3, axis=2)
        return x, alpha

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        loaded = list(pool.map(one, frames))
    h, w = loaded[0][0].shape[:2]

    # intrinsics -> vertical fov (our perspective() parameterization)
    fw = meta.get("w", w)
    fh = meta.get("h", h)
    if "camera_angle_x" in meta:
        tan_x = np.tan(0.5 * float(meta["camera_angle_x"]))
    elif "fl_x" in meta:
        for k, c in (("cx", fw / 2), ("cy", fh / 2)):
            if k in meta and abs(float(meta[k]) - c) > 0.01 * c:
                raise ValueError(
                    f"{json_path}: off-center principal point ({k}) is "
                    "not supported"
                )
        tan_x = fw / (2.0 * float(meta["fl_x"]))
    else:
        raise ValueError(f"{json_path}: no camera_angle_x or fl_x intrinsics")
    tan_y = tan_x * fh / fw
    fov_y = 2.0 * np.arctan(tan_y)

    from .camera import perspective

    proj = perspective(float(fov_y), w / h, 0.1, 100.0).astype(np.float64)
    cameras = []
    for fr in frames:
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        view = np.linalg.inv(c2w)
        cameras.append({
            "view_proj": _t(proj @ view, device),
            "cam_pos": _t(c2w[:3, 3], device),
        })
    has_alpha = all(a is not None for _, a in loaded)
    return {
        "cameras": cameras,
        "images": [_t(im, device) for im, _ in loaded],
        "depth": None,
        "alpha": [_t(a, device) for _, a in loaded] if has_alpha else None,
        "width": w,
        "height": h,
        "fov_deg": float(np.degrees(fov_y)),
        "frames": frames,
    }


def backproject_gbuffer(
    dataset: Dict,
    n_max: Optional[int] = None,
    alpha_min: float = 0.5,
    opacity: float = 0.7,
    radius_scale: float = 1.5,
    seed: int = 0,
    *,
    device,
) -> Dict:
    """Lift a G-buffer dataset into a splat point cloud — the initialization
    3DGS gets from SfM points (Kerbl et al. 2023 sec. 4), recovered here
    from the dataset's own depth/alpha channels instead of an external
    reconstruction.  Feed the result to fit.fit_splats as the starting
    splats for training against the same dataset's images.

    Per view, every pixel with alpha > alpha_min unprojects along its
    camera ray to the recorded camera DISTANCE (the projector's depth
    convention, render/projector.py:66): p = cam + dir * depth.  The ray
    direction comes from the inverted view_proj at two NDC depths, so the
    math holds for any z convention.  Normals are central differences of
    the world-position raster (oriented toward the camera); colors are the
    pixel colors (lambert-lit — appearance fitting refines them); radius
    is the world footprint of one pixel at that depth
    (depth * 2 tan(fov/2) / H) * radius_scale, so neighboring splats just
    overlap.  Views are concatenated; n_max subsamples uniformly.

    Returns the standard 11-plane splat pytree (points/properties.py
    PLANE_FIELDS).  Host-side numpy (init-time file data); returns
    float32 tensors on `device`.
    """
    if dataset.get("depth") is None:
        raise ValueError("backproject_gbuffer needs a gbuffer=True dataset")
    h, w = int(dataset["height"]), int(dataset["width"])
    pix_angle = 2.0 * np.tan(np.radians(dataset["fov_deg"]) * 0.5) / h
    planes = {k: [] for k in
              ("px", "py", "pz", "nx", "ny", "nz", "cr", "cg", "cb",
               "radius")}
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ndc_x = (xs + 0.5) * (2.0 / w) - 1.0
    ndc_y = 1.0 - (ys + 0.5) * (2.0 / h)
    ones = np.ones_like(ndc_x)
    for cam, img, depth, alpha in zip(
        dataset["cameras"], dataset["images"], dataset["depth"],
        dataset["alpha"],
    ):
        vp_inv = np.linalg.inv(to_numpy(cam["view_proj"]).astype(np.float64))
        cpos = to_numpy(cam["cam_pos"]).astype(np.float64)

        def unproject(z):
            clip = np.stack([ndc_x, ndc_y, np.full_like(ndc_x, z), ones], -1)
            hpt = clip.reshape(-1, 4) @ vp_inv.T
            return (hpt[:, :3] / hpt[:, 3:4]).reshape(h, w, 3)

        q0, q1 = unproject(0.25), unproject(0.75)
        d = q1 - q0
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        # orient along the viewing direction (z conventions differ)
        flip = np.sum(d * (q0 - cpos), axis=-1, keepdims=True) < 0
        d = np.where(flip, -d, d)
        a = to_numpy(alpha).astype(np.float32)
        # alpha-weighted 3x3 depth smoothing: the expected-depth raster
        # carries per-pixel speckle at splat-coverage scale (thin-alpha
        # pixels see through to farther splats) that would dominate the
        # central-difference normals; low-alpha pixels get low weight
        wgt = np.where(a > alpha_min, a, 0.0).astype(np.float64)
        depth = to_numpy(depth).astype(np.float64)
        dw = depth * wgt
        box = lambda x: sum(
            np.roll(np.roll(x, i, 0), j, 1)
            for i in (-1, 0, 1) for j in (-1, 0, 1)
        )
        dep = np.where(
            box(wgt) > 1e-9, box(dw) / np.maximum(box(wgt), 1e-9), 0.0
        )[:, :, None]
        pts = cpos + d * dep  # (h, w, 3) world points

        # interior hits only: edge/adjacent-to-background pixels carry
        # depth-discontinuity normals and mixed colors
        m = a > alpha_min
        m &= np.roll(m, 1, 0) & np.roll(m, -1, 0)
        m &= np.roll(m, 1, 1) & np.roll(m, -1, 1)
        # ...and depth-coherent only: where the 3x3 window's depth spread
        # is large the pixel straddles a silhouette or sees through a
        # thin-coverage gap to a farther surface — its expected depth lies
        # BETWEEN surfaces and its plane-fit normal is meaningless (measured
        # on the demo dataset: dropping these moves the on-surface fraction
        # from 0.73 to ~0.95 and mean normal-vs-SDF-gradient cosine from
        # 0.61 to ~0.8)
        dmean = box(dw) / np.maximum(box(wgt), 1e-9)
        dvar = box(depth ** 2 * wgt) / np.maximum(
            box(wgt), 1e-9
        ) - dmean * dmean
        dep_tol = 3.0 * float(np.median(dep[m])) * pix_angle
        m &= np.sqrt(np.maximum(dvar, 0.0)) < dep_tol

        # normals: weighted PCA plane fit over a 5x5 window (smallest
        # eigenvector of the local position covariance), camera-facing.
        # Central differences at 1 px baseline are dominated by the
        # expected-depth raster's splat-coverage speckle; the plane fit
        # averages ~25 samples of it.
        box5 = lambda x: sum(
            np.roll(np.roll(x, i, 0), j, 1)
            for i in (-2, -1, 0, 1, 2) for j in (-2, -1, 0, 1, 2)
        )
        pw = pts * wgt[:, :, None]
        sw = np.maximum(box5(wgt), 1e-9)
        mu = np.stack([box5(pw[:, :, k]) for k in range(3)], -1) / sw[
            :, :, None
        ]
        mi, mj = np.nonzero(m)
        cov = np.zeros((mi.size, 3, 3))
        for r in range(3):
            for c in range(r, 3):
                s2 = box5(pw[:, :, r] * pts[:, :, c]) / sw
                cc = (s2 - mu[:, :, r] * mu[:, :, c])[mi, mj]
                cov[:, r, c] = cc
                cov[:, c, r] = cc
        nrm_m = np.linalg.eigh(cov)[1][:, :, 0]  # smallest-eigval vector
        to_cam = (cpos - pts)[mi, mj]
        nflip = np.sum(nrm_m * to_cam, axis=-1, keepdims=True) < 0
        nrm_m = np.where(nflip, -nrm_m, nrm_m)
        nrm = np.zeros_like(pts)
        nrm[mi, mj] = nrm_m
        im = to_numpy(img).astype(np.float32)
        planes["px"].append(pts[:, :, 0][m])
        planes["py"].append(pts[:, :, 1][m])
        planes["pz"].append(pts[:, :, 2][m])
        planes["nx"].append(nrm[:, :, 0][m])
        planes["ny"].append(nrm[:, :, 1][m])
        planes["nz"].append(nrm[:, :, 2][m])
        planes["cr"].append(im[:, :, 0][m])
        planes["cg"].append(im[:, :, 1][m])
        planes["cb"].append(im[:, :, 2][m])
        planes["radius"].append(
            (dep[:, :, 0][m] * pix_angle * radius_scale)
        )
    out = {k: np.concatenate(v).astype(np.float32)
           for k, v in planes.items()}
    n = out["px"].shape[0]
    if n == 0:
        raise ValueError("backproject_gbuffer: no pixels above alpha_min")
    if n_max is not None and n > n_max:
        sel = np.random.default_rng(seed).choice(n, n_max, replace=False)
        sel.sort()
        out = {k: v[sel] for k, v in out.items()}
        n = n_max
    out["opacity"] = np.full((n,), opacity, np.float32)
    return {k: _t(v, device) for k, v in out.items()}


def stack_views(dataset: Dict):
    """(cameras, targets) in the stacked (V, ...) layout of render_views:
    cameras a dict of tensors with a leading view axis, targets
    (V, H, W, 3)."""
    cams: List[Dict] = dataset["cameras"]
    cameras = {
        k: torch.stack([c[k] for c in cams]) for k in cams[0]
    }
    targets = torch.stack(dataset["images"])
    return cameras, targets
