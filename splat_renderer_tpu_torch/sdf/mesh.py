"""SDF -> triangle-mesh extraction (surface nets) and OBJ export.

Counterpart of `splat_renderer_tpu/sdf/mesh.py`:

- **device** (the device of `params`): the (R+1)^3 distance grid, one
  z-slab of (R+1)^2 points at a time through `SDFScene.sdf`; the vertices'
  Newton refinement through `points.project_to_surface`, the projector that
  settles seed points; one SDF-gradient batch for the per-vertex normals.
- **host**: topology only, in numpy, copied from the JAX package: boolean
  shifts over the sign grid pick the active cells and crossing edges, and
  integer bookkeeping assembles the index buffers.

Surface nets make one vertex per sign-change cell, at the centroid of the
cell's edge crossings, then Newton-project it onto the exact zero set.  The
output is a closed 2-manifold whenever the surface stays inside the sampled
bounds (every interior crossing edge emits one quad, and every quad edge is
shared by two quads).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..points.projection import project_to_surface
from .scene import Params, SDFScene


def _grid_distances(
    scene: SDFScene, params: Params, lo: np.ndarray, spacing: np.ndarray, r: int,
    device: torch.device,
) -> np.ndarray:
    """(r+1)^3 signed distances, [x, y, z]-indexed, evaluated on `device`
    one z-slab of (r+1)^2 points at a time."""
    n1 = r + 1
    ax = [lo[d] + spacing[d] * np.arange(n1, dtype=np.float32) for d in range(3)]
    xs = torch.from_numpy(np.repeat(ax[0], n1)).to(device)  # (n1*n1,) slab x coords
    ys = torch.from_numpy(np.tile(ax[1], n1)).to(device)  # (n1*n1,) slab y coords
    slabs = []
    for z in ax[2]:
        p = torch.stack([xs, ys, torch.full_like(xs, float(z))], dim=-1)
        slabs.append(scene.sdf(p, params)[0])
    d = torch.stack(slabs).cpu().numpy()  # (n1, x*y), z-major
    return np.moveaxis(d.reshape(n1, n1, n1), 0, 2)


def _edge_contrib(cross: np.ndarray, coords: Tuple[np.ndarray, ...], axis: int):
    """Per-cell sums of one axis's crossing-edge zero points.

    An edge at grid index (i, j, k) along `axis` touches the four cells
    offset by {0,-1} in the two transverse axes; summing the four shifted
    slices accumulates every edge into every cell it borders.
    """
    # cross has shape (R, R+1, R+1) up to axis permutation; cells are (R,R,R)
    t = [a for a in range(3) if a != axis]
    w = cross.astype(np.float32)
    planes = [w] + [w * c for c in coords]
    out = []
    for p in planes:
        acc = None
        for da in (0, 1):
            for db in (0, 1):
                sl = [slice(None)] * 3
                sl[t[0]] = slice(da, p.shape[t[0]] - 1 + da)
                sl[t[1]] = slice(db, p.shape[t[1]] - 1 + db)
                piece = p[tuple(sl)]
                acc = piece if acc is None else acc + piece
        out.append(acc)
    return out[0], out[1:]


def _empty() -> Dict[str, np.ndarray]:
    return {
        "vertices": np.zeros((0, 3), np.float32),
        "faces": np.zeros((0, 3), np.int32),
        "normals": np.zeros((0, 3), np.float32),
    }


def extract_mesh(
    scene: SDFScene,
    params: Params,
    resolution: int = 96,
    bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    newton_steps: int = 8,
    margin: float = 0.08,
) -> Dict[str, np.ndarray]:
    """Extract a triangle mesh of the scene's zero level set.

    The device work runs where `params` lives (`scene.params(device)`).
    resolution: cells per axis (samples = resolution + 1).
    bounds: (lo, hi) world AABB to sample; default scene.aabb grown by
      `margin` of its diagonal (the surface must stay strictly inside:
      boundary-crossing edges emit no faces, like any grid extractor).
    newton_steps: SDF Newton refinement iterations per vertex (8 suits
      exact fields; smooth-union and ellipsoid bound fields converge in
      about 12).

    Returns {"vertices" (V, 3) f32, "faces" (F, 3) i32 (CCW, outward),
    "normals" (V, 3) f32 (unit SDF gradients)}.  A scene without
    primitives has no surface: the mesh is empty.
    """
    if resolution < 2:
        raise ValueError("resolution must be >= 2")
    if not params:
        return _empty()
    device = next(t for v in params.values() for t in v.values()).device
    if bounds is None:
        lo_t, hi_t = scene.aabb(params, device)
        lo = lo_t.cpu().numpy().astype(np.float32)
        hi = hi_t.cpu().numpy().astype(np.float32)
        pad = margin * float(np.linalg.norm(hi - lo) + 1e-6)
        lo, hi = lo - pad, hi + pad
    else:
        lo = np.asarray(bounds[0], np.float32)
        hi = np.asarray(bounds[1], np.float32)
    r = int(resolution)
    spacing = (hi - lo) / r

    dist = _grid_distances(scene, params, lo, spacing, r, device)
    inside = dist < 0.0

    # ---- active cells: some but not all of the 8 corners inside ----
    occ = np.zeros((r, r, r), np.uint8)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                occ += inside[dx : r + dx, dy : r + dy, dz : r + dz]
    active = (occ > 0) & (occ < 8)
    n_active = int(active.sum())
    if n_active == 0:
        return _empty()

    vert_of_cell = np.full((r, r, r), -1, np.int64)
    vert_of_cell[active] = np.arange(n_active)

    # ---- surface-nets vertex estimate: centroid of edge crossings ----
    sum_w = np.zeros((r, r, r), np.float32)
    sum_p = [np.zeros((r, r, r), np.float32) for _ in range(3)]
    crossings = []
    for axis in range(3):
        lo_sl = [slice(None)] * 3
        hi_sl = [slice(None)] * 3
        lo_sl[axis] = slice(0, r)
        hi_sl[axis] = slice(1, r + 1)
        d0 = dist[tuple(lo_sl)]
        d1 = dist[tuple(hi_sl)]
        cross = inside[tuple(lo_sl)] != inside[tuple(hi_sl)]
        crossings.append(cross)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(cross, d0 / np.where(cross, d0 - d1, 1.0), 0.0)
        # grid-unit coordinates of each edge's zero point
        shape = d0.shape
        grids = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                            indexing="ij")
        coords = [g.copy() for g in grids]
        coords[axis] = coords[axis] + t
        w, sums = _edge_contrib(cross, tuple(coords), axis)
        sum_w += w
        for c in range(3):
            sum_p[c] += sums[c]

    w_act = np.maximum(sum_w[active], 1e-9)
    verts_grid = np.stack([sum_p[c][active] / w_act for c in range(3)], axis=1)
    verts = lo[None, :] + verts_grid * spacing[None, :]

    # ---- device Newton refinement onto the exact zero set ----
    if newton_steps > 0:
        pts = torch.from_numpy(verts.astype(np.float32)).to(device)
        settled = project_to_surface(scene, params, pts, newton_steps).cpu().numpy()
        # keep each vertex near its own cell: Newton may slide along the
        # surface but must not jump sheets (topology came from the grid)
        cell_lo = lo[None, :] + np.argwhere(active).astype(np.float32) * spacing
        lim = spacing[None, :]
        verts = np.clip(settled, cell_lo - lim, cell_lo + 2.0 * lim)

    # ---- faces: one quad per interior crossing edge ----
    tris = []
    for axis in range(3):
        t0, t1 = [a for a in range(3) if a != axis]
        cross = crossings[axis]
        # interior in both transverse axes (all 4 neighbor cells exist)
        sl = [slice(None)] * 3
        sl[t0] = slice(1, r)
        sl[t1] = slice(1, r)
        sl[axis] = slice(0, r)
        e = np.argwhere(cross[tuple(sl)])
        if e.size == 0:
            continue
        # undo the slice offsets: argwhere is over the sliced view
        off = np.zeros(3, np.int64)
        off[t0] = 1
        off[t1] = 1
        e = e + off[None, :]
        base = [e[:, 0], e[:, 1], e[:, 2]]

        def cell(da: int, db: int):
            c = [b.copy() for b in base]
            c[t0] = c[t0] - da
            c[t1] = c[t1] - db
            return vert_of_cell[c[0], c[1], c[2]]

        # the (v00 -> v10 -> v11 -> v01) loop is CCW in the (t0, t1) plane,
        # i.e. its normal points along t0 x t1: +axis for x and z (cyclic
        # pairs), -axis for y ((x, z) is anti-cyclic).  Outward = +axis
        # exactly when the edge's LOW sample is inside.
        v00, v10, v11, v01 = cell(1, 1), cell(0, 1), cell(0, 0), cell(1, 0)
        lo_in = inside[e[:, 0], e[:, 1], e[:, 2]]
        keep = lo_in if axis != 1 else ~lo_in
        q = np.stack([v00, v10, v11, v01], axis=1)
        quads = np.where(keep[:, None], q, q[:, ::-1])
        tris.append(quads[:, [0, 1, 2]])
        tris.append(quads[:, [0, 2, 3]])

    if not tris:
        return _empty()
    faces = np.concatenate(tris).astype(np.int32)
    if faces.min() < 0:
        raise ValueError("the surface reaches the sampled bounds: grow bounds or margin")

    # ---- normals: unit SDF gradients at the final vertices (device) ----
    pts = torch.from_numpy(verts.astype(np.float32)).to(device)
    g = scene.sdf(pts, params)[1].cpu().numpy()
    nrm = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-9)

    return {
        "vertices": verts.astype(np.float32),
        "faces": faces,
        "normals": nrm.astype(np.float32),
    }


def save_obj(path: str, mesh: Dict[str, np.ndarray]) -> None:
    """Write a Wavefront OBJ (positions, normals, triangles; 1-indexed),
    byte for byte as the JAX package's `save_obj` writes the same arrays."""
    v = np.asarray(mesh["vertices"], np.float32)
    f = np.asarray(mesh["faces"], np.int32) + 1
    n = np.asarray(mesh.get("normals", np.zeros((0, 3))), np.float32)
    with open(path, "w") as fh:
        fh.write("# splat_renderer_tpu surface-nets export\n")
        for p in v:
            fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for p in n:
            fh.write(f"vn {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if len(n) == len(v) and len(v):
            for t in f:
                fh.write(
                    f"f {t[0]}//{t[0]} {t[1]}//{t[1]} {t[2]}//{t[2]}\n"
                )
        else:
            for t in f:
                fh.write(f"f {t[0]} {t[1]} {t[2]}\n")
