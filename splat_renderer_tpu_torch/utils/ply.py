"""3DGS ``.ply`` interchange: load/save splat sets in the standard
Gaussian-splatting point format (Kerbl et al. 2023 reference implementation's
binary_little_endian layout: x/y/z, nx/ny/nz, f_dc_0..2 SH colors,
opacity logit, scale_0..2 log-scales, rot_0..3 quaternion).

Counterpart of `splat_renderer_tpu/utils/ply.py`, the same numpy host code
(the files the two packages write for equal arrays are byte-identical): the
bridge that lets pre-trained Gaussian-splat scenes flow into the engine, and
fitted scenes flow back out to every standard 3DGS viewer.

Mapping to the splat planes (points/properties.py):

- ``load_ply``: a 3DGS Gaussian is a full 3D covariance R diag(s)^2 R^T.  By
  default it becomes an oriented disc: the disc normal is the axis of
  SMALLEST scale (the flattest direction); the disc radius is the geometric
  mean of the two in-plane scales.  That loses the in-plane anisotropy and
  the thickness.  ``covariance=True`` keeps the Gaussian itself: the seven
  planes ``sx sy sz`` (exp of the file's log-scales) and ``qw qx qy qz``
  (the file's rotation as stored) beside the eleven, with radius 2 max(s),
  for ``RenderConfig(oriented=True, ellipse="cov3d")``.  Either way:
  color = 0.5 + C0 * f_dc (the SH DC term; higher bands are view-dependent
  and come with ``with_sh``), opacity = sigmoid(logit).
- ``save_ply``: the inverse — a set with the seven planes writes them back
  (log-scales, the rotation as held); a disc set writes scales (r, r,
  r*PLY_THIN) and a quaternion rotating +z onto the normal; f_dc =
  (color - 0.5) / C0, logit(opacity).

Host-side numpy only; `load_ply` puts the (N,) planes on the device the
caller names at the very end.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._torch_util import to_numpy
from ..points.properties import COV3D_PLANES, Splats

SH_C0 = 0.28209479177387814  # Y_0^0, the 3DGS color basis constant
PLY_THIN = 0.1  # exported disc thickness as a fraction of its radius

_EXPORT_PROPS = (
    "x", "y", "z", "nx", "ny", "nz",
    "f_dc_0", "f_dc_1", "f_dc_2", "opacity",
    "scale_0", "scale_1", "scale_2",
    "rot_0", "rot_1", "rot_2", "rot_3",
)

_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def _read_header(f) -> tuple:
    """Parse the ASCII header.

    Returns (n_vertex, vertex structured dtype, bytes to skip before the
    vertex data) — elements declared BEFORE vertex are skipped by their
    fixed record size (files where such an element has a variable-length
    list property cannot be skipped and are rejected rather than misread).
    """
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    elements, fmt = [], None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append({"name": tok[1], "count": int(tok[2]),
                             "props": []})
        elif tok[0] == "property" and elements:
            # list props have no fixed size; record them as None
            elements[-1]["props"].append(
                None if tok[1] == "list"
                else (tok[-1], _PLY_TYPES[tok[1]])
            )
        elif tok[0] == "end_header":
            break
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt!r} "
                         "(3DGS uses binary_little_endian)")
    skip = 0
    for el in elements:
        if el["name"] == "vertex":
            if any(p is None for p in el["props"]):
                raise ValueError(
                    "list properties unsupported in vertex data"
                )
            return el["count"], np.dtype(el["props"]), skip
        if any(p is None for p in el["props"]):
            raise ValueError(
                f"element {el['name']!r} before vertex has list-typed "
                "properties; its size is data-dependent and cannot be "
                "skipped"
            )
        skip += el["count"] * np.dtype(el["props"]).itemsize
    raise ValueError("PLY file has no vertex element")


def load_ply(path: str, with_sh: bool = False, covariance: bool = False, *, device):
    """Load a 3DGS ``.ply`` into the splat plane dict, as float32 tensors
    on `device`.  ``covariance=True`` adds the Gaussians' own scales and
    rotations (`COV3D_PLANES`) and sets radius to 2 max(s); the default
    maps each Gaussian to a disc (see the module's docstring).

    Unknown extra properties are skipped; files missing the gaussian fields
    fall back sensibly (no scales -> unit radius, no rotation -> +z normals,
    no f_dc -> mid-gray).

    ``with_sh=True`` returns ``(splats, sh)`` where ``sh`` is the
    higher-band coefficient pytree ``{"r"|"g"|"b": (n_rest, N)}`` consumed
    by ``render.sh.apply_sh`` (3DGS stores f_rest channel-major: all red
    coefficients, then green, then blue), or ``None`` when the file carries
    no ``f_rest_*`` bands.  In this mode the base ``cr/cg/cb`` planes are
    the UNCLIPPED DC response ``0.5 + C0*f_dc`` so that
    ``apply_sh`` (which clips after summing all bands) is lossless; plain
    ``load_ply(path)`` keeps the clipped view-independent color.
    """
    with open(path, "rb") as f:
        n, dtype, skip = _read_header(f)
        f.seek(skip, 1)
        rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
    names = set(rec.dtype.names)

    def _t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    def col(name, default):
        if name in names:
            return rec[name].astype(np.float32)
        return np.full((n,), default, np.float32)

    # scales: log-space in 3DGS; normal = smallest-scale axis of R
    if {"scale_0", "scale_1", "scale_2"} <= names:
        s = np.exp(np.stack([rec["scale_0"], rec["scale_1"],
                             rec["scale_2"]], 1).astype(np.float32))
    else:
        s = np.ones((n, 3), np.float32)
    if {"rot_0", "rot_1", "rot_2", "rot_3"} <= names:
        q = np.stack([rec["rot_0"], rec["rot_1"], rec["rot_2"],
                      rec["rot_3"]], 1).astype(np.float32)
        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        # columns of R(q): R[:, j] is the world direction of local axis j
        R = np.stack([
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                      2 * (x * z - w * y)], 1),
            np.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z + w * x)], 1),
            np.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                      1 - 2 * (x * x + y * y)], 1),
        ], axis=2)  # (n, 3, 3): R[i, :, j] = column j
    else:
        R = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    j_min = np.argmin(s, axis=1)  # flattest axis = disc normal
    normal = np.take_along_axis(R, j_min[:, None, None], axis=2)[:, :, 0]
    in_plane = np.sort(s, axis=1)[:, 1:]  # the two larger scales
    radius = np.sqrt(in_plane[:, 0] * in_plane[:, 1])

    color = 0.5 + SH_C0 * np.stack(
        [col("f_dc_0", 0.0), col("f_dc_1", 0.0), col("f_dc_2", 0.0)], 1
    )
    if not with_sh:
        color = np.clip(color, 0.0, 1.0)
    op_logit = col("opacity", 0.0)
    opacity = 1.0 / (1.0 + np.exp(-op_logit)) if "opacity" in names else (
        np.full((n,), 0.8, np.float32))
    splats = {
        "px": _t(col("x", 0.0)), "py": _t(col("y", 0.0)),
        "pz": _t(col("z", 0.0)),
        "radius": _t(radius.astype(np.float32)),
        "cr": _t(color[:, 0]), "cg": _t(color[:, 1]),
        "cb": _t(color[:, 2]),
        "opacity": _t(opacity.astype(np.float32)),
        "nx": _t(normal[:, 0]), "ny": _t(normal[:, 1]),
        "nz": _t(normal[:, 2]),
    }
    if covariance:
        splats["radius"] = _t(2.0 * s.max(axis=1))
        rot = (np.stack([rec[f"rot_{k}"] for k in range(4)], 1).astype(np.float32)
               if {"rot_0", "rot_1", "rot_2", "rot_3"} <= names
               else np.tile(np.float32([1.0, 0.0, 0.0, 0.0]), (n, 1)))
        for k, name in enumerate(COV3D_PLANES):
            splats[name] = _t(s[:, k] if k < 3 else rot[:, k - 3])
    if not with_sh:
        return splats
    # f_rest_* higher SH bands, channel-major (m red rows, m green, m blue);
    # truncate to the largest COMPLETE degree actually present
    rest_names = sorted(
        (nm for nm in names if nm.startswith("f_rest_")),
        key=lambda nm: int(nm[7:]),
    )
    m = len(rest_names) // 3
    for deg_m in (15, 8, 3, 0):
        if m >= deg_m:
            m = deg_m
            break
    if m == 0:
        return splats, None
    rest = np.stack(
        [rec[nm].astype(np.float32) for nm in rest_names], 0
    )  # (3m_file, n) row planes — contiguous (N,) rows, never (N, K)
    m_file = len(rest_names) // 3
    sh = {
        "r": _t(rest[0:m]),
        "g": _t(rest[m_file:m_file + m]),
        "b": _t(rest[2 * m_file:2 * m_file + m]),
    }
    return splats, sh


def save_ply(path: str, splats: Splats, sh=None) -> None:
    """Write the splat set as a standard 3DGS ``.ply`` (binary LE).

    A set with `COV3D_PLANES` (``load_ply(covariance=True)``,
    `points.gaussian_splats`) writes its scales (as log-scales) and its
    rotation back.  Discs become thin gaussians: in-plane scales = radius,
    normal-axis scale = radius * PLY_THIN, rotation = the quaternion taking
    +z to the normal.  Any 3DGS viewer renders the result directly.

    ``sh`` (the ``{"r"|"g"|"b": (n_rest, N)}`` pytree from
    ``load_ply(with_sh=True)`` / ``render.sh``) adds the standard
    channel-major ``f_rest_*`` view-dependent bands in the usual position
    (after f_dc_2).  Base colors are written as-is — pass the unclipped DC
    response for a lossless roundtrip.

    Dead capacity slots (radius <= 0 — the engine's liveness encoding,
    fit.density_control) are DROPPED: foreign viewers have no liveness
    convention, and a roundtrip must not resurrect pruned splats.
    """
    live = to_numpy(splats["radius"]) > 0.0
    cols: Dict[str, np.ndarray] = {}
    gaussians = all(k in splats for k in COV3D_PLANES)
    for k in ("px", "py", "pz", "nx", "ny", "nz", "radius", "opacity",
              "cr", "cg", "cb") + (COV3D_PLANES if gaussians else ()):
        cols[k] = to_numpy(splats[k]).astype(np.float32)[live]
    export_props = list(_EXPORT_PROPS)
    if sh is not None:
        m = int(sh["r"].shape[0])
        at = export_props.index("opacity")
        export_props[at:at] = [f"f_rest_{i}" for i in range(3 * m)]
        for c, ch in enumerate(("r", "g", "b")):
            coeff = to_numpy(sh[ch]).astype(np.float32)
            for k in range(m):
                cols[f"f_rest_{c * m + k}"] = coeff[k][live]
    n = int(cols["px"].shape[0])
    cols["x"], cols["y"], cols["z"] = cols["px"], cols["py"], cols["pz"]
    for i, c in enumerate(("cr", "cg", "cb")):
        cols[f"f_dc_{i}"] = (cols[c] - 0.5) / SH_C0
    op = np.clip(cols["opacity"], 1e-6, 1.0 - 1e-6)
    cols["opacity"] = np.log(op / (1.0 - op))
    r = np.maximum(cols["radius"], 1e-12)
    cols["scale_0"] = cols["scale_1"] = np.log(r)
    cols["scale_2"] = np.log(r * PLY_THIN)
    # quaternion taking +z to n: axis = z x n, w = 1 + z.n (half-angle form)
    nx, ny, nz = cols["nx"], cols["ny"], cols["nz"]
    w = 1.0 + nz
    qx, qy, qz = -ny, nx, np.zeros_like(nx)
    # n ~ -z: the half-angle form degenerates; use a 180-degree flip about x
    flip = w < 1e-6
    w = np.where(flip, 0.0, w)
    qx = np.where(flip, 1.0, qx)
    qy = np.where(flip, 0.0, qy)
    norm = np.sqrt(w * w + qx * qx + qy * qy + qz * qz)
    for name, v in (("rot_0", w), ("rot_1", qx), ("rot_2", qy),
                    ("rot_3", qz)):
        cols[name] = (v / np.maximum(norm, 1e-12)).astype(np.float32)
    if gaussians:
        for k, name in enumerate(COV3D_PLANES):
            cols[f"scale_{k}" if k < 3 else f"rot_{k - 3}"] = (
                np.log(cols[name]) if k < 3 else cols[name])

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {p}" for p in export_props]
    header.append("end_header")
    rec = np.empty((n,), np.dtype([(p, "<f4") for p in export_props]))
    for p in export_props:
        rec[p] = cols[p]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


__all__ = ["load_ply", "save_ply", "SH_C0", "PLY_THIN"]
