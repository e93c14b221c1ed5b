"""Orbit camera and projection math (host-side numpy).

Counterpart of `splat_renderer_tpu/camera.py`: `look_at`, `perspective` and
the orbit `Camera`, `OrbitCameraController` and `orbit_ring` are the same
numpy code, so both packages see bit-equal matrices for equal parameters.  `camera_tensors` moves the frame uniform
(`Camera.arrays()`) onto a device for the render functions, and
`orbit_camera_arrays` builds it from pose tensors under autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

CameraArrays = Dict[str, torch.Tensor]


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed view matrix, gl-matrix `mat4.lookAt` semantics."""
    eye = np.asarray(eye, np.float32)
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fov_y_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """GL-style perspective (clip z in [-1, 1]), gl-matrix
    `mat4.perspective` semantics."""
    f = 1.0 / math.tan(fov_y_rad / 2.0)
    nf = 1.0 / (near - far)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) * nf
    m[2, 3] = 2.0 * far * near * nf
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class Camera:
    """Orbit camera: target/distance/azimuth/elevation."""

    target: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    distance: float = 3.0
    azimuth: float = 0.5
    elevation: float = 0.5
    fov_deg: float = 45.0
    aspect: float = 1.0
    near: float = 0.1
    far: float = 100.0

    # interaction clamps, also applied to fitted poses (fit.fit_camera)
    MAX_ELEVATION = math.pi / 2 - 0.01
    MIN_DISTANCE = 0.5
    MAX_DISTANCE = 20.0

    def set_aspect(self, aspect: float) -> None:
        self.aspect = float(aspect)

    def rotate(self, d_azimuth: float, d_elevation: float) -> None:
        self.azimuth += d_azimuth
        self.elevation = float(
            np.clip(self.elevation + d_elevation, -self.MAX_ELEVATION, self.MAX_ELEVATION)
        )

    def zoom(self, d_distance: float) -> None:
        self.distance = float(
            np.clip(self.distance + d_distance, self.MIN_DISTANCE, self.MAX_DISTANCE)
        )

    def pan(self, dx: float, dy: float) -> None:
        """Translate the orbit target in the camera plane."""
        forward = self.target - self.position()
        forward = forward / np.linalg.norm(forward)
        right = np.cross(forward, np.array([0.0, 1.0, 0.0], np.float32))
        right = right / np.linalg.norm(right)
        up = np.cross(right, forward)
        up = up / np.linalg.norm(up)
        self.target = (self.target + right * dx + up * dy).astype(np.float32)

    def position(self) -> np.ndarray:
        """Eye position from the spherical orbit parameters."""
        ce = math.cos(self.elevation)
        x = self.distance * ce * math.sin(self.azimuth)
        y = self.distance * math.sin(self.elevation)
        z = self.distance * ce * math.cos(self.azimuth)
        return (self.target + np.array([x, y, z], np.float32)).astype(np.float32)

    def view_matrix(self) -> np.ndarray:
        return look_at(self.position(), self.target, np.array([0, 1, 0], np.float32))

    def projection_matrix(self) -> np.ndarray:
        return perspective(
            math.radians(self.fov_deg), self.aspect, self.near, self.far
        )

    def view_projection_matrix(self) -> np.ndarray:
        return (self.projection_matrix() @ self.view_matrix()).astype(np.float32)

    def arrays(self, time: float = 0.0) -> Dict[str, np.ndarray]:
        """Frame uniform: {view_proj (4,4), cam_pos (3,), time ()}."""
        return {
            "view_proj": self.view_projection_matrix(),
            "cam_pos": self.position(),
            "time": np.float32(time),
        }


class OrbitCameraController:
    """Input-delta -> camera-parameter mapping.  Event-source-agnostic: feed
    it mouse deltas from any front end (the viewer page uses the same
    speeds)."""

    ROTATE_SPEED = 0.005
    PAN_SPEED = 0.002
    ZOOM_SPEED = 0.001

    def __init__(self, camera: Camera):
        self.camera = camera

    def drag_rotate(self, dx_px: float, dy_px: float) -> None:
        self.camera.rotate(-dx_px * self.ROTATE_SPEED, dy_px * self.ROTATE_SPEED)

    def drag_pan(self, dx_px: float, dy_px: float) -> None:
        self.camera.pan(-dx_px * self.PAN_SPEED, dy_px * self.PAN_SPEED)

    def wheel_zoom(self, delta: float) -> None:
        self.camera.zoom(delta * self.ZOOM_SPEED * self.camera.distance)


def orbit_ring(
    n_views: int, distance: float = 3.0, elevation: float = 0.5, aspect: float = 1.0
) -> Dict[str, np.ndarray]:
    """Camera arrays for n views on an orbit ring, stacked on a leading view
    axis (numpy; `camera_tensors` moves them to a device): the multi-view
    datagen front end, ready for `render.multiview.render_views`."""
    cams = [
        Camera(azimuth=2 * math.pi * i / n_views, elevation=elevation,
               distance=distance, aspect=aspect).arrays(0.0)
        for i in range(n_views)
    ]
    return {k: np.stack([c[k] for c in cams]) for k in ("view_proj", "cam_pos", "time")}


def camera_tensors(arrays: Dict[str, np.ndarray], device) -> CameraArrays:
    """`Camera.arrays()` as float32 tensors on `device`."""
    return {
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in arrays.items()
    }


def orbit_camera_arrays(
    pose: Dict[str, torch.Tensor],
    fov_deg: float = 45.0,
    aspect: float = 1.0,
    near: float = 0.1,
    far: float = 100.0,
    time: float = 0.0,
) -> CameraArrays:
    """`Camera.arrays()` from pose tensors, differentiable: pose is
    {"azimuth": (), "elevation": (), "distance": (), "target": (3,)}
    float32 tensors on one device, so autograd reaches the pose from an
    image loss (fit.fit_camera).  fov/aspect/near/far stay constants."""
    az, el, d = pose["azimuth"], pose["elevation"], pose["distance"]
    target = pose["target"]
    ce = torch.cos(el)
    eye = target + d * torch.stack([ce * torch.sin(az), torch.sin(el), ce * torch.cos(az)])
    f = target - eye
    f = f / torch.linalg.vector_norm(f)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=eye.device)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = torch.linalg.cross(s, f)
    view = torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=eye.device),
    ])
    proj = torch.as_tensor(perspective(math.radians(fov_deg), aspect, near, far),
                           device=eye.device)
    return {
        "view_proj": proj @ view,
        "cam_pos": eye,
        "time": torch.tensor(time, dtype=torch.float32, device=eye.device),
    }
