"""Camera model and primary ray generation (tracerboy_tpu/trace/camera.py).

The reference's thin-lens pinhole model: a lens rectangle of height
`lens_height` centred at `position` and spanned by right/up, with the ray
origin at a focal point `focal_distance` behind the lens along the view
direction (TracerBoy/kernel.glsl:1788-1803, parameters from
TracerBoy.cpp:1243-1272).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tracerboy_tpu_torch.core import vec3 as v3


@dataclass
class Camera:
    """Host-side camera description (numpy)."""

    position: np.ndarray     # (3,)
    look_at: np.ndarray      # (3,)
    up: np.ndarray           # (3,) unit
    right: np.ndarray        # (3,) unit
    lens_height: float
    focal_distance: float

    @staticmethod
    def from_pbrt(camera_ir, width: int, height: int) -> "Camera":
        """Build from a parsed pbrt camera (camera_to_world + fov): the
        lens height comes from the frame's up-vector length, the focal
        distance from the vertical FOV, and the eye point is pushed back
        so rays through the lens rectangle reproduce the pbrt frustum."""
        c2w = camera_ir.camera_to_world
        right = c2w[:3, 0].copy()
        up = c2w[:3, 1].copy()
        view = c2w[:3, 2].copy()
        pos = c2w[:3, 3].copy()
        lens_height = 2.0 * float(np.linalg.norm(up))
        up = up / np.linalg.norm(up)
        right = right / np.linalg.norm(right)
        view = view / np.linalg.norm(view)
        fov_rad = np.deg2rad(camera_ir.fov)
        focal_distance = (lens_height / 2.0) / np.tan(fov_rad / 2.0)
        position = pos + (focal_distance + 0.01) * view
        look_at = position + view
        return Camera(
            position=position.astype(np.float32),
            look_at=look_at.astype(np.float32),
            up=up.astype(np.float32),
            right=right.astype(np.float32),
            lens_height=float(lens_height),
            focal_distance=float(focal_distance),
        )

    def as_numpy(self) -> dict:
        """The leaves of the JAX package's Camera.as_pytree(), as numpy."""
        return dict(
            position=np.asarray(self.position, np.float32),
            look_at=np.asarray(self.look_at, np.float32),
            up=np.asarray(self.up, np.float32),
            right=np.asarray(self.right, np.float32),
            lens_height=np.float32(self.lens_height),
            focal_distance=np.float32(self.focal_distance),
        )


def generate_primary_rays_soa(
    cam: dict,
    width: int,
    height: int,
    pixel_ids: torch.Tensor,
    jit_u,
    jit_v,
    dof_focus_distance=0.0,
    dof_aperture_width=0.0,
    dof_u=None,
    dof_v=None,
    filter_width: float = 1.0,
):
    """SoA primary rays for flat pixel ids (y * width + x, row 0 = top).

    cam: the camera dict of the scene tensors (0-dim / (3,) tensors).
    Returns (origin V3, direction V3). With dof_u/dof_v and a positive
    focus distance (a python float), the origin is jittered on the
    aperture disc and the ray aimed through the focus point
    (kernel.glsl:1890-1903).
    """
    px = (pixel_ids % width).to(torch.float32)
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    u = (px + 0.5 + (jit_u - 0.5) * filter_width) / width
    v = (py + 0.5 + (jit_v - 0.5) * filter_width) / height
    v = 1.0 - v

    aspect = width / height
    p, la, r, up = (cam["position"], cam["look_at"], cam["right"],
                    cam["up"])
    pos = v3.V3(p[0], p[1], p[2])
    look = v3.V3(la[0], la[1], la[2])
    right = v3.V3(r[0], r[1], r[2])
    upv = v3.V3(up[0], up[1], up[2])
    forward = v3.normalize(look - pos)
    lens_w = cam["lens_height"] * aspect
    su = (u * 2.0 - 1.0) * lens_w / 2.0
    sv = (v * 2.0 - 1.0) * cam["lens_height"] / 2.0
    lens_point = v3.V3(
        pos.x + right.x * su + upv.x * sv,
        pos.y + right.y * su + upv.y * sv,
        pos.z + right.z * su + upv.z * sv,
    )
    fd = cam["focal_distance"]
    origin = v3.V3(
        torch.broadcast_to(pos.x - fd * forward.x, u.shape),
        torch.broadcast_to(pos.y - fd * forward.y, u.shape),
        torch.broadcast_to(pos.z - fd * forward.z, u.shape),
    )
    direction = v3.normalize(lens_point - origin)

    if dof_u is not None and float(dof_focus_distance) > 0.0:
        focus = origin + direction * dof_focus_distance
        # The lens offset in float64, rounded once to the rays' dtype: the
        # host's vectorised float32 sin / cos were seen off by 2e-4
        # relative on some runs, float64 on every device is not.
        rr = torch.sqrt(dof_u.double()) * float(dof_aperture_width)
        theta = dof_v.double() * (2.0 * np.pi)
        cr = (torch.cos(theta) * rr).to(dof_u.dtype)
        sr = (torch.sin(theta) * rr).to(dof_u.dtype)
        new_o = v3.V3(
            origin.x + right.x * cr + upv.x * sr,
            origin.y + right.y * cr + upv.y * sr,
            origin.z + right.z * cr + upv.z * sr,
        )
        origin, direction = new_o, v3.normalize(focus - new_o)
    return origin, direction
