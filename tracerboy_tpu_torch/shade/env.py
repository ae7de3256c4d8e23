"""Environment map lookups (tracerboy_tpu/shade/env.py; the reference's
lat-long lookup, RayGenCommon.h:21-44): the direction is rotated by the
environment transform and mapped with u = atan2(y, x) / 2pi (wrapped
positive), v = acos(z) / pi, then scaled by the environment colour. Three forms of the same lookup:
rows of directions against the (H, W, 3) map, V3 directions against
flat channel planes, and V3 directions against the quad-row table.
"""

from __future__ import annotations

import math

import torch

from tracerboy_tpu_torch.core import vec3 as v3


def _lookup_coords(d, env_h, env_w, m):
    vx = d.x * m[0, 0] + d.y * m[0, 1] + d.z * m[0, 2]
    vy = d.x * m[1, 0] + d.y * m[1, 1] + d.z * m[1, 2]
    vz = d.x * m[2, 0] + d.y * m[2, 1] + d.z * m[2, 2]
    vv = v3.normalize(v3.V3(vx, vy, vz))
    p = torch.atan2(vv.y, vv.x)
    p = torch.where(p > 0, p, p + 2.0 * math.pi)
    u = p / (2.0 * math.pi)
    w = torch.arccos(torch.clamp(vv.z, -1.0, 1.0)) / math.pi
    fx = u * env_w - 0.5
    fy = w * env_h - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    return fx, fy, x0, y0


def sample_environment(direction, env_map, env_transform, env_color_scale):
    """Row layout: (N, 3) directions -> (N, 3) radiance from the (H, W, 3)
    map, bilinear with wrap in u and clamp in v."""
    v = direction @ env_transform.T
    v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                            1e-12)
    p = torch.atan2(v[..., 1], v[..., 0])
    p = torch.where(p > 0, p, p + 2.0 * math.pi)
    u = p / (2.0 * math.pi)
    w = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0)) / math.pi
    H, W = env_map.shape[0], env_map.shape[1]
    fx = u * W - 0.5
    fy = w * H - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = torch.remainder(x0, W)
    x1w = torch.remainder(x0 + 1, W)
    y0c = torch.clamp(y0, 0, H - 1)
    y1c = torch.clamp(y0 + 1, 0, H - 1)
    col = (env_map[y0c, x0w] * (1 - tx) * (1 - ty)
           + env_map[y0c, x1w] * tx * (1 - ty)
           + env_map[y1c, x0w] * (1 - tx) * ty
           + env_map[y1c, x1w] * tx * ty)
    return col * env_color_scale


def sample_environment_soa(d, env_r, env_g, env_b, env_h: int, env_w: int,
                           env_transform, env_color_scale):
    """V3 directions -> V3 radiance from flat (H*W,) channel planes."""
    fx, fy, x0, y0 = _lookup_coords(d, env_h, env_w, env_transform)
    tx = fx - x0
    ty = fy - y0
    x0w = torch.remainder(x0, env_w)
    x1w = torch.remainder(x0 + 1, env_w)
    y0c = torch.clamp(y0, 0, env_h - 1)
    y1c = torch.clamp(y0 + 1, 0, env_h - 1)
    i00 = y0c * env_w + x0w
    i01 = y0c * env_w + x1w
    i10 = y1c * env_w + x0w
    i11 = y1c * env_w + x1w
    w00 = (1 - tx) * (1 - ty)
    w01 = tx * (1 - ty)
    w10 = (1 - tx) * ty
    w11 = tx * ty

    def chan(c):
        return c[i00] * w00 + c[i01] * w01 + c[i10] * w10 + c[i11] * w11

    s = env_color_scale
    return v3.V3(chan(env_r) * s[0], chan(env_g) * s[1], chan(env_b) * s[2])


def sample_environment_quad_soa(d, env_quad, env_h: int, env_w: int,
                                env_transform, env_color_scale,
                                gather_mask=None):
    """The same lookup through the (H*W, 12) quad-row table (row i holds
    the 2x2 bilinear neighbourhood of texel i). gather_mask: lanes whose
    result is discarded read row 0."""
    fx, fy, x0, y0 = _lookup_coords(d, env_h, env_w, env_transform)
    tx = fx - x0
    # Clamp the vertical blend at the poles, as the plane lookup does.
    ty = torch.where(y0 < 0, 0.0, fy - y0)
    idx = torch.clamp(y0, 0, env_h - 1) * env_w + torch.remainder(x0, env_w)
    if gather_mask is not None:
        idx = torch.where(gather_mask, idx, 0)
    rows = env_quad[idx]
    w00 = (1 - tx) * (1 - ty)
    w01 = tx * (1 - ty)
    w10 = (1 - tx) * ty
    w11 = tx * ty

    def chan(c):
        return (rows[:, c] * w00 + rows[:, 3 + c] * w01
                + rows[:, 6 + c] * w10 + rows[:, 9 + c] * w11)

    s = env_color_scale
    return v3.V3(chan(0) * s[0], chan(1) * s[1], chan(2) * s[2])
