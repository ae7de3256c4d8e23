"""Vector math helpers over (..., 3) tensors (tracerboy_tpu/core/mathutil.py).

The wavefront works on SoA planes (core/vec3.py); these row-layout
helpers serve host-side and test code that holds (N, 3) arrays.
"""

from __future__ import annotations

import torch

EPSILON = 1e-4
LARGE_NUMBER = 1e10


def dot(a, b, keepdims: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v, keepdims: bool = False):
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdims=keepdims), 1e-20))


def normalize(v):
    return v * torch.rsqrt(torch.clamp_min(dot(v, v, keepdims=True), 1e-20))


def reflect(v, n):
    """HLSL-style reflect: v - 2*dot(v,n)*n (v points toward the surface)."""
    return v - 2.0 * dot(v, n, keepdims=True) * n


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def luminance(rgb):
    """Rec.709 luma (ColorToLuma in the reference's Tonemap.h)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def refract_dir(d, n, nr):
    """Refraction of incoming direction d about normal n with relative IOR
    nr; returns (direction, total-internal-reflection mask). Where the
    discriminant is <= EPSILON the ray reflects (kernel.glsl:1530-1563)."""
    d_dot_n = dot(d, n, keepdims=True)
    nr = torch.as_tensor(nr, dtype=d.dtype, device=d.device)
    if nr.ndim < d.ndim:
        nr = nr[..., None]
    disc = 1.0 - nr * nr * (1.0 - d_dot_n * d_dot_n)
    tir = disc[..., 0] <= EPSILON
    refr = normalize(nr * (d - n * d_dot_n)
                     - n * torch.sqrt(torch.clamp_min(disc, 0.0)))
    return torch.where(tir[..., None], reflect(d, n), refr), tir


def channel_average(rgb):
    return torch.mean(rgb, dim=-1)


def orthonormal_basis(normal):
    """(tangent, bitangent) around `normal`, the frame that maps local
    (x, y=up, z) to x*tangent + y*normal + z*bitangent (the reference's
    ReorientVectorAroundNormal branches, kernel.glsl:1000-1014)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    use_x = torch.abs(nx) > torch.abs(ny)
    inv_xz = torch.rsqrt(torch.clamp_min(nx * nx + nz * nz, 1e-20))
    inv_yz = torch.rsqrt(torch.clamp_min(ny * ny + nz * nz, 1e-20))
    zero = torch.zeros_like(nx)
    tangent = torch.stack([torch.where(use_x, -nz * inv_xz, zero),
                           torch.where(use_x, zero, nz * inv_yz),
                           torch.where(use_x, nx * inv_xz, -ny * inv_yz)], -1)
    return tangent, cross(normal, tangent)


def reorient_around_normal(v, normal):
    """A local-space direction (y = up) in the frame around `normal`."""
    tangent, bitangent = orthonormal_basis(normal)
    return normalize(v[..., 0:1] * tangent + v[..., 1:2] * normal
                     + v[..., 2:3] * bitangent)


def spherical_to_dir(phi, theta):
    """Local direction from polar angle phi (from +y) and azimuth theta."""
    sp = torch.sin(phi)
    return torch.stack([sp * torch.cos(theta), torch.cos(phi),
                        sp * torch.sin(theta)], -1)


def transform_points(m, p):
    """A 3x4 (linear | translation) affine transform of points (..., 3)."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_dirs(m, d):
    return d @ m[:3, :3].T


def make_affine(linear, translation):
    """A float32 3x4 affine matrix from a 3x3 linear part and a
    translation (on the CPU unless they are tensors elsewhere)."""
    linear = torch.as_tensor(linear, dtype=torch.float32)
    translation = torch.as_tensor(translation, dtype=torch.float32,
                                  device=linear.device)
    return torch.cat([linear, translation.reshape(3, 1)], 1)
