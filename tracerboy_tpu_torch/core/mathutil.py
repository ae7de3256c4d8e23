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
